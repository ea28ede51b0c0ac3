"""HTTP TTS serving daemon (stdlib-only) over the dynamic-batching server.

Counterpart of `latent_diffusion_speech_tpu/cli/serve.py`, with the same
endpoints, status codes, headers, Prometheus names and chunked streaming:

    python -m latent_diffusion_speech_tpu_torch.cli.serve -c configs/config.yaml \\
        --port 8400 [--model exp/diffusion/model_<step>.ckpt] [--lm-model exp/lm]

    POST /tts         {"text": "...", "language": "ZH", "spk_id": 1} -> audio/wav
    POST /tts/stream  same body -> chunked audio/wav, pieces streamed as
                      they are synthesized (time-to-first-audio = first piece)
    GET  /healthz     -> JSON liveness + counters
    GET  /metrics     -> Prometheus text format

Long text is handled transparently: input longer than `max_chars` (default
60) is split into sentence-sized pieces (text/segment.py), every piece is
submitted to the batching server — so the pieces coalesce into batched
device calls, together with any concurrent traffic — and the waveforms are
stitched with `pause_ms` (default 180) of silence between pieces.  `/tts`
returns the stitched file; `/tts/stream` writes each piece's PCM the moment
its future resolves (HTTP/1.1 chunked transfer, WAV header with streaming
0xFFFFFFFF sizes), so playback can start after the first sentence.

With `--auth-token TOKEN` (or env `TTS_AUTH_TOKEN`), the synthesis endpoints
require `Authorization: Bearer TOKEN`; `/healthz` and `/metrics` stay open
for probes and scrapers.

`ThreadingHTTPServer` gives each request its own thread; every request
submits to the shared `infer.TTSServer`, whose single dispatch thread owns
the card and batches whatever arrives within the batching window
(`infer/server.py`).  The handler threads touch only numpy arrays and
futures.  The pipeline runs on `cuda` unless `--device` says otherwise.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Sequence
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from latent_diffusion_speech_tpu_torch.cli._common import config_parser, load

__all__ = ["make_handler", "TTSHTTPServer", "main"]


class TTSHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a deep accept backlog: the stdlib default
    (request_queue_size=5) RSTs connections under bursts — backpressure must
    answer 429, not reset; the TTSServer's max_queue is the real limiter."""

    request_queue_size = 128
    daemon_threads = True


def _prometheus(lines) -> bytes:
    return ("\n".join(lines) + "\n").encode()


def make_handler(tts_server, timeout_s: float = 300.0, auth_token: str | None = None):
    from latent_diffusion_speech_tpu_torch.ops.audio_io import (
        pcm16_bytes,
        wav_bytes,
        wav_stream_header,
    )

    started = time.monotonic()

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (the /tts/stream endpoint) needs HTTP/1.1; every
        # non-chunked response already sends Content-Length, as 1.1 requires
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            return self.headers.get("Authorization", "") == f"Bearer {auth_token}"

        def do_GET(self):
            if self.path == "/healthz":
                self._json(
                    200,
                    {
                        "ok": True,
                        "requests_served": tts_server.requests_served,
                        "requests_failed": tts_server.requests_failed,
                        "requests_rejected": tts_server.requests_rejected,
                        "batches_served": tts_server.batches_served,
                        "queue_depth": tts_server.queue_depth(),
                        "uptime_s": round(time.monotonic() - started, 3),
                    },
                )
            elif self.path == "/metrics":
                body = _prometheus(
                    [
                        "# TYPE tts_requests_served_total counter",
                        f"tts_requests_served_total {tts_server.requests_served}",
                        "# TYPE tts_requests_failed_total counter",
                        f"tts_requests_failed_total {tts_server.requests_failed}",
                        "# TYPE tts_requests_rejected_total counter",
                        f"tts_requests_rejected_total {tts_server.requests_rejected}",
                        "# TYPE tts_batches_served_total counter",
                        f"tts_batches_served_total {tts_server.batches_served}",
                        "# TYPE tts_batch_seconds_total counter",
                        f"tts_batch_seconds_total {tts_server.batch_seconds_total:.6f}",
                        "# TYPE tts_audio_seconds_served_total counter",
                        f"tts_audio_seconds_served_total {tts_server.audio_seconds_served:.6f}",
                        "# TYPE tts_queue_depth gauge",
                        f"tts_queue_depth {tts_server.queue_depth()}",
                        "# TYPE tts_queue_wait_seconds_total counter",
                        f"tts_queue_wait_seconds_total {tts_server.queue_wait_seconds_total:.6f}",
                        "# TYPE tts_queue_wait_count counter",
                        f"tts_queue_wait_count {tts_server.queue_wait_count}",
                        "# TYPE tts_uptime_seconds gauge",
                        f"tts_uptime_seconds {time.monotonic() - started:.3f}",
                    ]
                )
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        MAX_BODY = 1 << 20  # reject larger request bodies outright

        def _drain_body(self):
            """Consume the request body so a keep-alive connection stays
            parseable after an early error response."""
            length = min(int(self.headers.get("Content-Length", "0") or 0), self.MAX_BODY)
            if length > 0:
                self.rfile.read(length)

        def _parse_tts_body(self):
            length = int(self.headers.get("Content-Length", "0"))
            if length > self.MAX_BODY:
                self.close_connection = True
                raise ValueError(f"body too large ({length} bytes)")
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            text = req["text"]
            if not isinstance(text, str):
                raise ValueError("'text' must be a string")
            return {
                "text": text,
                "language": str(req.get("language", "ZH")),
                "spk_id": int(req.get("spk_id", 1)),
                "seed": int(req.get("seed", 0)),
                "max_chars": int(req.get("max_chars", 60)),
                "pause_ms": float(req.get("pause_ms", 180.0)),
            }

        def _submit_pieces(self, p, stream: bool = False):
            from latent_diffusion_speech_tpu_torch.text.segment import split_sentences

            pieces = split_sentences(p["text"], max_chars=p["max_chars"]) or [p["text"]]
            # every piece goes through the batching server, so a long text's
            # pieces coalesce into batched device calls together with any
            # concurrent requests; admission is atomic — all pieces or 429.
            # Streaming requests mark piece 1 urgent so time-to-first-audio is
            # one solo piece, not the whole first batch (honored only when the
            # queue is shallow — see TTSServer.submit_many).
            return tts_server.submit_many(
                pieces, language=p["language"],
                spk_ids=[p["spk_id"]] * len(pieces), seed=p["seed"],
                first_urgent=stream,
            )

        def do_POST(self):
            from latent_diffusion_speech_tpu_torch.infer.server import ServerOverloaded

            if self.path not in ("/tts", "/tts/stream"):
                self._drain_body()
                self._json(404, {"error": "unknown path"})
                return
            if not self._authorized():
                self._drain_body()
                self._json(401, {"error": "missing or bad Authorization bearer token"})
                return
            try:
                p = self._parse_tts_body()
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                futs = self._submit_pieces(p, stream=self.path == "/tts/stream")
            except ServerOverloaded as e:
                # backpressure: the admission queue is full — tell the client
                # to retry after roughly one batching window + one batch time
                self.send_response(429)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/tts/stream":
                self._stream_tts(p, futs)
            else:
                self._whole_tts(p, futs)

        def _whole_tts(self, p, futs):
            try:
                results = [f.result(timeout=timeout_s) for f in futs]
                sr = results[0][1]
                if len(results) == 1:
                    wav = results[0][0]
                else:
                    gap = np.zeros(int(round(sr * p["pause_ms"] / 1000.0)), np.float32)
                    chunks = []
                    for i, (w, _) in enumerate(results):
                        if i:
                            chunks.append(gap)
                        chunks.append(np.asarray(w, np.float32))
                    wav = np.concatenate(chunks)
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                self._json(500, {"error": str(e)})
                return
            body = wav_bytes(np.asarray(wav, np.float32), sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- chunked streaming ------------------------------------------------

        def _chunk(self, data: bytes):
            if data:
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _stream_tts(self, p, futs):
            try:
                # sample rate comes with the first result, so the header
                # waits for it — time-to-first-audio is one piece either way
                first_wav, sr = futs[0].result(timeout=timeout_s)
            except Exception as e:  # noqa: BLE001 — nothing sent yet: clean 500
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            gap = pcm16_bytes(np.zeros(int(round(sr * p["pause_ms"] / 1000.0)), np.float32))
            try:
                self._chunk(wav_stream_header(sr) + pcm16_bytes(first_wav))
                self.wfile.flush()
                for f in futs[1:]:
                    wav, _ = f.result(timeout=timeout_s)
                    self._chunk(gap + pcm16_bytes(wav))
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001 — mid-stream: abort the chunk
                # stream (no terminating chunk), so the client sees a
                # truncated response rather than silently-complete audio
                self.close_connection = True

    return Handler


def main(argv: Optional[Sequence[str]] = None):
    import os

    p = config_parser("HTTP TTS serving daemon")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--model", type=str, default=None, help="diffusion checkpoint path")
    p.add_argument("--lm-model", type=str, default=None,
                   help="LM checkpoint path (an experiment dir or a model_<step>.ckpt)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=30.0)
    p.add_argument("--max-queue", type=int, default=64,
                   help="reject (HTTP 429) past this many queued pieces; 0 = unbounded")
    p.add_argument("--seed-strict", action="store_true",
                   help="dispatch unlike seeds separately (exact per-request "
                        "determinism; collapses batching under mixed load)")
    p.add_argument("--speedup", type=int, default=None)
    p.add_argument("--method", type=str, default=None)
    p.add_argument("--weight-quant", type=str, default=None, choices=["int8"],
                   help="serve-only int8 UNet weights (ops/weight_quant.py)")
    p.add_argument(
        "--auth-token",
        type=str,
        default=os.environ.get("TTS_AUTH_TOKEN"),
        help="require 'Authorization: Bearer <token>' on synthesis endpoints "
        "(default: $TTS_AUTH_TOKEN if set)",
    )
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cfg = load(args)

    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.infer import TTSServer

    if args.weight_quant:
        cfg.common.infer.weight_quant = args.weight_quant
    pipe = build_pipeline(cfg, args.model, args.lm_model, device=args.device)
    with TTSServer(
        pipe,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        method=args.method or cfg.common.infer.method,
        infer_speedup=args.speedup or cfg.common.infer.speedup,
        max_queue=args.max_queue,
        seed_strict=args.seed_strict,
    ) as server:
        httpd = TTSHTTPServer(
            (args.host, args.port), make_handler(server, auth_token=args.auth_token)
        )
        print(f"serving on http://{args.host}:{httpd.server_address[1]} "
              f"(max_batch={args.max_batch}, wait={args.max_wait_ms} ms, "
              f"auth={'on' if args.auth_token else 'off'})")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            httpd.server_close()


if __name__ == "__main__":
    main()
