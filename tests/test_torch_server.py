"""The port's dynamic-batching TTS server (`infer/server.py`) and HTTP
daemon (`cli/serve.py::make_handler`): every case of tests/test_server.py
against the port's copies, with the same fake pipelines (no models: the
server only calls `tts_batch`), except the end-to-end synthesis case
(tests/test_torch_serve_entry.py drives the port's pipeline).  No JAX
import, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_server.py

The 429 case waits until both queued requests are served before it posts
again; the JAX test re-posts at once and may find "fills-the-queue" not
yet collected (a second 429).  Timing limits are those of the JAX tests."""

import threading
import time

import numpy as np
import pytest

from latent_diffusion_speech_tpu_torch.infer import TTSServer


class FakePipeline:
    """Records tts_batch calls; returns one dummy waveform per text."""

    def __init__(self, delay_s: float = 0.0, fail: bool = False):
        self.calls = []
        self.delay_s = delay_s
        self.fail = fail
        self.lock = threading.Lock()

    def tts_batch(self, texts, language="ZH", spk_ids=None, method="x",
                  infer_speedup=1, max_length=8, seed=0):
        if self.fail:
            raise ValueError("synthesizer exploded")
        if self.delay_s:
            time.sleep(self.delay_s)
        with self.lock:
            self.calls.append(
                {"texts": list(texts), "spk_ids": list(spk_ids or []), "seed": seed,
                 "language": language}
            )
        return [(np.full(32 + len(t), 0.1, np.float32), 8000) for t in texts]


def test_server_coalesces_and_serves():
    pipe = FakePipeline(delay_s=0.02)
    with TTSServer(pipe, max_batch=4, max_wait_ms=500) as server:
        futures = [server.submit(t, spk_id=i + 1) for i, t in enumerate(["a", "bb", "ccc"])]
        results = [f.result(timeout=30) for f in futures]
    for (wav, sr), t in zip(results, ["a", "bb", "ccc"]):
        assert sr == 8000 and len(wav) == 32 + len(t)  # per-request result order
    assert server.requests_served == 3
    assert server.batches_served == 1  # all three within the window
    assert pipe.calls[0]["spk_ids"] == [1, 2, 3]


def test_server_separates_unlike_seeds_when_strict():
    """seed_strict=True: unlike seeds dispatch separately so every request's
    seed is honored exactly (single-tenant/testing determinism)."""
    pipe = FakePipeline(delay_s=0.02)
    with TTSServer(pipe, max_batch=4, max_wait_ms=300, seed_strict=True) as server:
        f1 = server.submit("a", seed=1)
        f2 = server.submit("bb", seed=2)
        for f in (f1, f2):
            f.result(timeout=30)
    assert server.batches_served == 2
    assert sorted(c["seed"] for c in pipe.calls) == [1, 2]


def test_server_coalesces_unlike_seeds_by_default():
    """Default: unlike seeds batch together (real load gives every request
    its own seed — strict separation collapses batching to B=1, measured in
    SERVE_LOAD.json history); the batch runs with the first request's seed."""
    pipe = FakePipeline(delay_s=0.02)
    with TTSServer(pipe, max_batch=4, max_wait_ms=300) as server:
        futures = [server.submit(t, seed=i + 1) for i, t in enumerate(["a", "bb", "ccc"])]
        for f in futures:
            f.result(timeout=30)
    assert server.batches_served == 1
    assert pipe.calls[0]["texts"] == ["a", "bb", "ccc"]


def test_server_window_anchored_to_first_arrival():
    """The batching window must not restart per arrival: a trickle of
    requests spaced inside max_wait_ms still dispatches the first batch
    within ~max_wait_ms of the first request."""
    pipe = FakePipeline()
    with TTSServer(pipe, max_batch=8, max_wait_ms=120) as server:
        t0 = time.monotonic()
        fut = server.submit("first")
        stop = threading.Event()

        def trickle():
            i = 0
            while not stop.is_set() and i < 20:
                server.submit(f"t{i}")
                i += 1
                time.sleep(0.08)  # < max_wait_ms: would restart a naive window

        th = threading.Thread(target=trickle, daemon=True)
        th.start()
        fut.result(timeout=30)
        latency = time.monotonic() - t0
        stop.set()
        th.join()
    assert latency < 1.0, f"first request waited {latency:.2f}s"


def test_server_single_request_not_delayed_forever():
    pipe = FakePipeline()
    with TTSServer(pipe, max_batch=8, max_wait_ms=10) as server:
        wav, sr = server.submit("solo").result(timeout=30)
        assert sr == 8000


def test_first_urgent_dispatches_piece_one_solo():
    """Streaming TTFA: submit_many(first_urgent=True) on a shallow queue runs
    piece 1 as a batch of ONE (no batching window) so the /tts/stream client
    gets first audio at solo-piece latency; the rest coalesce behind it."""
    pipe = FakePipeline(delay_s=0.02)
    with TTSServer(pipe, max_batch=4, max_wait_ms=500) as server:
        futs = server.submit_many(["p0", "p1", "p2"], first_urgent=True)
        for f in futs:
            f.result(timeout=30)
    assert pipe.calls[0]["texts"] == ["p0"]          # solo, window skipped
    assert pipe.calls[1]["texts"] == ["p1", "p2"]    # batched behind it
    assert server.batches_served == 2


def test_first_urgent_ignored_when_queue_deep():
    """Under load (queue depth >= max_batch at admission) the urgent hint is
    dropped — solo dispatches would collapse batching exactly when batching
    matters, and queue wait dominates TTFA there anyway."""
    pipe = FakePipeline(delay_s=0.1)
    with TTSServer(pipe, max_batch=2, max_wait_ms=5) as server:
        futs = [server.submit(t) for t in ["a", "b", "c", "d", "e", "f"]]
        futs += server.submit_many(["p0", "p1", "p2"], first_urgent=True)
        for f in futs:
            f.result(timeout=30)
    texts = [c["texts"] for c in pipe.calls]
    assert ["p0"] not in texts                       # never dispatched solo
    assert any("p0" in t and len(t) == 2 for t in texts)


def test_server_propagates_errors():
    pipe = FakePipeline(fail=True)
    with TTSServer(pipe, max_wait_ms=5) as server:
        fut = server.submit("x")
        with pytest.raises(ValueError, match="exploded"):
            fut.result(timeout=30)
    with pytest.raises(RuntimeError):
        server.submit("after close")


def test_server_close_drains_queue():
    pipe = FakePipeline(delay_s=0.05)
    server = TTSServer(pipe, max_batch=2, max_wait_ms=5)
    futures = [server.submit(t) for t in ["q1", "q2", "q3", "q4", "q5"]]
    server.close()  # must resolve everything already submitted
    for f in futures:
        wav, sr = f.result(timeout=1)
        assert len(wav) > 0


class BlockingPipeline:
    """Every tts_batch call blocks on `gate`; `started` fires on entry."""

    def __init__(self):
        self.gate = threading.Event()
        self.started = threading.Event()

    def tts_batch(self, texts, language="ZH", spk_ids=None, method="x",
                  infer_speedup=1, max_length=8, seed=0):
        self.started.set()
        assert self.gate.wait(timeout=30)
        return [(np.full(32 + len(t), 0.1, np.float32), 8000) for t in texts]


class TestBackpressure:
    def test_submit_rejects_past_max_queue(self):
        from latent_diffusion_speech_tpu_torch.infer.server import ServerOverloaded

        pipe = BlockingPipeline()
        server = TTSServer(pipe, max_batch=1, max_wait_ms=0, max_queue=2)
        try:
            f1 = server.submit("inflight")
            assert pipe.started.wait(timeout=30)  # dispatcher holds f1's batch
            f2 = server.submit("q1")
            f3 = server.submit("q2")
            with pytest.raises(ServerOverloaded, match="overloaded"):
                server.submit("q3")
            assert server.requests_rejected == 1
        finally:
            pipe.gate.set()
            server.close()
        # everything admitted was served despite the rejection
        for f in (f1, f2, f3):
            wav, sr = f.result(timeout=1)
            assert sr == 8000

    def test_submit_many_is_all_or_nothing(self):
        """A long text's pieces must not partially admit: a rejected caller
        never collects, so partial admission would synthesize dead audio."""
        from latent_diffusion_speech_tpu_torch.infer.server import ServerOverloaded

        pipe = BlockingPipeline()
        server = TTSServer(pipe, max_batch=1, max_wait_ms=0, max_queue=3)
        try:
            server.submit("inflight")
            assert pipe.started.wait(timeout=30)
            server.submit("q1")  # depth 1
            with pytest.raises(ServerOverloaded):
                server.submit_many(["p1", "p2", "p3"])  # 1 + 3 > 3
            assert server.queue_depth() == 1  # nothing from the group queued
            assert server.requests_rejected == 3
            # a group that fits is admitted whole
            futs = server.submit_many(["p1", "p2"])
            assert len(futs) == 2 and server.queue_depth() == 3
        finally:
            pipe.gate.set()
            server.close()

    def test_http_429_with_retry_after_and_metrics(self):
        import json
        import urllib.error
        import urllib.request
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        pipe = BlockingPipeline()
        server = TTSServer(pipe, max_batch=1, max_wait_ms=0, max_queue=1)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            queued = [server.submit("inflight")]
            assert pipe.started.wait(timeout=30)
            queued.append(server.submit("fills-the-queue"))
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/tts",
                data=json.dumps({"text": "overload"}).encode(),
                headers={"Content-Type": "application/json"},
            )
            try:
                urllib.request.urlopen(req, timeout=30)
                raise AssertionError("expected 429")
            except urllib.error.HTTPError as e:
                assert e.code == 429
                assert e.headers["Retry-After"] == "1"
                assert "overloaded" in json.loads(e.read())["error"]
            pipe.gate.set()
            # once drained (both queued requests served), the same request is
            # admitted and served
            for f in queued:
                f.result(timeout=30)
            assert server.queue_depth() == 0
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30
            ) as resp:
                text = resp.read().decode()
            metrics = {
                line.split()[0]: float(line.split()[1])
                for line in text.splitlines()
                if line and not line.startswith("#")
            }
            assert metrics["tts_requests_rejected_total"] == 1
        finally:
            pipe.gate.set()
            httpd.shutdown()
            server.close()


class TestHTTPEndpoint:
    def test_http_tts_and_healthz(self):
        import io
        import json
        import urllib.error
        import urllib.request
        import wave
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        pipe = FakePipeline()
        with TTSServer(pipe, max_batch=4, max_wait_ms=20) as server:
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
            port = httpd.server_address[1]
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/tts",
                    data=json.dumps({"text": "hello", "spk_id": 2}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 200
                    assert resp.headers["Content-Type"] == "audio/wav"
                    body = resp.read()
                with wave.open(io.BytesIO(body)) as wf:
                    assert wf.getframerate() == 8000
                    assert wf.getnframes() == 32 + len("hello")

                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30
                ) as resp:
                    stats = json.loads(resp.read())
                assert stats["ok"] and stats["requests_served"] == 1

                # malformed requests -> 400, not a dropped connection
                for payload in (b"{}", b"[1,2]", b'{"text": 5}',
                                b'{"text": "x", "spk_id": "abc"}'):
                    bad = urllib.request.Request(
                        f"http://127.0.0.1:{port}/tts", data=payload,
                        headers={"Content-Type": "application/json"},
                    )
                    try:
                        urllib.request.urlopen(bad, timeout=30)
                        raise AssertionError(f"expected 400 for {payload!r}")
                    except urllib.error.HTTPError as e:
                        assert e.code == 400, payload
            finally:
                httpd.shutdown()

    def test_http_long_text_splits_and_stitches(self):
        import io
        import json
        import urllib.request
        import wave
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        pipe = FakePipeline()
        with TTSServer(pipe, max_batch=8, max_wait_ms=30) as server:
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
            port = httpd.server_address[1]
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                text = "第一句话。第二句话。第三句话。"
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/tts",
                    data=json.dumps({"text": text, "max_chars": 5,
                                     "pause_ms": 125.0}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 200
                    body = resp.read()
                with wave.open(io.BytesIO(body)) as wf:
                    assert wf.getframerate() == 8000
                    # 3 pieces of 5 chars -> 3x(32+5) samples + 2 gaps of 1000
                    assert wf.getnframes() == 3 * 37 + 2 * 1000
                # pieces went through the batching server (coalesced or not,
                # all three texts were served)
                served = [t for c in pipe.calls for t in c["texts"]]
                assert served == ["第一句话。", "第二句话。", "第三句话。"]
            finally:
                httpd.shutdown()


class GatedPipeline:
    """First tts_batch call returns at once; later calls block on `gate`."""

    def __init__(self):
        self.calls = 0
        self.gate = threading.Event()
        self.second_done = threading.Event()
        self.lock = threading.Lock()

    def tts_batch(self, texts, language="ZH", spk_ids=None, method="x",
                  infer_speedup=1, max_length=8, seed=0):
        with self.lock:
            n = self.calls
            self.calls += 1
        if n > 0:
            assert self.gate.wait(timeout=30)
        val = 0.25 if n == 0 else -0.25
        out = [(np.full(32 + len(t), val, np.float32), 8000) for t in texts]
        if n > 0:
            self.second_done.set()
        return out


class TestHTTPStreaming:
    def _serve(self, pipe, **server_kw):
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        server = TTSServer(pipe, **server_kw)
        httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), make_handler(server, **getattr(self, "_handler_kw", {}))
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return server, httpd, httpd.server_address[1]

    def test_stream_first_piece_before_second_synthesized(self):
        """/tts/stream must deliver piece 1's audio while piece 2 is still
        being synthesized, and the full stream must decode to
        piece1 + pause + piece2."""
        import http.client
        import json
        import struct

        pipe = GatedPipeline()
        server, httpd, port = self._serve(pipe, max_batch=1, max_wait_ms=5)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            body = json.dumps({"text": "第一句话。第二句话。", "max_chars": 5,
                               "pause_ms": 125.0})
            conn.request("POST", "/tts/stream", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "audio/wav"
            assert resp.headers.get("Transfer-Encoding") == "chunked"

            header = resp.read(44)  # RIFF header with streaming sizes
            assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
            assert struct.unpack_from("<I", header, 4)[0] == 0xFFFFFFFF
            piece1 = resp.read(2 * 37)  # 32 + 5 chars, pcm16
            # first piece's audio is in hand while piece 2 is still gated
            assert not pipe.second_done.is_set()
            first = np.frombuffer(piece1, "<i2").astype(np.float32) / 32767.0
            assert np.allclose(first, 0.25, atol=1e-3)

            pipe.gate.set()
            rest = resp.read()  # gap (1000 samples @8k for 125 ms) + piece 2
            tail = np.frombuffer(rest, "<i2").astype(np.float32) / 32767.0
            assert len(tail) == 1000 + 37
            assert np.allclose(tail[:1000], 0.0)
            assert np.allclose(tail[1000:], -0.25, atol=1e-3)
            conn.close()
        finally:
            pipe.gate.set()
            httpd.shutdown()
            server.close()

    def test_stream_error_before_headers_is_clean_500(self):
        import json
        import urllib.error
        import urllib.request

        pipe = FakePipeline(fail=True)
        server, httpd, port = self._serve(pipe, max_wait_ms=5)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/tts/stream",
                data=json.dumps({"text": "x"}).encode(),
                headers={"Content-Type": "application/json"},
            )
            try:
                urllib.request.urlopen(req, timeout=30)
                raise AssertionError("expected 500")
            except urllib.error.HTTPError as e:
                assert e.code == 500
                assert "exploded" in json.loads(e.read())["error"]
        finally:
            httpd.shutdown()
            server.close()


class TestHTTPHardening:
    def test_auth_token_gates_synthesis_not_probes(self):
        import json
        import urllib.error
        import urllib.request
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        pipe = FakePipeline()
        with TTSServer(pipe, max_wait_ms=5) as server:
            httpd = ThreadingHTTPServer(
                ("127.0.0.1", 0), make_handler(server, auth_token="sekret")
            )
            port = httpd.server_address[1]
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                for path in ("/tts", "/tts/stream"):
                    for hdrs in ({}, {"Authorization": "Bearer wrong"}):
                        req = urllib.request.Request(
                            f"http://127.0.0.1:{port}{path}",
                            data=json.dumps({"text": "x"}).encode(),
                            headers={"Content-Type": "application/json", **hdrs},
                        )
                        try:
                            urllib.request.urlopen(req, timeout=30)
                            raise AssertionError("expected 401")
                        except urllib.error.HTTPError as e:
                            assert e.code == 401, (path, hdrs)
                ok = urllib.request.Request(
                    f"http://127.0.0.1:{port}/tts",
                    data=json.dumps({"text": "x"}).encode(),
                    headers={"Content-Type": "application/json",
                             "Authorization": "Bearer sekret"},
                )
                with urllib.request.urlopen(ok, timeout=30) as resp:
                    assert resp.status == 200
                # probes stay open for load balancers / scrapers
                for path in ("/healthz", "/metrics"):
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=30
                    ) as resp:
                        assert resp.status == 200
            finally:
                httpd.shutdown()

    def test_metrics_prometheus_counters(self):
        import json
        import urllib.request
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        pipe = FakePipeline()
        with TTSServer(pipe, max_wait_ms=5) as server:
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
            port = httpd.server_address[1]
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/tts",
                    data=json.dumps({"text": "hello"}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=30).read()
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=30
                ) as resp:
                    text = resp.read().decode()
                metrics = {
                    line.split()[0]: float(line.split()[1])
                    for line in text.splitlines()
                    if line and not line.startswith("#")
                }
                assert metrics["tts_requests_served_total"] == 1
                assert metrics["tts_requests_failed_total"] == 0
                assert metrics["tts_batches_served_total"] == 1
                # 37 samples at 8 kHz of audio were served
                assert abs(metrics["tts_audio_seconds_served_total"] - 37 / 8000) < 1e-6
                assert metrics["tts_batch_seconds_total"] >= 0
                assert metrics["tts_queue_depth"] == 0
                assert metrics["tts_uptime_seconds"] > 0
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30
                ) as resp:
                    stats = json.loads(resp.read())
                assert stats["requests_failed"] == 0 and "uptime_s" in stats
            finally:
                httpd.shutdown()

    def test_keepalive_survives_early_error_responses(self):
        """401/404 responses must drain the unread body, or the next request
        on the same HTTP/1.1 connection parses garbage."""
        import http.client
        import json
        from http.server import ThreadingHTTPServer

        from latent_diffusion_speech_tpu_torch.cli.serve import make_handler

        pipe = FakePipeline()
        with TTSServer(pipe, max_wait_ms=5) as server:
            httpd = ThreadingHTTPServer(
                ("127.0.0.1", 0), make_handler(server, auth_token="sekret")
            )
            port = httpd.server_address[1]
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                body = json.dumps({"text": "hello"})
                # unauthorized, then not-found, then a good request — all on
                # one connection
                conn.request("POST", "/tts", body, {"Content-Type": "application/json"})
                r = conn.getresponse()
                assert r.status == 401
                r.read()
                conn.request("POST", "/nope", body, {"Content-Type": "application/json"})
                r = conn.getresponse()
                assert r.status == 404
                r.read()
                conn.request(
                    "POST", "/tts", body,
                    {"Content-Type": "application/json",
                     "Authorization": "Bearer sekret"},
                )
                r = conn.getresponse()
                assert r.status == 200
                r.read()
                # oversized declared body is rejected up front
                conn2 = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                conn2.putrequest("POST", "/tts")
                conn2.putheader("Content-Type", "application/json")
                conn2.putheader("Authorization", "Bearer sekret")
                conn2.putheader("Content-Length", str(10 << 20))
                conn2.endheaders()
                r2 = conn2.getresponse()
                assert r2.status == 400 and b"too large" in r2.read()
                conn.close()
                conn2.close()
            finally:
                httpd.shutdown()

    def test_failed_requests_counted(self):
        pipe = FakePipeline(fail=True)
        with TTSServer(pipe, max_wait_ms=5) as server:
            fut = server.submit("x")
            with pytest.raises(ValueError):
                fut.result(timeout=30)
        assert server.requests_failed == 1
        assert server.requests_served == 1
