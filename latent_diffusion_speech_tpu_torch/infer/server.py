"""Dynamic-batching TTS serve loop.

Counterpart of `latent_diffusion_speech_tpu/infer/server.py` (pure Python,
the same semantics): callers `submit()` from any thread and get a future; a
single dispatch thread drains the queue, waits up to `max_wait_ms` for a
batch to fill (the window anchored to the first arrival, so no request
waits longer than that), runs `TTSPipeline.tts_batch` (one LM decode for
all streams, diffusion + vocoder once per length bucket) and resolves the
futures.

One dispatch thread means one owner of the card: every CUDA call of the
pipeline (and the kernels' per-process state: K1's packed-weight cache,
the launch counters) is made from it.  Grad mode is thread-local, so the
pipeline's serve calls run under `torch.no_grad` themselves.  Callers'
threads touch only numpy results and futures.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["TTSServer", "TTSRequest", "ServerOverloaded"]


class ServerOverloaded(RuntimeError):
    """Raised by submit()/submit_many() when the admission queue is full.

    Typed so transports can map it to backpressure (HTTP 429) instead of a
    generic failure; carries the depth that triggered the rejection."""

    def __init__(self, depth: int, max_queue: int):
        super().__init__(
            f"server overloaded: {depth} requests queued (max_queue={max_queue})"
        )
        self.depth = depth
        self.max_queue = max_queue


@dataclass
class TTSRequest:
    text: str
    language: str = "ZH"
    spk_id: int = 1
    seed: int = 0
    future: Future = field(default_factory=Future)
    # monotonic admission time; dispatch latency = batch start - t_submit
    t_submit: float = 0.0
    # solo-dispatch hint: skip the batching window and run this request as a
    # batch of one (streaming first pieces — see submit_many(first_urgent))
    urgent: bool = False


class TTSServer:
    def __init__(
        self,
        pipeline,
        max_batch: int = 8,
        max_wait_ms: float = 30.0,
        method: str = "dpm-solver",
        infer_speedup: int = 50,
        max_length: int = 1024,
        max_queue: int = 0,
        seed_strict: bool = False,
    ):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.method = method
        self.infer_speedup = infer_speedup
        self.max_length = max_length
        # backpressure: reject admissions past this queue depth (0 = unbounded)
        self.max_queue = max_queue
        # seed semantics under dynamic batching: tts_batch takes ONE seed,
        # and the generator's draws depend on the batch shape anyway, so
        # exact per-request audio reproducibility only holds for solo
        # dispatches.  Default (False): coalesce unlike seeds — the batch runs
        # with the first request's seed and per-request seeds are best-effort
        # (real load would otherwise never batch: every request carries its
        # own seed and the mean batch size collapses to 1).  seed_strict=True
        # restores per-seed separation for single-tenant/testing determinism.
        self.seed_strict = seed_strict
        self._queue: "queue.Queue[Optional[TTSRequest]]" = queue.Queue()
        self._pending: Optional[TTSRequest] = None  # dispatch-thread only
        # True while a batch is inside tts_batch — gates the urgent hint
        # (written by the dispatch thread only; benign read race in submit)
        self._busy = False
        self._closed = False
        self._lifecycle = threading.Lock()  # orders submit() vs close()
        self.batches_served = 0
        self.requests_served = 0
        self.requests_failed = 0
        self.requests_rejected = 0
        self.batch_seconds_total = 0.0  # wall time spent inside tts_batch
        self.audio_seconds_served = 0.0
        # queue-wait observability: admission -> batch-dispatch latency
        self.queue_wait_seconds_total = 0.0
        self.queue_wait_count = 0
        from collections import deque

        self._recent_waits: "deque[float]" = deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, text: str, language: str = "ZH", spk_id: int = 1,
               seed: int = 0) -> Future:
        """Enqueue a request; the future resolves to (waveform, sample_rate).
        Raises ServerOverloaded when the queue is at max_queue depth."""
        return self.submit_many([text], language=language, spk_ids=[spk_id],
                                seed=seed)[0]

    def submit_many(self, texts, language: str = "ZH", spk_ids=None,
                    seed: int = 0, first_urgent: bool = False) -> "list[Future]":
        """Atomically admit a group of requests (e.g. a long text's sentence
        pieces): either ALL are queued or ServerOverloaded is raised and NONE
        are — a partial admit would synthesize audio the caller, having seen
        the rejection, will never collect.  Piece i gets seed+i so unlike
        seeds keep dispatching separately (see _collect).

        first_urgent: streaming time-to-first-audio hint.  A chunked /tts/
        stream response can start playing after piece 1, but when all pieces
        are admitted at once the batcher packs pieces 1..max_batch into ONE
        device call and the first piece's future resolves only with the whole
        batch — TTFA degenerates to total latency.  With the hint, piece 1
        dispatches SOLO while pieces 2..n batch behind it.  Adaptivity: the
        hint is honored only when the server is idle (empty queue, no batch
        in flight) at admission — on a busy server piece 1 waits behind
        in-flight work either way, so a solo dispatch would fragment
        batching without improving TTFA."""
        import time as _time

        spk_ids = spk_ids if spk_ids is not None else [1] * len(texts)
        now = _time.monotonic()
        reqs = [
            TTSRequest(t, language, s, seed + i, t_submit=now)
            for i, (t, s) in enumerate(zip(texts, spk_ids))
        ]
        with self._lifecycle:
            # under the lock, either the sentinel is not yet queued (the
            # dispatcher will see these requests before it) or we raise —
            # a future returned by submit() always resolves
            if self._closed:
                raise RuntimeError("server is closed")
            depth = self.queue_depth()
            if self.max_queue and depth + len(reqs) > self.max_queue:
                self.requests_rejected += len(reqs)
                raise ServerOverloaded(depth, self.max_queue)
            # single-piece requests benefit too: at an idle server nothing
            # can batch with the piece anyway, so skipping the max_wait_ms
            # window is pure TTFA win
            if first_urgent and depth == 0 and not self._busy:
                reqs[0].urgent = True
            for req in reqs:
                self._queue.put(req)
        return [r.future for r in reqs]

    def queue_depth(self) -> int:
        """Requests submitted but not yet dispatched (approximate)."""
        return self._queue.qsize() + (1 if self._pending is not None else 0)

    def queue_wait_recent(self) -> "list[float]":
        """Snapshot of the most recent admission->dispatch waits (seconds,
        up to 4096) for percentile reporting; totals are on
        queue_wait_seconds_total / queue_wait_count."""
        return list(self._recent_waits)

    def close(self):
        """Drain outstanding requests, then stop the dispatch thread."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch loop -------------------------------------------------------

    def _collect(self):
        """Block for one request, then batch up to max_batch compatible ones
        arriving within max_wait_ms of the FIRST (the window does not restart
        per arrival, so no request waits longer than max_wait_ms to dispatch).
        Returns (requests, saw_sentinel)."""
        import time as _time

        first = self._pending or self._queue.get()
        self._pending = None
        if first is None:
            return [], True
        if first.urgent:
            # solo dispatch: no batching window.  Only ever set on the first
            # piece of a lightly-loaded streaming request (submit_many), so
            # this cannot starve or collapse steady-state batching.
            return [first], False
        batch = [first]
        deadline = _time.monotonic() + max(self.max_wait_ms, 0.0) / 1e3
        saw_sentinel = False
        while len(batch) < self.max_batch:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                saw_sentinel = True
                break
            if nxt.language != first.language or (
                self.seed_strict and nxt.seed != first.seed
            ):
                # languages batch separately (different frontends); in
                # seed_strict mode unlike seeds dispatch separately too.  The
                # incompatible request becomes the next batch's first
                # (requeueing would let it starve behind a steady stream of
                # compatible arrivals)
                self._pending = nxt
                break
            batch.append(nxt)
        return batch, saw_sentinel

    def _loop(self):
        while True:
            batch, stop = self._collect()
            if batch:
                import time as _time

                t0 = _time.monotonic()
                self._busy = True
                for r in batch:
                    w = t0 - r.t_submit if r.t_submit else 0.0
                    self.queue_wait_seconds_total += w
                    self.queue_wait_count += 1
                    self._recent_waits.append(w)
                try:
                    results = self.pipeline.tts_batch(
                        [r.text for r in batch],
                        language=batch[0].language,
                        spk_ids=[r.spk_id for r in batch],
                        method=self.method,
                        infer_speedup=self.infer_speedup,
                        max_length=self.max_length,
                        seed=batch[0].seed,
                    )
                    for req, res in zip(batch, results):
                        req.future.set_result(res)
                    self.audio_seconds_served += sum(
                        len(w) / float(sr) for w, sr in results if sr
                    )
                except Exception as e:  # noqa: BLE001 — delivered to callers
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(e)
                    self.requests_failed += len(batch)
                self.batch_seconds_total += _time.monotonic() - t0
                self.batches_served += 1
                self.requests_served += len(batch)
                self._busy = False
            if stop:
                # keep draining anything still queued (or held pending)
                # before exiting; re-arm the sentinel so the next _collect()
                # terminates too
                if self._pending is not None or not self._queue.empty():
                    self._queue.put(None)
                    continue
                return
