"""Spans around the program's layers and the reduction of a profiler trace.

In a traced run (`--trace 1`) the benchmark wraps, on the pipeline object
it built and in its own code, the calls into each layer:
`lds.call` (one request), `lds.diffusion` (`Unit2MelSystem.infer`,
synchronised at both ends, so its host time is the stage's time),
`lds.condition`, `lds.pack` (the once-per-call weight preparation),
`lds.denoise` (one denoiser evaluation), `lds.vocoder` (`Vocoder.infer`,
synchronised) and `lds.host_copy` (the waveform to host memory).  Each span
is two readings of the host's clock (`time.time_ns`, the clock the profiler
stamps its events with).  The profiler records the device's operations
alone: recording every host operation as well slowed the eager batched
path's host by ~67% (~12% without).  A marker kernel launched between two
host readings at the trace's start checks the two clocks agree, and moves
the device's stamps onto the host's where they do not.

`Trace` holds what the per-layer metrics read: the device operations, the
spans and the traced calls.  A stage's metrics read its spans only where
every traced call has exactly one (a call that went round a stage, or
entered it twice, leaves them with nothing to read).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

Interval = Tuple[str, int, int]  # (name, start ns, end ns)

GAP_LABELS = {
    None: "between calls",
    "lds.call": "call, outside its stages",
    "lds.diffusion": "sampler update",
    "lds.condition": "condition",
    "lds.pack": "weight packing",
    "lds.denoise": "denoiser step",
    "lds.vocoder": "vocoder",
    "lds.host_copy": "host copy",
}


def no_span(name: str):
    return contextlib.nullcontext()


class SpanRecorder:
    """`recorder(name)` is a context that appends (name, start ns, end ns)
    on the host's clock to `recorder.spans`."""

    def __init__(self):
        self.spans: List[Interval] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


class StageSpans:
    """Installs the spans on one pipeline object."""

    def __init__(self, pipe, span: SpanRecorder):
        self.span = span
        on_card = pipe.device.type == "cuda"
        self.sync = torch.cuda.synchronize if on_card else (lambda: None)
        diffusion, sampler = pipe.diffusion, pipe.diffusion.diffusion
        diffusion.infer = self._synced("diffusion", diffusion.infer)
        pipe.vocoder.infer = self._synced("vocoder", pipe.vocoder.infer)
        diffusion.condition = self._ranged("lds.condition", diffusion.condition)
        if sampler.prepare_sample_params is not None:
            sampler.prepare_sample_params = self._ranged("lds.pack", sampler.prepare_sample_params)
        sampler.denoise_fn = self._ranged("lds.denoise", sampler.denoise_fn)

    def _synced(self, stage: str, fn):
        def wrapped(*args, **kw):
            self.sync()
            with self.span(f"lds.{stage}"):
                out = fn(*args, **kw)
                self.sync()
            return out

        return wrapped

    def _ranged(self, name: str, fn):
        def wrapped(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)

        return wrapped


def start_profiler(device):
    """A started profiler of the device's operations, and the marker's
    (host reading before its launch, host reading after it finished)."""
    cuda = device.type == "cuda"
    activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    prof = torch.profiler.profile(activities=[activity])
    marker = torch.zeros(1, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    prof.start()
    t0 = time.time_ns()
    marker.fill_(1.0)
    if cuda:
        torch.cuda.synchronize(device)
    return prof, (t0, time.time_ns())


def _times(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return int(e.start_us() * 1000), int((e.start_us() + e.duration_us()) * 1000)


def collect(prof, marker: Tuple[int, int]) -> Tuple[List[Interval], int]:
    """The device operations of a finished profiler (`start_profiler`'s),
    on the host's clock: the first operation is the marker, launched
    after the host's reading marker[0] and done by marker[1]; where it
    does not lie between them, every stamp moves by the difference."""
    ops = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if "annotation" not in str(kind):
                ops.append((e.name(), *_times(e)))
    return aligned(ops, marker)


def aligned(ops: List[Interval], marker: Tuple[int, int]) -> Tuple[List[Interval], int]:
    """(`ops` in order without the marker (the first), moved onto the
    host's clock where the marker does not start between the host's
    readings; the ns they moved by)."""
    ops = sorted(ops, key=lambda x: x[1])
    if not ops:
        return ops, 0
    start = ops[0][1]
    shift = 0 if marker[0] <= start <= marker[1] else marker[0] - start
    return [(name, a + shift, b + shift) for name, a, b in ops[1:]], shift


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def union(ops: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The busy intervals of the device within [lo, hi], merged."""
    out: List[List[int]] = []
    for _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans: List[Interval], t: int) -> Optional[str]:
    """The name of the latest-starting span open at time t."""
    best = None
    for name, s, e in spans:
        if s > t:
            break
        if e >= t:
            best = name
    return best


def within(ops: List[Interval], s: int, e: int) -> List[Interval]:
    return [o for o in ops if s <= o[1] < e]


@dataclass
class Trace:
    """One traced window: its device operations and spans (ns on the
    profiler's clock) and the traced calls in order (`frames`, `batch`,
    `bucket`, `audio_s`)."""

    ops: List[Interval]
    spans: List[Interval]
    calls: List[dict]
    evals_per_call: int
    lo: int = field(init=False)
    hi: int = field(init=False)

    def __post_init__(self):
        self.spans = sorted(self.spans, key=lambda x: x[1])
        calls = self.named("lds.call")
        self.lo, self.hi = calls[0][1], calls[-1][2]

    def named(self, name: str) -> List[Interval]:
        return [s for s in self.spans if s[0] == name]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.ops, self.lo, self.hi)) / 1e9

    @property
    def audio_s(self) -> float:
        return sum(c["audio_s"] for c in self.calls)

    @property
    def idle_pct(self) -> Optional[float]:
        """The share of the window, in %, in which no operation ran on the device."""
        return 100.0 * (1.0 - self.busy_s / self.window_s) if self.window_s > 0 else None

    def stage_spans(self, stage: str) -> Optional[List[Interval]]:
        """The traced calls' `lds.<stage>` spans in call order, or None
        where their count is not one a call."""
        spans = self.named(f"lds.{stage}")
        return spans if spans and len(spans) == len(self.calls) else None

    def stage_ms_per_audio_s(self, stage: str) -> Optional[float]:
        """Host ms inside the stage's synchronised spans per second of the
        traced calls' audio."""
        spans = self.stage_spans(stage)
        if spans is None or self.audio_s == 0:
            return None
        return sum(e - s for _, s, e in spans) / 1e6 / self.audio_s

    def per_call(self, stage: str) -> List[Tuple[dict, List[Interval]]]:
        """Each traced call with the device operations that started inside
        its `stage` span (none where `stage_spans` finds nothing)."""
        spans = self.stage_spans(stage) or []
        return [(c, within(self.ops, s, e)) for c, (_, s, e) in zip(self.calls, spans)]

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, int] = {}
        for name, s, e in self.ops:
            if self.lo <= s < self.hi:
                by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        idle = gaps(union(self.ops, self.lo, self.hi), self.lo, self.hi)
        idle.sort(key=lambda g: g[0] - g[1])
        labelled = [[GAP_LABELS.get(innermost(self.spans, (s + e) // 2), "other"), (e - s) / 1e9]
                    for s, e in idle[:n]]
        return {"device_ops": [[name[:200], ns / 1e9] for name, ns in top], "idle_gaps": labelled}
