"""Profiling hooks.

Counterpart of `latent_diffusion_speech_tpu/utils/profiler.py`:
`profile_trace` wraps a region with `torch.profiler` (CPU, and CUDA when a
card is present) and writes a Chrome trace (`trace.json`, for
chrome://tracing or Perfetto) under `logdir`; no TensorBoard is needed.
`annotate(name)` is a named span in that trace (`torch.profiler.record_function`).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

__all__ = ["profile_trace", "annotate"]


@contextlib.contextmanager
def profile_trace(logdir: str | Path, enabled: bool = True):
    """Trace the block into `<logdir>/trace.json`; yields the profiler
    (None when not enabled) for `key_averages()`."""
    if not enabled:
        yield None
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


annotate = torch.profiler.record_function
