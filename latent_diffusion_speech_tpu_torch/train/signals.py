"""Preemption-safe training: checkpoint on SIGTERM/SIGINT.

A copy of `latent_diffusion_speech_tpu/train/signals.py`.  Managed
accelerator fleets deliver SIGTERM with a short grace window before
eviction.  The reference has no handling at all — a
preempted run loses everything since the last interval_val save.  Trainers
here wrap their epoch loops in `GracefulShutdown`; the handler only sets a
flag (async-signal-safe), the loop checks it between steps, saves once, and
exits cleanly.  Handlers are restored on exit so nested/interactive use
(pytest, notebooks) keeps normal Ctrl-C behavior afterwards.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

__all__ = ["GracefulShutdown"]


class GracefulShutdown:
    """Context manager: flips `requested` when SIGTERM/SIGINT arrives.

    Only the main thread can install signal handlers; used from any other
    thread (e.g. a test harness or a serving sidecar) it degrades to a plain
    flag that `request()` can set manually."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Programmatic trigger (tests, sidecars)."""
        self._event.set()

    def _handler(self, signum, frame):
        self._event.set()

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
