"""The port's tracer: named host spans and counters inside the program.

`span(name)` is a context that, while recording, appends
`(name, request, parent, start_ns, end_ns)` to an in-memory list: `parent`
is the name of the span open around it on the same thread (None for a
root), and a root span opens a new request id that every span inside it
carries.  `count(name, n)` adds n to a named counter.  Stamps are
`time.time_ns()`, the clock `torch.profiler` stamps its device events
with, so the program's spans line up with a profile's device operations.

Recording is on between `enable()` and `disable()`, and while a
`torch.profiler` session runs (as `torch.profiler.record_function` is), so
any profile of the program carries its spans.  Off, `span` is one test of
two module flags returning a shared no-op context, and `count` the same
test.  `drain()` returns what was recorded and empties it.  The tracer
never touches the device: no synchronise, no event, no `record_function`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import profiler as _torch_profiler

__all__ = ["span", "count", "enable", "disable", "drain"]

Span = Tuple[str, int, Optional[str], int, int]  # (name, request, parent, start ns, end ns)

_on = False
_spans: List[Span] = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()
_requests = itertools.count(1)
_OFF = contextlib.nullcontext()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    __slots__ = ("name", "request", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if stack:
            self.request, self.parent = stack[-1].request, stack[-1].name
        else:
            self.request, self.parent = next(_requests), None
        stack.append(self)
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _spans.append((self.name, self.request, self.parent, self.start, end))
        return False


def span(name: str):
    """A context recording one span named `name` (see the module's doc)."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` while recording."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """(the spans recorded, in the order they closed; the counters), both
    emptied."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return spans, counters
