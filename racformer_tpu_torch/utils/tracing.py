"""Spans at the port's layer boundaries: the streaming eval step and its
phases, the model's trunk, BEV branches and head, each decoder iteration,
and the train step's phases (the names are listed in `PERF.md` §3).

`span(name, step=None, **counts)` is a context manager that does nothing
unless the recorder is on (`enable()`), a listener is set (`listen()`) or
`torch.profiler` is running:

- all off: it returns one shared no-op object, after a check of three
  module flags; no torch call, no clock read;
- recorder on: the span is kept in memory as a `Span` (name, parent index,
  step id, start and end on `time.perf_counter_ns`, counts). A span opened
  without `step` takes the step id of the span it opens in, so the spans
  of one frame or train step share the root's id;
- profiler running: the span also opens a record function named
  "racformer." + name. It then lands in the profiler's trace, and the
  profiler links every kernel launched under it, the ctypes launches of
  K1-K4 included, to it.

`count(name, n)` adds to the counts of the innermost open span. The
records stay in memory until `clear()`; whoever reads them writes them
out. Spans nest per thread.

`listen(fn)` has every span call `fn(name, entering)` at its entry and at
its clean exit, until `listen(None)`: the decoder's CUDA-graph capture
(`eval/graphs.py`) cuts its graphs there, so that a replay can open the
same spans around them.
"""

from __future__ import annotations

import threading
from time import perf_counter_ns
from typing import Callable, List, Optional

from torch._C._profiler import _RecordFunctionFast as record_function
from torch.autograd import profiler as _profiler

PREFIX = "racformer."  # the spans' prefix in the profiler's trace
# `record_function` is the op-scope record function torch's compiler opens
# around its own kernel launches: the profiler links a kernel to the
# innermost op-scope event open at its launch, and it links none of a user
# scope's (`torch.profiler.record_function`), so K1's launches by ctypes,
# which no torch op encloses, would be left unlinked under one.

_recording = False
_listener: Optional[Callable[[str, bool], None]] = None
_records: List["Span"] = []
_local = threading.local()


class _Off:
    """The span returned while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: `name`, `parent` (the index in `records()` of the span it
    opened in, -1 for a root), `step`, `start_ns` / `end_ns`
    (`time.perf_counter_ns`) and `counts` ({name: summed n})."""

    __slots__ = ("name", "parent", "step", "start_ns", "end_ns", "counts",
                 "index", "_rf")

    def __init__(self, name: str, step, counts: dict):
        self.name, self.step, self.counts = name, step, counts
        self.parent = self.index = -1
        self.start_ns = self.end_ns = 0
        self._rf = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = record_function(PREFIX + self.name)
            self._rf.__enter__()
        if _recording:
            stack = _stack()
            if stack:
                self.parent = stack[-1].index
                if self.step is None:
                    self.step = stack[-1].step
            self.index = len(_records)
            _records.append(self)
            stack.append(self)
            self.start_ns = perf_counter_ns()
        if _listener is not None:
            _listener(self.name, True)
        return self

    def __exit__(self, *exc):
        if _listener is not None and exc[0] is None:
            _listener(self.name, False)
        if self.index >= 0:
            self.end_ns = perf_counter_ns()
            _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


def span(name: str, step=None, **counts):
    """The span `name` as a context manager (the shared no-op while neither
    the recorder, a listener nor the profiler runs). `step`: the step id of
    a root span; `counts`: its initial counts."""
    if not (_recording or _listener is not None
            or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, step, counts)


def count(name: str, n) -> None:
    """Add `n` to count `name` of the innermost open recorded span."""
    if _recording:
        stack = _stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def recording() -> bool:
    """Whether the recorder is on (guard a count that costs work to make)."""
    return _recording


def listen(fn: Optional[Callable[[str, bool], None]]) -> None:
    """Call `fn(name, entering)` at every span's entry and clean exit from
    now on (None: stop)."""
    global _listener
    _listener = fn


def enable() -> None:
    """Record the spans opened from now on."""
    global _recording
    _recording = True


def disable() -> None:
    """Stop recording; the records are kept."""
    global _recording
    _recording = False


def records() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return list(_records)


def clear() -> None:
    """Drop the records (call it between steps: open spans keep their
    places in the list that is dropped)."""
    _records.clear()
