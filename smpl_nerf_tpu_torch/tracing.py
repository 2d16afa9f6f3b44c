"""Spans of the program's own layers, on the profiler's clock.

    with tracing.span("solver.step", request=step):
        ...

A span is `Span(name, start_ns, end_ns, parent, request)`. Both ends are
`time.time_ns()`, the Unix clock that torch.profiler stamps its host and
device events with, so a span can be laid over a device trace of the same
stretch. Nothing here synchronises the device: a span that holds a host read
of a device value (the loss read, a view's read-back) measures the wait that
is already there. `parent` is the index in `snapshot().spans` of the span
open around it on this thread (None at the top); `request` is given where the
work is numbered (the global step, the epoch, a render call) and is otherwise
the parent's.

Off (the default) `span` returns one shared no-op context. `enable(capacity)`
starts a fresh buffer of at most `capacity` spans; a span past it is dropped
and counted. While the recorder is on every span, kept or dropped, is also a
profiler range of the same name, so a torch.profiler trace (`--profile_dir`)
shows the same names. The range is PyTorch's `_RecordFunctionFast`, the one
its compiler puts around generated kernels, which skips the dispatcher call
that makes `torch.profiler.record_function` cost several µs a span. It is
entered only while a profiler runs: its exit asserts where a profiler started
after its enter, as one does inside an epoch or a view when a caller starts
its profile there. A range still open when its profiler stops corrupts the
profiler's memory when it ends later (a CPU profile then crashes the process
at a later garbage collection), so a caller that stops a profiler while spans
are open calls `end_ranges()` first. Both the range and the profiler test are
private to PyTorch, so `enable` imports them: the port's import and the off
path need neither. `disable()` stops recording and keeps the buffer for
`snapshot()`.
"""
from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]         # None while the span is open
    parent: Optional[int]         # index of the enclosing span, None at the top
    request: Optional[int]


class Snapshot(NamedTuple):
    spans: List[Span]
    dropped: int                  # spans past the capacity, not kept


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.spans: List[list] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ranged: dict = {}               # open spans whose range is open, in order

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


class _Span:
    __slots__ = ("rec", "name", "request", "index", "range")

    def __init__(self, rec: _Recorder, name: str, request: Optional[int]):
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        parent, request = stack[-1] if stack else (None, None)
        if self.request is not None:
            request = self.request
        self.range = None
        if _profiler_enabled():
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        start = time.time_ns()
        with rec.lock:
            if self.range is not None:
                rec.ranged[self] = None
            if len(rec.spans) < rec.capacity:
                self.index = len(rec.spans)
                rec.spans.append([self.name, start, None, parent, request])
            else:
                self.index = None
                rec.dropped += 1
        # a dropped span's children are dropped too: the buffer stays full
        stack.append((self.index, request))
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        with self.rec.lock:
            ranged, self.range = self.range, None
            self.rec.ranged.pop(self, None)
        if ranged is not None:
            ranged.__exit__(*exc)
        self.rec.stack().pop()
        if self.index is not None:
            self.rec.spans[self.index][2] = end
        return False


_recorder: Optional[_Recorder] = None      # the recorder spans go to while on
_last: Optional[_Recorder] = None          # the newest recorder, for snapshot()
_profiler_enabled = _RecordFunctionFast = None   # PyTorch's, bound by enable()


def span(name: str, request: Optional[int] = None):
    """A context that records `name` while the recorder is on."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Span(rec, name, request)


def enabled() -> bool:
    return _recorder is not None


def enable(capacity: int) -> None:
    """Record spans from now on, into a fresh buffer of `capacity` spans."""
    global _recorder, _last, _profiler_enabled, _RecordFunctionFast
    from torch._C._autograd import _profiler_enabled
    from torch._C._profiler import _RecordFunctionFast
    _recorder = _last = _Recorder(capacity)


def end_ranges() -> int:
    """End the profiler ranges of the spans still open, before the caller
    stops its profiler; the spans stay open in the buffer. Returns how many
    ranges it ended."""
    rec = _last
    if rec is None:
        return 0
    with rec.lock:
        open_spans, rec.ranged = list(reversed(rec.ranged)), {}     # innermost first
        ranges = [sp.range for sp in open_spans]
        for sp in open_spans:
            sp.range = None
    for r in ranges:
        r.__exit__(None, None, None)
    return len(ranges)


def disable() -> None:
    """Stop recording; spans still open are closed into the same buffer."""
    global _recorder
    _recorder = None


def snapshot() -> Snapshot:
    """The spans of the newest `enable` so far, in the order they opened."""
    rec = _last
    if rec is None:
        return Snapshot([], 0)
    with rec.lock:
        return Snapshot([Span(*s) for s in rec.spans], rec.dropped)
