"""Spans of the port's host work, on the profiler's clock.

``span(name)`` marks one piece of host work at a layer boundary; names are
``<layer>.<what>`` (``compiled.replay``, ``evaluator.fetch``), the layer
first. A span records only while a ``torch.profiler`` session records
(``TPU.PROFILE_DIR``'s trace, or any caller's own session): then it also
opens a profiler range of its name, so the profiler's trace shows it, and
it keeps ``Span(name, start_ns, end_ns, parent, root, index)`` in a bounded
buffer in memory. With no profiler on, a span costs one flag check.

The range is the profiler's operator-scope one (``_RecordFunctionFast``,
a host range in the trace, about a microsecond), not ``record_function``:
the profiler mirrors a ``record_function`` range onto the device's
timeline as well (``gpu_user_annotation``, from its first kernel to its
last), where a reader that takes each device record for work would count
the idle time inside it as busy.

The clock is ``time.time_ns()``, the one the profiler stamps its host and
device events with, so a span can be laid against the device's records
with no conversion. It is read just inside the range's start and just past
its end, the reads that lie closest to the profiler's own stamps. ``parent`` is the enclosing span's
``index`` on the same thread (-1 for none), ``root`` the outermost one's,
so the spans of one evaluation or one epoch share a root. A span entered
while no profiler records is not on that stack: spans under it are roots
of their own.

``timed(name)`` is a span that reads its clock whatever the profiler does
(``.seconds`` after it ends), for work rare enough to time always, such as
a CUDA graph's capture; it too records only under a profiler.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import List, NamedTuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18  # the records kept, the oldest dropped first


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the enclosing span's index, -1 for none
    root: int  # the outermost enclosing span's index (its own for a root)
    index: int


_records: deque = deque(maxlen=CAPACITY)
_indices = itertools.count()
_local = threading.local()
_OFF = nullcontext()
_range = _RecordFunctionFast  # the profiler's range a recorded span opens


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "record", "fn", "index", "parent", "root", "start_ns", "end_ns")

    def __init__(self, name: str, record: bool):
        self.name, self.record = name, record

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        if self.record:
            stack = _stack()
            self.index = next(_indices)
            self.parent = stack[-1].index if stack else -1
            self.root = stack[0].index if stack else self.index
            stack.append(self)
            self.fn = _range(self.name)
            self.fn.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.record:
            self.fn.__exit__(*exc)
        self.end_ns = time.time_ns()
        if self.record:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            _records.append(Span(self.name, self.start_ns, self.end_ns, self.parent, self.root,
                                 self.index))
        return False


def span(name: str):
    """A context manager over one piece of host work: recorded under a
    profiler, nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, True)


def timed(name: str) -> _Span:
    """A span that times itself always (``.seconds``) and records under a
    profiler."""
    return _Span(name, _profiler._is_profiler_enabled)


def spans(lo_ns: int = 0, hi_ns: int = 1 << 63) -> List[Span]:
    """The kept spans that overlap [``lo_ns``, ``hi_ns``], in the order they
    ended."""
    return [s for s in list(_records) if s.end_ns >= lo_ns and s.start_ns <= hi_ns]


def clear() -> None:
    """Forget every kept span."""
    _records.clear()
