"""Spans and counts at the stream simulator's layer boundaries.

A span names one step of a job (``nsa.host_tables``, ``store.write``,
``replay.produce`` ...) and records, when it closes, its name, the call id
of the entry call it belongs to (``Controller.run`` and ``run_many`` each
open a root span ``call`` with a fresh id), its parent span, its thread,
its start and end in ``time.time_ns()`` and a small dict of counts (rows,
bytes, buckets). An operator turns the tracer on in one of two ways:

- run the simulator under ``torch.profiler``: while a profile records, the
  tracer is on by itself, and each span is also a range of the profile (a
  CPU operation named like the span, on the thread that started the
  profile), so an exported trace shows the simulator's steps beside the
  kernels and copies they launched;
- or call :func:`enable` (the one switch), then read the spans with
  :func:`drain`::

      from repro_torch import tracing
      tracing.enable()
      ctl.run_many(datasets, ranges, consumer)
      for r in tracing.drain():
          print(r.name, r.call, r.seconds, r.counts)

A span never synchronises the device. Where the simulator already waits on
the device (a copy to the host, a pageable upload), the span's time holds
that wait, as the simulator's does; the device's own time is read from a
device trace. ``time.time_ns()`` is the clock of the profiler's events, so
records and a device trace line up with no mapping.

The profile's range is a plain CPU operation, not a ``record_function``
annotation: the profiler mirrors an annotation onto the device's timeline
over the first to the last kernel it launched, which a reader of the
device trace would take for device work.

Off (the default), :func:`span` is one flag test and returns a shared
no-op: it keeps no record and opens no range. Records stay in memory until
:func:`drain` returns them; beyond :data:`MAX_RECORDS` the oldest go
first.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

#: records kept before the oldest are dropped
MAX_RECORDS = 1 << 18

_switch = False
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    """One closed span. ``call`` and ``parent`` are 0 outside any call or
    span; stamps are ``time.time_ns()``."""

    name: str
    call: int
    id: int
    parent: int
    thread: int
    start_ns: int
    end_ns: int
    counts: Dict[str, object]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Context(NamedTuple):
    """What a thread that a call starts needs to put its spans in the call:
    the call id and the span that started the thread."""

    call: int
    parent: int


def enable(on: bool = True) -> None:
    """Turn the tracer on (or off) outside a profile."""
    global _switch
    _switch = bool(on)


def drain() -> List[Record]:
    """The records kept so far, oldest first; the tracer keeps none after."""
    out = []
    while True:
        try:
            out.append(_records.popleft())
        except IndexError:
            return out


def records() -> List[Record]:
    """The records kept so far, oldest first, left in place."""
    return list(_records)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "counts", "call", "id", "parent", "start_ns",
                 "_range")

    def __init__(self, name: str, counts: Dict, call: int, parent: int):
        self.name, self.counts = name, counts
        self.call, self.parent = call, parent
        self.id = next(_span_ids)

    def __bool__(self) -> bool:
        return True

    def count(self, **counts) -> None:
        self.counts.update(counts)

    def context(self) -> Context:
        return Context(self.call, self.id)

    def __enter__(self) -> "_Span":
        _stack().append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _records.append(Record(self.name, self.call, self.id, self.parent,
                               threading.get_ident(), self.start_ns, end_ns,
                               self.counts))
        return False


class _Off:
    """The span of a tracer that is off: does nothing, and is false."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass

    def context(self) -> None:
        return None


_OFF = _Off()


def span(name: str, within: Optional[Context] = None, **counts):
    """A span ``name`` with ``counts``, a context manager; more counts can
    be added with ``.count(...)`` while it is open. Its parent is the open
    span of this thread, or ``within`` (a :class:`Context` handed over by
    the thread that started this one). Off, the shared no-op, which is
    false, so a count that costs something can be guarded with ``if sp:``.
    """
    if not (_switch or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, counts, *(within or context() or Context(0, 0)))


def call(**counts):
    """The root span ``call`` of one entry call, with a fresh call id."""
    if not (_switch or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span("call", counts, next(_call_ids),
                 (context() or Context(0, 0)).parent)


def context() -> Optional[Context]:
    """The open span of this thread, to hand to a thread it starts (None
    where the tracer is off or no span is open)."""
    stack = getattr(_local, "stack", None)
    return Context(stack[-1].call, stack[-1].id) if stack else None
