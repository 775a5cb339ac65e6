"""Host spans of the serving loop, kept in memory.

The scheduler, the engines and the DVFS hooks open named spans around their
phases (``sched.step``, ``sched.refill``, ``engine.lane_load``,
``dvfs.arbitrate``, ``step.readback`` ...).  Nothing is recorded unless a
recorder is enabled:

    rec = trace.enable()
    ... serve ...
    trace.disable()
    for r in rec.records():   # start_ns, end_ns, name, parent, uid
        ...

A record's ``parent`` is the index in ``records()`` of the span that was
open when it began (-1 at the top), and ``uid`` the request it served where
there is one.  The clock is ``time.perf_counter_ns``.  Spans nest on one
host thread; open one only as a ``with`` statement.

When no recorder is enabled, ``span()`` reads one module global and returns
a shared object whose ``__enter__`` and ``__exit__`` do nothing: no clock
read, no allocation.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional


class Record(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    parent: int                 # index of the enclosing span, -1 at the top
    uid: Optional[int]          # the request served, where there is one


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """The spans recorded since ``enable()``.  Its ``__exit__`` closes the
    innermost open span: ``span()`` opens one and returns the recorder."""

    def __init__(self):
        self._recs: List[list] = []      # [start, end, name, parent, uid]; end -1 while open
        self._top = -1

    def open(self, name: str, uid: Optional[int] = None) -> "Recorder":
        self._recs.append([time.perf_counter_ns(), -1, name, self._top, uid])
        self._top = len(self._recs) - 1
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        r = self._recs[self._top]
        r[1] = time.perf_counter_ns()
        self._top = r[3]
        return False

    def records(self) -> List[Record]:
        """Every span, in the order they began (one still open has
        ``end_ns`` -1)."""
        return [Record(*r) for r in self._recs]


_current: Optional[Recorder] = None


def enable() -> Recorder:
    """Start recording into a new recorder, and return it."""
    global _current
    _current = Recorder()
    return _current


def disable() -> None:
    """Stop recording; a recorder keeps what it holds."""
    global _current
    _current = None


def current() -> Optional[Recorder]:
    return _current


def span(name: str, uid: Optional[int] = None):
    """A ``with`` context recording ``name`` (and the request ``uid``) when
    a recorder is enabled; otherwise the shared no-op."""
    rec = _current
    if rec is None:
        return _OFF
    return rec.open(name, uid)

