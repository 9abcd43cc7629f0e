"""A process-wide flight recorder of spans: what the serving loop's host
code was doing, and when, on a clock that a device trace can be laid
against.

A span records a name, its start and end (``time.perf_counter()``, in
seconds, read through the ``time`` module at each stamp), the span open
around it when it began (its parent, by id; 0 for a root) and a few
attributes.  Closed spans go into one bounded ring of ``CAPACITY``; once
it is full each new span pushes out the oldest, counted in ``dropped``.
``snapshot()`` returns the ring's spans, oldest closed first.

Two levels:

  coarse   ``span``: a few spans per engine call and per window
           of the MAPE-K loop, recorded whenever ``enabled``
  detail   ``detail``: the insides of a decode step (embedding, per-step
           parameter views, each layer, the head, sampling), recorded
           only inside ``detailed(True)``, which the engine enters for an
           eager decode made while a torch profiler records
           (``profiling()``): only then can they be laid against device
           time (a replayed decode has no insides on the host)

``enabled = False`` records nothing, at either level.  A span still
times its region then: the program's own timers
(``ServeReport.prefill_s``/``decode_s``, ``measure_seconds``,
``AnalysisReport``'s seconds) are the durations of their spans, so there
is one clock read per stamp, recorded or not.

The device trace's clock: torch.profiler stamps device events in Unix
nanoseconds.  An engine call reads ``time.time_ns()`` beside its span's
start (``anchor``); ``trace_us`` maps any stamp inside the call onto
that clock, in microseconds.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

CAPACITY = 1 << 16
enabled = True
dropped = 0

_ring: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_detail = False
_NULL = contextlib.nullcontext()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One timed region; a context manager, or ``span`` then ``close``."""

    __slots__ = ("id", "parent", "name", "start", "end", "attrs", "_rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.end = name, attrs, None
        self._rec = enabled
        if self._rec:
            stack = _stack()
            self.id = next(_ids)
            self.parent = stack[-1].id if stack else 0
            stack.append(self)
        else:
            self.id = self.parent = 0
        self.start = time.perf_counter()

    def close(self) -> float:
        """Stamp the end, record the span; returns its seconds."""
        self.end = time.perf_counter()
        if self._rec:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:            # children left open by a raise
                del stack[stack.index(self):]
            _record(self)
        return self.end - self.start

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def anchor(self) -> None:
        """Read the device trace's clock beside this span's start."""
        self.attrs["unix_ns"] = time.time_ns()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.start:.6f}..{self.end}, {self.attrs})")


def _record(sp: Span) -> None:
    global dropped
    if len(_ring) == _ring.maxlen:
        dropped += 1
    _ring.append(sp)


def span(name: str, **attrs) -> Span:
    """Open a coarse span: ``with trace.span(name, **attrs) as sp:``, or
    ``sp = trace.span(...)`` and later ``sp.close()``."""
    return Span(name, attrs)


def detail(name: str, **attrs):
    """A detail span inside ``detailed(True)``, else a no-op context."""
    return Span(name, attrs) if _detail else _NULL


@contextlib.contextmanager
def detailed(on: bool):
    """Record detail spans inside the block when ``on`` (and
    ``enabled``)."""
    global _detail
    before, _detail = _detail, bool(on and enabled)
    try:
        yield
    finally:
        _detail = before


def profiling() -> bool:
    """Whether a torch profiler records now (under a schedule: only in
    its active steps)."""
    import torch.autograd.profiler as P
    return bool(enabled and P._is_profiler_enabled)


def snapshot() -> list:
    """The recorded spans, oldest closed first."""
    return list(_ring)


def reset() -> None:
    """Empty the ring and zero ``dropped``."""
    global dropped
    _ring.clear()
    dropped = 0


def trace_us(t: float, call: Span) -> float:
    """Stamp ``t`` (``time.perf_counter()``) of a span inside the engine
    call ``call`` (one with an ``anchor``) on the device trace's clock:
    Unix microseconds."""
    return call.attrs["unix_ns"] / 1e3 + (t - call.start) * 1e6
