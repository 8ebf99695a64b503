"""Spans and counts at the port's layer boundaries, kept in memory.

A span is a named stretch of one thread's time: an id, the id of the span
open on the same thread when it opened (its parent), the id of the
request it served where there is one, its start and end as
``time.perf_counter_ns()`` and a small dict of integer counts. The serving
engine (``engine.*``) and the trainer (``train.*``) open them at their
layer boundaries::

    with spans.span("engine.chunk", k=k, units=n) as chunk:
        ...
        chunk.set(emitted=emitted)

Recording is on while a ``torch.profiler`` session runs
(``torch.autograd.profiler._is_profiler_enabled``, which the profiler sets
at its start and clears at its stop, whatever activities it traces) or
after :func:`enable`. Off, a span site returns :data:`NULL`, which records
nothing, after one test. On, each span is also entered as a
``torch.profiler.record_function`` range of its name, so that a trace with
CPU activity (the trainer's ``--profile-dir``) shows the spans on the
profiler's own clock. Nothing is recorded while the thread's current CUDA
stream captures a graph: a captured body runs once at capture, and its
replays pass no span site. Spans stay in a bounded buffer (the newest
``CAPACITY``) until :func:`clear`; :func:`recorded` returns them.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

#: the spans a recorder keeps: the newest, the oldest dropped first
CAPACITY = 1 << 16


@dataclasses.dataclass
class Span:
    """One span; ``start`` and ``end`` are ``time.perf_counter_ns()``."""

    name: str
    id: int
    parent: int | None
    rid: int | None
    start: int
    end: int | None = None
    counts: dict[str, int] = dataclasses.field(default_factory=dict)

    def set(self, **counts: int) -> None:
        self.counts.update(counts)


class _Open:
    """A span being recorded: the context manager a span site enters."""

    __slots__ = ("span", "_recorder", "_range")

    def __init__(self, recorder: "Recorder", span: Span):
        self.span, self._recorder = span, recorder
        self._range = torch.profiler.record_function(span.name)

    def __enter__(self) -> Span:
        self._recorder._stack().append(self.span)
        self._range.__enter__()
        self.span.start = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._recorder._stack().pop()
        self._recorder._spans.append(self.span)
        return False


class _Null:
    """What a span site gets while recording is off: records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **counts: int) -> None:
        pass


NULL = _Null()


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Recorder:
    """A bounded buffer of spans, and the switch that turns recording on
    outside a profiler session."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._ids = itertools.count()
        self._local = threading.local()
        self.enabled = False

    def span(self, name: str, rid: int | None = None, **counts: int):
        """A context manager over one span of ``name``; it yields the
        :class:`Span` (or :data:`NULL`, which is false, when off)."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return NULL
        if _capturing():
            return NULL
        stack = self._stack()
        return _Open(self, Span(name, next(self._ids),
                                stack[-1].id if stack else None, rid, 0,
                                counts=counts))

    def record(self, name: str, start: int, end: int, rid: int | None = None,
               **counts: int) -> None:
        """Keep a span that has already ended (``start`` and ``end`` in
        ``perf_counter_ns``), as a child of the span open on this thread:
        a wait measured from a time the thread did not see, such as a
        request's submission. It enters no profiler range."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return
        stack = self._stack()
        self._spans.append(Span(name, next(self._ids),
                                stack[-1].id if stack else None, rid, start,
                                end, counts))

    def recorded(self) -> list[Span]:
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def _stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack


#: the process's recorder, which the engine and the trainer record into
RECORDER = Recorder()
span = RECORDER.span
record = RECORDER.record
recorded = RECORDER.recorded
clear = RECORDER.clear


def enable(on: bool = True) -> None:
    """Record outside a profiler session too (``on``), or only inside one."""
    RECORDER.enabled = on
