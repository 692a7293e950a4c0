"""Spans of the host's work, on the clock of ``torch.profiler``'s trace.

A span is one stretch of host code: its name, its start and end, the
span it ran inside or that caused it (its parent), and a few attributes (counts such as
``bytes``, a request's ``job_id``). The simulation loop
(``core/simulation.py``, ``core/network.py``) and the service
(``launch/serve.py``, ``core/batched.py``) open them where their work
happens, so that each stretch of a device trace in which the card waited
can be put down to the host code that left it waiting.

Spans are recorded only while a ``torch.profiler`` session is active;
there is no other switch. Off, :func:`span` costs one check and returns
a shared object that does nothing: no allocation, no clock read. On, a
span reads ``time.perf_counter_ns()`` at each end and is kept in memory
(the last ``MAX_SPANS``). No span touches the card: nothing here
synchronises it or reads a device value.

:func:`recorded` returns the spans with their times in Unix-epoch
nanoseconds, the clock of the profiler's Chrome trace (its event ``ts``
plus ``baseTimeNanoseconds / 1000`` is epoch microseconds)::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        simulation.run(cfg, params, state, 100)
    for s in spans.recorded():
        print(s.name, s.start_ns, s.end_ns, s.parent, s.attrs)
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

MAX_SPANS = 2 ** 20

_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
# perf_counter_ns + _EPOCH_NS is Unix-epoch time: one pair per process
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()
_ids = itertools.count(1)
_spans: deque = deque(maxlen=MAX_SPANS)


class _Open(threading.local):
    """The ids of a thread's open spans, innermost last."""

    def __init__(self):
        self.ids = []


_open = _Open()


class Span(NamedTuple):
    name: str
    start_ns: int           # Unix epoch
    end_ns: int
    id: int
    parent: int | None      # the id of the span it ran inside
    attrs: dict


class _Off:
    """What :func:`span` returns while no profiler runs."""
    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name: str, attrs: dict, parent: int | None):
        self.name, self.attrs, self.parent = name, attrs, parent

    def __enter__(self):
        stack = _open.ids
        self.id = next(_ids)
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self.id)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _open.ids.pop()
        _spans.append((self.name, self.start, end, self.id, self.parent,
                       self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a count it produced)."""
        self.attrs.update(attrs)


def span(name: str, *, parent: int | None = None, **attrs):
    """A context manager that records the code it encloses as span
    ``name`` with ``attrs`` while a ``torch.profiler`` session is active,
    and is :data:`OFF` otherwise. ``with span(...) as s: s.set(k=v)``
    adds attributes on the way; ``s.id`` is its id (None when off). Its
    parent is the innermost open span, or ``parent``: the id of a span,
    closed by now, whose work this one finishes."""
    if not _enabled():
        return OFF
    return _On(name, attrs, parent)


def emit(name: str, start_ns: int, *, parent: int | None = None,
         **attrs) -> None:
    """Record a span that started at ``start_ns`` (``perf_counter_ns``)
    and ends now, while a profiler session is active: a stretch with no
    code of its own around it, such as a job's wait in a queue, or one
    that other spans interleave, such as a copy from its enqueue to the
    end of the wait for it. Its parent is ``parent``, if given."""
    if _enabled():
        _spans.append((name, start_ns, _clock(), next(_ids), parent, attrs))


def recorded() -> list[Span]:
    """The spans recorded so far (the last ``MAX_SPANS``), in the order
    they ended, with their times in Unix-epoch nanoseconds."""
    return [Span(n, s + _EPOCH_NS, e + _EPOCH_NS, i, p, a)
            for n, s, e, i, p, a in list(_spans)]


def clear() -> None:
    """Forget the spans recorded so far."""
    _spans.clear()
