"""The program's spans (``repro_torch.runtime.spans``) on the device
trace's timeline, for the readers of the ``loop`` and ``service``
layers.

The program records spans while a ``torch.profiler`` session is active,
so a traced run holds them for its traced stretch (and for set-up's
profiler warm-up). :func:`timeline` maps their Unix-epoch times onto the
trace's clock (its events' ``ts`` are microseconds after the trace's
``baseTimeNanoseconds``) and keeps those that overlap the traced stretch,
from its first device operation to the end of its last. A program
without spans, or a run without a trace, gives None.
"""
from __future__ import annotations

import importlib
import json
from typing import NamedTuple

from bench.harness import trace as tracing
from bench.harness.common import ROOT

# where bench/run.py's tracer writes the traced stretch's Chrome trace
TRACE_FILE = ROOT / "build" / "bench" / "trace.json"


class Span(NamedTuple):
    name: str
    start_us: float          # on the trace's clock
    end_us: float
    id: int
    parent: int | None
    attrs: dict


def program_spans() -> list | None:
    """The spans the program recorded in this process, or None when the
    program records none."""
    try:
        spans = importlib.import_module("repro_torch.runtime.spans")
    except ImportError:
        return None
    return spans.recorded()


def base_time_ns() -> int | None:
    """The traced stretch's Chrome trace's ``baseTimeNanoseconds``, or
    None."""
    try:
        with open(TRACE_FILE) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    base = data.get("baseTimeNanoseconds") if isinstance(data, dict) else None
    return None if base is None else int(base)


def timeline(run) -> list | None:
    """The program's spans that overlap ``run``'s traced stretch, on the
    trace's clock, in the order they ended; None without a trace, its
    base time, or spans in it."""
    tr = run.trace
    if tr is None or not tr.events:
        return None
    recorded = program_spans()
    base = base_time_ns()
    if not recorded or base is None:
        return None
    lo, hi = stretch(tr)
    out = [Span(s.name, (s.start_ns - base) * 1e-3, (s.end_ns - base) * 1e-3,
                s.id, s.parent, s.attrs) for s in recorded]
    out = [s for s in out if s.end_us >= lo and s.start_us <= hi]
    return out or None


def stretch(tr) -> tuple[float, float]:
    """The traced stretch: its first device operation's start and its
    last one's end, on the trace's clock."""
    return tr.events[0][1], max(s + d for _, s, d in tr.events)


def named(spans: list, *prefixes: str) -> list:
    return [s for s in spans if s.name.startswith(prefixes)]


def device_idle_us(tr, spans: list) -> float:
    """Microseconds in which no device operation of ``tr`` ran, inside
    the traced stretch and inside the union of ``spans``' intervals."""
    busy = tracing.merged(tr.events)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    inside = tracing.merged([("", s.start_us, s.end_us - s.start_us)
                             for s in spans])
    total, j = 0.0, 0
    for a, b in gaps:
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < b:
            total += min(b, inside[k][1]) - max(a, inside[k][0])
            k += 1
    return total
