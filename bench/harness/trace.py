"""The device trace of a traced run: CUDA activity only, from
``torch.profiler``, read back from its Chrome trace.

A traced run profiles a bounded stretch of its window (:class:`Tracer`),
and the readers under ``bench/metrics/`` take their numbers from the
device operations it recorded: each an interval ``(name, start_us,
dur_us)`` of a kernel, a copy or a fill.
"""
from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the device-side names of the program's own kernels
PORT_KERNEL_RE = re.compile(
    r"(lif_step|synapse_matmul|ell_gather|fused_step|stdp_dense_update"
    r"|keyed_drive|stdp_remote_update)(_cluster)?_kernel")


@dataclass
class Trace:
    events: list               # [(name, start_us, dur_us)] sorted by start
    window_s: float            # host wall time of the traced stretch
    extra: dict = field(default_factory=dict)   # the driver's counts

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        intervals."""
        return sum(b - a for a, b in merged(self.events)) * 1e-6

    def total_us(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.events if rx.search(n))

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.events if rx.search(n))

    def outside_us(self) -> float:
        """Device time in operations that are not the program's kernels."""
        return sum(d for n, _, d in self.events
                   if not PORT_KERNEL_RE.search(n))


def merged(events) -> list:
    """The union of the events' intervals as sorted disjoint
    ``(start_us, end_us)`` pairs."""
    out = []
    for _, s, d in sorted(events, key=lambda e: e[1]):
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def short(name: str) -> str:
    """A device operation's name without its template and arguments."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"^void\s+", "", base).split("(")[0].split("<")[0]
    return base.split("::")[-1].strip()[:80] or name[:80]


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the operations on either side of them (what the host
    was doing between them), each summed by name."""
    ops: dict = {}
    for n, _, d in events:
        ops[short(n)] = ops.get(short(n), 0.0) + d * 1e-6
    gaps: dict = {}
    evs = sorted(events, key=lambda e: e[1])
    end, prev = None, None
    for n, s, d in evs:
        if end is not None and s > end:
            key = f"{short(prev)} -> {short(n)}"
            gaps[key] = gaps.get(key, 0.0) + (s - end) * 1e-6
        if end is None or s + d >= end:
            end, prev = s + d, n
    def best(x):
        return [[k, v] for k, v in sorted(x.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": best(ops), "idle_gaps": best(gaps)}


def read_chrome(path: Path) -> list:
    with open(path) as f:
        data = json.load(f)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    out = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
           for e in evs if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    return sorted(out, key=lambda e: e[1])


class Tracer:
    """``start()`` ... ``stop()`` around a stretch of the window: CUDA
    activity only, so the host's own work is not slowed by the tracing
    of every call. The Chrome trace goes to a fixed file under the
    checkout's ``build/``."""

    def __init__(self, torch, out: Path):
        self.torch, self.out = torch, out
        self.prof = None
        self.t0 = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, **extra) -> Trace:
        self.torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.out))
        self.prof = None
        return Trace(events=read_chrome(self.out), window_s=window,
                     extra=extra)
