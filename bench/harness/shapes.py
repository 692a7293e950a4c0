"""Shapes and per-step quantities that several metric readers take from
a run: the configuration's sizes, and the traced stretch's steps and
spiking sources."""
from __future__ import annotations

from bench.reference.dpsnn import drive_rate, stencil

FUSED = r"fused_step(_cluster)?_kernel"


def sizes(cfg: dict) -> dict:
    st = stencil(cfg)
    n = cfg["neurons_per_column"]
    return dict(columns=cfg["grid_h"] * cfg["grid_w"], n=n,
                k=st.k_total, table=len(st.offsets) * n)


def traced(run, kind: str):
    """The run's trace when its window is of ``kind`` and the trace saw
    ``fused_step`` run (one launch a loop step), else None."""
    tr = run.trace
    if tr is None or run.window.get("kind") != kind:
        return None
    if tr.count(FUSED) == 0:
        return None
    return tr


def steps(tr) -> int:
    """Loop steps in the traced stretch: one ``fused_step`` a step."""
    return tr.count(FUSED)


def spiking_rows(tr) -> float:
    """Sources that spiked, a loop step, summed over the tenants."""
    return tr.extra["spikes"] / tr.extra["steps"]


def mean_rate(run) -> float:
    """Poisson events a neuron and step, over the mix's drive scales."""
    scales = run.mix.get("nu_scales") or [1.0]
    return sum(drive_rate(run.cfg, s) for s in scales) / len(scales)


def share(bound_s: float, time_s: float):
    """``bound_s`` over ``time_s`` in percent; None without a time."""
    if time_s <= 0:
        return None
    return 100.0 * bound_s / time_s


def bound_s(run, nbytes: float, flops: float, int_ops: float = 0.0) -> float:
    p = run.peaks
    return max(nbytes / p["bytes_per_s"],
               flops / p["f32_flops"] + int_ops / p["int32_ops"])


def untraced_step_s(run, tr):
    """Wall seconds a loop step over the window's steps outside the
    traced stretch (host clock; the profiler slows the host, not the
    device); None when the window had no such steps."""
    w = run.window
    steps = w["sim_steps" if w["kind"] == "sim" else "loop_steps"]
    steps -= tr.extra["steps"]
    wall = w["wall_s"] - tr.window_s
    if steps <= 0 or wall <= 0:
        return None
    return wall / steps
