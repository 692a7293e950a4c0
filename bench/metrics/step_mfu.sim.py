"""The whole loop step's share of the chip's peak: the least time of the
work the step needs (``counts/step.py``: the configuration's shapes
and the traced steps' spikes) over the wall time a loop step of the
window's untraced steps, in percent."""
from bench.harness import common, shapes


def read(run):
    tr = shapes.traced(run, "sim")
    if tr is None:
        return None
    s = shapes.sizes(run.cfg)
    nbytes, flops, int_ops = common.counts("step").work(
        columns=s["columns"], n=s["n"], k_total=s["k"],
        tenants=tr.extra["tenants"], spikes=shapes.spiking_rows(tr),
        stdp=bool(tr.extra["stdp"]), lam=shapes.mean_rate(run),
        ops_per_threefry=run.peaks["ops_per_threefry"])
    t = shapes.untraced_step_s(run, tr)
    if t is None:
        return None
    return shapes.share(shapes.bound_s(run, nbytes, flops, int_ops), t)
