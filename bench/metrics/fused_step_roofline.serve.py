"""``fused_step``'s least time by its bytes and operations
(``counts/fused_step.py``, at the traced steps' spiking sources) over
its traced time a launch, in percent."""
from bench.harness import common, shapes


def read(run):
    tr = shapes.traced(run, "serve")
    if tr is None:
        return None
    launches = shapes.steps(tr)
    s = shapes.sizes(run.cfg)
    stdp = bool(tr.extra["stdp"])
    nbytes, flops = common.counts("fused_step").work(
        columns=s["columns"], n=s["n"], k=s["k"], table=s["table"],
        tenants=tr.extra["tenants"], spiking_rows=shapes.spiking_rows(tr),
        stdp=stdp, own_weights=stdp and tr.extra["tenants"] > 1)
    t = tr.total_us(shapes.FUSED) * 1e-6 / launches
    return shapes.share(shapes.bound_s(run, nbytes, flops), t)
