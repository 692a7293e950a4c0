"""``stdp_dense_update``'s least time by its bytes and operations
(``counts/stdp_dense_update.py``) over its traced time a launch, in
percent."""
from bench.harness import common, shapes

KERNEL = r"stdp_dense_update_kernel"


def read(run):
    tr = shapes.traced(run, "sim")
    if tr is None or tr.count(KERNEL) == 0:
        return None
    s = shapes.sizes(run.cfg)
    nbytes, flops = common.counts("stdp_dense_update").work(
        columns=s["columns"], n=s["n"], tenants=tr.extra["tenants"])
    t = tr.total_us(KERNEL) * 1e-6 / tr.count(KERNEL)
    return shapes.share(shapes.bound_s(run, nbytes, flops), t)
