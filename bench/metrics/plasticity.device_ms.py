"""Device milliseconds a step in the two STDP kernels
(``stdp_dense_update``, ``stdp_remote_update``), from the device trace."""
from bench.harness import shapes

STDP = r"(stdp_dense_update|stdp_remote_update)_kernel"


def read(run):
    tr = shapes.traced(run, "sim")
    if tr is None or tr.count(STDP) == 0:
        return None
    return tr.total_us(STDP) * 1e-3 / shapes.steps(tr)
