"""Device microseconds a loop step in operations other than the
program's own kernels (PyTorch's small ops, copies, fills), from the
device trace."""
from bench.harness import shapes


def read(run):
    tr = shapes.traced(run, "sim")
    if tr is None:
        return None
    return tr.outside_us() / shapes.steps(tr)
