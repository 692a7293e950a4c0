"""One minus the device's busy time a loop step (the union of the
device operations' intervals in the traced stretch, over its steps)
over the wall time a loop step of the same window's untraced steps, in
percent."""
from bench.harness import shapes


def read(run):
    tr = shapes.traced(run, "serve")
    if tr is None:
        return None
    step_s = shapes.untraced_step_s(run, tr)
    if step_s is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.extra["steps"] / step_s)
