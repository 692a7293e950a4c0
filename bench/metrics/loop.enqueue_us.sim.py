"""The host's time to issue one simulation step: the mean duration of the
traced segment's ``sim.step`` spans (``core/simulation.py::run``), in
microseconds."""
from bench.harness import spans


def read(run):
    if run.window.get("kind") != "sim":
        return None
    tl = spans.timeline(run)
    steps = [s for s in tl or [] if s.name == "sim.step"]
    if not steps:
        return None
    return sum(s.end_us - s.start_us for s in steps) / len(steps)
