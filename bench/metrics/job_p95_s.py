"""The 95th percentile (nearest rank) of the time from ``submit`` to
the ``JobResult`` over every job submitted in the window, those still
running at its close included with the time they took (host clock)."""
from bench.harness.common import percentile


def read(run):
    w = run.window
    if w.get("kind") != "serve" or not w.get("latencies_s"):
        return None
    return percentile(w["latencies_s"], 95)
