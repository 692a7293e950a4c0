"""How long a job waited for a slot: the mean duration, from ``submit``
to its admission in ``_pack``, of the ``serve.queue`` spans that end
inside the traced stretch, in milliseconds."""
from bench.harness import spans


def read(run):
    if run.window.get("kind") != "serve":
        return None
    tl = spans.timeline(run)
    if tl is None:
        return None
    lo, hi = spans.stretch(run.trace)
    waits = [s.end_us - s.start_us for s in tl
             if s.name == "serve.queue" and lo <= s.end_us <= hi]
    if not waits:
        return None
    return sum(waits) / len(waits) * 1e-3
