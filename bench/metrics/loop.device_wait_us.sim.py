"""Device idle inside the simulation loop's spans (``sim.*``,
``step.*``, ``plasticity.*``) over the traced stretch, in microseconds a
step: the card waiting on the host while the loop ran."""
from bench.harness import spans


def read(run):
    if run.window.get("kind") != "sim":
        return None
    tl = spans.timeline(run)
    loop = spans.named(tl or [], "sim.", "step.", "plasticity.")
    if not loop:
        return None
    return spans.device_idle_us(run.trace, loop) / run.trace.extra["steps"]
