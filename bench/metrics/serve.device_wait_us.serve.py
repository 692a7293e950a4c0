"""Device idle inside the service's spans between its chunks' loop steps
(``serve.copy``, ``serve.deliver``, ``serve.pack``) over the traced
stretch, in microseconds a loop step: the card waiting on the raster's
copy, the clients' callbacks and harvests, and the packing of new
jobs."""
from bench.harness import spans


def read(run):
    if run.window.get("kind") != "serve":
        return None
    tl = spans.timeline(run)
    host = spans.named(tl or [], "serve.copy", "serve.deliver", "serve.pack")
    if not host:
        return None
    return spans.device_idle_us(run.trace, host) / run.trace.extra["steps"]
