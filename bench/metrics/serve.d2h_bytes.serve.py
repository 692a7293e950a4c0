"""Bytes copied from the card to the host a tenant-step: the ``bytes`` of
the traced stretch's ``serve.copy`` spans over the ``tenant_steps`` of
its ``serve.chunk`` spans (``launch/serve.py``)."""
from bench.harness import spans


def read(run):
    if run.window.get("kind") != "serve":
        return None
    tl = spans.timeline(run) or []
    copied = sum(s.attrs.get("bytes", 0) for s in tl
                 if s.name == "serve.copy")
    steps = sum(s.attrs.get("tenant_steps", 0) for s in tl
                if s.name == "serve.chunk")
    if not copied or not steps:
        return None
    return copied / steps
