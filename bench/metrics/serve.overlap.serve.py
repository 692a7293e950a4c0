"""How often the service delivered a chunk while the card already had
the next one: the share of the traced stretch's ``serve.deliver`` spans
whose ``overlapped`` attribute is 1, in %. A span without the attribute
counts as 0, as does a program that delivers each chunk before it
enqueues the next (``launch/serve.py``)."""
from bench.harness import spans


def read(run):
    if run.window.get("kind") != "serve":
        return None
    delivered = spans.named(spans.timeline(run) or [], "serve.deliver")
    if not delivered:
        return None
    ahead = sum(1 for s in delivered if s.attrs.get("overlapped", 0) == 1)
    return 100.0 * ahead / len(delivered)
