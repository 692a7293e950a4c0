"""Tenant-steps the server completed in the window over the window's
wall time (host clock)."""


def read(run):
    w = run.window
    if w.get("kind") != "serve" or w["wall_s"] <= 0:
        return None
    return w["tenant_steps"] / w["wall_s"]
