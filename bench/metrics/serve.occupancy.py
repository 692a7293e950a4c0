"""The server's own counters over the window: tenant-steps over loop
steps times slots, in percent (traced runs)."""


def read(run):
    w = run.window
    if run.trace is None or w.get("kind") != "serve" or not w["loop_steps"]:
        return None
    return 100.0 * w["tenant_steps"] / (w["loop_steps"] * w["slots"])
