"""Wall seconds of the whole window over the simulated seconds of the
steps it completed (host clock)."""


def read(run):
    w = run.window
    if w.get("kind") != "sim" or not w.get("sim_steps"):
        return None
    return w["wall_s"] / (w["sim_steps"] * w["dt_ms"] * 1e-3)
