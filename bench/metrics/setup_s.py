"""Process start to the window's first step (host clock)."""


def read(run):
    return run.setup_s
