"""The allocator's peak over the whole process (set-up included) over
the configuration's equivalent synapses (local, remote, external)."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / run.synapses
