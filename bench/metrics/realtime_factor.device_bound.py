"""``realtime_factor`` again, in the cells where the device sets the
pace (under a tenth of a step idle): their runs spread by well under a
percent where the host-bound g24.static spreads by several, so this
metric holds them to a bound of their own (host clock)."""
from bench.harness import common


def read(run):
    return common.metric_reader("realtime_factor").read(run)
