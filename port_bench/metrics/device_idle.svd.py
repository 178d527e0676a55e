"""The share of the traced window in which no device operation ran (the
union of the profiler's device intervals), %."""
from port_bench import readers


def read(run):
    return readers.device_idle(run)
