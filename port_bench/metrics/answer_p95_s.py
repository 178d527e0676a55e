"""The 95th percentile (nearest rank) of the latency of every request of
the window, whatever the cell's problem, host clock, s."""
from port_bench import readers


def read(run):
    return readers.percentile([r["latency_s"] for r in run.records], 95)
