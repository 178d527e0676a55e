"""The 95th percentile (nearest rank) of the latency of every linear
request of the window, host clock, s."""
from port_bench import readers


def read(run):
    return readers.percentile([r["latency_s"] for r in run.records], 95)
