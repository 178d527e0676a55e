"""The window's seconds over the answers that reached their target, whatever
the cell's problem (host clock; a request that missed its target adds its
time and no answer)."""
from port_bench import readers


def read(run):
    return readers.seconds_per_answer(run)
