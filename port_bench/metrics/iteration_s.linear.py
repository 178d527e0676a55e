"""One engine iteration (``solver/evolve.py``): the step and the stop check
after it; the mean seconds of one span ``maus.engine.iteration``, s."""
from port_bench import spans


def read(run):
    return spans.mean_seconds(run, "maus.engine.iteration")
