"""Engine iterations an SVD answer takes: the spans
``maus.engine.iteration`` per traced answer."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.engine.iteration")
