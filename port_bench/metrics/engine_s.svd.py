"""The engine loop of an SVD answer (``solver/evolve.py``,
``candidate.step_svd``: a block round and a damped step a slot an
iteration, leader election on the host): the seconds of the span
``maus.engine`` per traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.engine")
