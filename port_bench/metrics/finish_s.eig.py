"""The eigenpair finishers (``ops/refine_eig.py``: per chunk of leaders a
batched LU, P4, and FP64 Newton steps): the seconds of the span
``maus.finish`` per traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.finish")
