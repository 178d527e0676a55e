"""The condition probe (``solver/diagnose.py``: one working-dtype QR,
power and inverse iterations with complex128 refinement solves): the
seconds of the span ``maus.diagnose.cond`` per traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.diagnose.cond")
