"""The condition probe's explicit R⁻¹ (``solver/diagnose.py``: built on the
card for N ≥ 1024, where each working solve of the inverse iteration is two
matrix-vector products): the spans ``maus.diagnose.cond.rinv`` per traced
answer; 1.0 where every probe takes that form."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.diagnose.cond.rinv")
