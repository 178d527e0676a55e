"""The shared factorization without an explicit Q (``ops/batched_solve.py``:
on the card for N ≥ 1024, geqrf's reflectors applied blockwise in every
solve): the spans ``maus.factor.implicit_q`` per traced answer; equal to
``factorizations.linear`` where every shared factorization takes that form."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.factor.implicit_q")
