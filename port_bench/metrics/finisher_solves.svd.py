"""Reads of a finisher chunk's LU factors an SVD answer pays for, one per
solve (LS): the spans ``maus.refine_eig.solve`` per traced answer, 7 a
finisher call."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.refine_eig.solve")
