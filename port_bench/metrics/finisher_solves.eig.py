"""Reads of a finisher chunk's LU factors an eig answer pays for, one per
solve of one or two columns: the spans ``maus.refine_eig.solve`` per traced
answer. None for a program that does not declare the span."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.refine_eig.solve")
