"""Finisher calls an eig answer pays for, each over a chunk of leaders
through its host read: the spans ``maus.refine_eig.round`` per traced
answer."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.refine_eig.round")
