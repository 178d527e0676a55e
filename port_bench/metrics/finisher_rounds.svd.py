"""SVD finisher calls an answer pays for, each over a chunk of leaders
through its host read: the spans ``maus.refine_svd.round`` per traced
answer. None for a program without the span."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.refine_svd.round")
