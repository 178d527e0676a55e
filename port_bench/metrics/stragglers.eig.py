"""Leaders that the working-dtype finisher rounds left above tol, taken on
by the complex128 round: the spans ``maus.eig.straggler`` per traced
answer; 0 where every pair reached tol in the standard rounds."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.eig.straggler")
