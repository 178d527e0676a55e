"""The SVD finisher (``MausSolver._refine_svd``, ``ops/refine_eig.
refine_svd_triplets``: per chunk of leaders the Gram G = AᴴA, a batched LU
of G − σ²I + ψI by P4, FP64 Newton steps): the seconds of the span
``maus.finish`` per traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.finish")
