"""The SVD step's block rounds (``candidate.step_svd``: the thin QR of
A·Vᵀ, the projection, the thin QR of its adjoint, the small SVD, the Ritz
products): the seconds of the span ``maus.svd.block_round`` per traced
answer, s. None for a program without the span."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.svd.block_round")
