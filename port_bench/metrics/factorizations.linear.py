"""Shared factorizations an answer pays for: the engine's at init and on
each Ψ rung, and refinement's fresh QR when the carried one is not reused;
the spans ``maus.factor`` per traced answer."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.factor")
