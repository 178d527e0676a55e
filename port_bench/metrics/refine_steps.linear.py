"""Correction solves of certified refinement (``ops/refine.py``): the spans
``maus.refine.step`` per traced answer."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.refine.step")
