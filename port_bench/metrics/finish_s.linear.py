"""Certified refinement (``ops/refine.py``, K1):
``SolutionReport.timings["finish_s"]``, the mean over the answers, s."""
from port_bench import readers


def read(run):
    return readers.mean_timing(run, "finish_s")
