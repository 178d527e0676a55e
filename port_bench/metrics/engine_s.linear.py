"""The engine loop (``solver/evolve.py``, ``candidate.py``, ``strategy.py``):
``SolutionReport.timings["engine_s"]``, the mean over the answers, s."""
from port_bench import readers


def read(run):
    return readers.mean_timing(run, "engine_s")
