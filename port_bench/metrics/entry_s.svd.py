"""Entry and diagnosis of an SVD answer (``solver/api.py``,
``solver/diagnose.py``): a request's latency less the report's ``timings``,
the mean over the answers, s."""
from port_bench import readers


def read(run):
    return readers.mean_entry(run)
