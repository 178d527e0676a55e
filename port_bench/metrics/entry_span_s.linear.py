"""Entry and diagnosis from inside the program: the seconds of the span
``maus.entry`` (``MausSolver``'s constructor: staging, the structure and
condition probes, the configuration, staging of b) per traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.entry")
