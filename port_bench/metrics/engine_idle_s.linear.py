"""The device's idle seconds inside the span ``maus.engine`` (the engine
phase) per traced answer: the span less its overlap with the union of the
device's operations, s."""
from port_bench import spans


def read(run):
    return spans.idle_seconds_per_answer(run, "maus.engine")
