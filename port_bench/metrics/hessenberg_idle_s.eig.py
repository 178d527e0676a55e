"""The device's idle seconds inside the span ``maus.setup`` (the Hessenberg
reduction, one GEMV a reflector launched from the host) per traced answer:
the span less its overlap with the union of the device's operations, s."""
from port_bench import spans


def read(run):
    return spans.idle_seconds_per_answer(run, "maus.setup")
