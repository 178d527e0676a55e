"""The engine's start (``solver/evolve.py``): the population, the first Ψ
and the shared QR + R⁻¹, through the first stop check; the seconds of the
span ``maus.engine.init`` per traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.engine.init")
