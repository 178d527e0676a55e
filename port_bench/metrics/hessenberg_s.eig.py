"""The Hessenberg reduction A = QHQᴴ (``ops/hessenberg.py``): the seconds of
the span ``maus.setup`` (evolve's shared form, through a synchronise) per
traced answer, s."""
from port_bench import spans


def read(run):
    return spans.seconds_per_answer(run, "maus.setup")
