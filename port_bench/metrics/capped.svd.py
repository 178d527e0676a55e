"""SVD answers whose engine ran into ``max_iterations`` with its stop
condition unmet: the spans ``maus.engine.capped`` per traced answer (1.0
when every answer runs to its cap). None for a program without the span."""
from port_bench import spans


def read(run):
    return spans.count_per_answer(run, "maus.engine.capped")
