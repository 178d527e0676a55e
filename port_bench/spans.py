"""The arithmetic of the per-layer readers that read the program's own spans.

The program opens named spans at its layer boundaries
(``maus_tpu_torch.utils.metrics.SPANS``) while a profiler runs; each is a
CPU operation on the profiler's clock, so it lands in the trace's host
operations beside the device's. A span is matched by its literal name: a
renamed or missing span reads None, as a renamed call does in ``trace.py``;
a count reads 0 instead where the program declares the span in its
``SPANS`` and none ran (refinement that had nothing left to do). Only spans
inside the traced window (the requests' own spans) count.

"Per answer" divides by the traced requests that returned a report. Every
function returns None without a trace.
"""
from __future__ import annotations

import bisect


def answers(run) -> int:
    """The traced requests that returned a report."""
    return sum(1 for r in run.records if r["traced"] and r["report"] is not None)


def intervals(run, name: str):
    """The ``(start_ns, end_ns)`` of every span ``name`` inside the traced
    window, in time order; None without a trace or without such a span."""
    tr = run.trace
    if tr is None:
        return None
    found = [(s, e) for n, s, e in tr.host_ops
             if n == name and s >= tr.start_ns and e <= tr.end_ns]
    return found or None


def _per_answer(run, name: str, value):
    spans, n = intervals(run, name), answers(run)
    if spans is None or n == 0:
        return None
    return sum(value(s, e) for s, e in spans) / n


def seconds_per_answer(run, name: str):
    """The seconds inside span ``name``, summed over the traced window, per
    answer."""
    return _per_answer(run, name, lambda s, e: (e - s) / 1e9)


def declared(name: str) -> bool:
    """Whether the program under test declares the span ``name``."""
    from maus_tpu_torch.utils import metrics

    return name in {n for n, _ in getattr(metrics, "SPANS", ())}


def count_per_answer(run, name: str):
    """The spans ``name`` in the traced window per answer."""
    if run.trace is not None and answers(run) and intervals(run, name) is None \
            and declared(name):
        return 0.0
    return _per_answer(run, name, lambda s, e: 1)


def mean_seconds(run, name: str):
    """The mean seconds of one span ``name``."""
    spans = intervals(run, name)
    if spans is None:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e9


def idle_ns(span: tuple, busy: list, ends: list | None = None) -> int:
    """The nanoseconds of ``span`` that no interval of ``busy`` (disjoint,
    in time order, as ``Trace.busy_intervals`` gives them) covers; ``ends``,
    the intervals' ends, spares recomputing them span after span."""
    s, e = span
    ends = [b[1] for b in busy] if ends is None else ends
    i, covered = bisect.bisect_right(ends, s), 0
    while i < len(busy) and busy[i][0] < e:
        covered += min(e, busy[i][1]) - max(s, busy[i][0])
        i += 1
    return (e - s) - covered


def idle_seconds_per_answer(run, name: str):
    """The device's idle seconds inside span ``name`` per answer: each span's
    length less its overlap with the union of the device's operations. None
    where the trace holds no device operation (a CPU run)."""
    if run.trace is None or not run.trace.device_ops:
        return None
    busy = run.trace.busy_intervals()
    ends = [b[1] for b in busy]
    return _per_answer(run, name, lambda s, e: idle_ns((s, e), busy, ends) / 1e9)
