"""The arithmetic that the per-layer readers in ``port_bench/metrics/`` share.

A reader takes the finished run (:class:`port_bench.run.Run`) and returns a
number, or None where its run holds nothing to read: no answer, no trace, no
call or launch of its kernel. Means over the program's own timings are taken
over the requests that ran outside the profiler, where there are any, so
that the profiler's cost stays out of them.
"""
from __future__ import annotations

import math


def _requests(run) -> list:
    done = [r for r in run.records if r["report"] is not None]
    quiet = [r for r in done if not r["traced"]]
    return quiet or done


def mean_timing(run, key: str):
    """Mean of ``SolutionReport.timings[key]`` over the answers, s."""
    vals = [r["report"]["timings"][key] for r in _requests(run)
            if key in (r["report"]["timings"] or {})]
    return sum(vals) / len(vals) if vals else None


def mean_entry(run):
    """Mean of the request's latency less the report's timings, s: staging,
    diagnosis and the report's assembly."""
    vals = [r["latency_s"] - sum((r["report"]["timings"] or {}).values())
            for r in _requests(run)]
    return sum(vals) / len(vals) if vals else None


def mean_iterations(run):
    vals = [r["report"]["iterations"] for r in _requests(run)]
    return sum(vals) / len(vals) if vals else None


def roofline(run, kernels, call: str, bound_s):
    """100 × the summed bounds of the traced calls of ``call`` over the
    device seconds of the operations named in ``kernels``, %."""
    if run.trace is None:
        return None
    calls = run.trace.calls.get(call, [])
    secs, launches = run.trace.kernel_seconds(kernels)
    if not calls or not launches or secs <= 0:
        return None
    return 100.0 * sum(bound_s(c) for c in calls) / secs


def device_idle(run):
    """The share of the traced window in which no device operation ran, %."""
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def seconds_per_answer(run):
    """The window's seconds over the answers that reached their target."""
    done = sum(1 for r in run.records if not r["failed"])
    return run.window_s / done if done else None


def percentile(values: list, q: float):
    """The nearest-rank ``q``-th percentile: the smallest value with at least
    q% of the values at or below it."""
    if not values:
        return None
    ranked = sorted(values)
    return ranked[max(1, math.ceil(q / 100 * len(ranked))) - 1]
