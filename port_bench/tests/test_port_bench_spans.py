"""The readers of the program's spans: the span arithmetic on hand-built
traces, and a tiny traced run of each cell on the CPU that reports the
span metrics, counts the engine's iterations and leaves the device's idle
metrics out."""
from __future__ import annotations

import json

import pytest

from port_bench import run as run_mod
from port_bench import spans, trace

from .conftest import CELLS, REPO, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["source"] in ("program_span", "program_counter")
                and m["name"] not in ("entry_s.linear", "engine_s.linear",
                                      "finish_s.linear")}
IDLE_METRICS = ("entry_idle_s.linear", "engine_idle_s.linear", "finish_idle_s.linear")


def _trace(device=(), host=(), start=0, end=100):
    return trace.Trace(sorted(device, key=lambda op: op[1]),
                       sorted(host, key=lambda op: op[1]), start, end, {})


def _run(tr, answers=1, untraced=0):
    rec = {"traced": True, "report": {"timings": {}, "iterations": 3}}
    quiet = {"traced": False, "report": {"timings": {}, "iterations": 3}}
    failed = {"traced": True, "report": None}
    return run_mod.Run({}, {}, {}, 1.0, 1.0,
                       [dict(rec) for _ in range(answers)] + [quiet] * untraced + [failed],
                       tr)


def test_idle_inside_a_span():
    tr = _trace(device=[("k1", 2, 4), ("k2", 6, 12)])
    busy = tr.busy_intervals()
    assert spans.idle_ns((0, 10), busy) == 4
    assert spans.idle_ns((3, 7), busy) == 2
    assert spans.idle_ns((20, 30), busy) == 10          # no device operation inside
    assert spans.idle_ns((5, 6), busy) == 1
    assert spans.idle_ns((2, 4), busy) == 0


def test_idle_per_answer_of_nested_spans_and_overlapping_kernels():
    host = [("maus.engine", 0, 50), ("maus.engine.iteration", 10, 20),
            ("maus.engine.iteration", 30, 40), ("maus.engine", 60, 90)]
    device = [("a", 12, 16), ("b", 14, 18), ("c", 35, 70)]
    run = _run(_trace(device, host), answers=2)
    # engine [0,50): busy [12,18) and [35,50) = 21 → idle 29; [60,90): busy
    # [60,70) → idle 20; two answers
    assert spans.idle_seconds_per_answer(run, "maus.engine") == pytest.approx(49e-9 / 2)
    # iterations [10,20): 6 busy → 4 idle; [30,40): 5 busy → 5 idle
    assert spans.idle_seconds_per_answer(run, "maus.engine.iteration") == \
        pytest.approx(9e-9 / 2)


def test_span_counts_and_times_per_answer():
    host = [("maus.engine.iteration", 0, 10), ("maus.engine.iteration", 20, 24),
            ("maus.engine.iteration", 30, 31), ("maus.factor", 1, 2),
            ("aten::mm", 2, 3), ("maus.engine.iteration", 150, 160)]   # outside
    run = _run(_trace(host=host), answers=3, untraced=4)
    assert spans.answers(run) == 3
    assert spans.count_per_answer(run, "maus.engine.iteration") == pytest.approx(1.0)
    assert spans.seconds_per_answer(run, "maus.engine.iteration") == \
        pytest.approx(15e-9 / 3)
    assert spans.mean_seconds(run, "maus.engine.iteration") == pytest.approx(5e-9)
    assert spans.count_per_answer(run, "maus.factor") == pytest.approx(1 / 3)
    # no device operation: no idle value
    assert spans.idle_seconds_per_answer(run, "maus.engine.iteration") is None


@pytest.mark.parametrize("read", [spans.count_per_answer, spans.seconds_per_answer,
                                  spans.mean_seconds, spans.idle_seconds_per_answer])
def test_a_renamed_span_or_no_trace_reads_none(read):
    tr = _trace(device=[("k", 0, 5)], host=[("maus.engine.step", 0, 10)])
    assert read(_run(tr), "maus.engine.step_renamed") is None
    assert read(_run(None), "maus.engine.iteration") is None


def test_a_declared_count_that_never_ran_reads_zero(monkeypatch):
    from maus_tpu_torch.utils import metrics

    tr = _trace(host=[("maus.engine.iteration", 0, 10)])
    assert spans.count_per_answer(_run(tr), "maus.refine.step") == 0.0
    assert spans.count_per_answer(_run(tr, answers=0), "maus.refine.step") is None
    monkeypatch.delattr(metrics, "SPANS")       # a program without the spans
    assert spans.count_per_answer(_run(tr), "maus.refine.step") is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(tiny_root, capsys, monkeypatch, cell):
    seen, made = [], run_mod.Run

    def captured(*args):
        seen.append(made(*args))
        return seen[-1]

    monkeypatch.setattr(run_mod, "Run", captured)
    rc, line, err = run_cell(tiny_root, cell, capsys, trace=1)
    assert rc == 0 and line["correct"] is True, err
    (run,) = seen
    mine = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]}
    assert mine <= set(line["metrics"]), err
    # on the CPU refinement starts at tol, and the probe builds R⁻¹ only on a
    # CUDA operand of N ≥ 1024 (``ops/batched_solve._want_rinv``)
    zero_here = ("refine_steps.linear", "cond_rinv.linear")
    for name in mine:
        assert line["metrics"][name]["value"] > 0 or name in zero_here, name
    assert not set(IDLE_METRICS) & set(line["metrics"])          # the CPU: no device trace
    traced = [r["report"]["iterations"] for r in run.records
              if r["traced"] and r["report"] is not None]
    assert traced
    assert spans.count_per_answer(run, "maus.engine.iteration") == \
        pytest.approx(sum(traced) / len(traced))
    assert line["metrics"]["factorizations.linear"]["value"] >= 1
    # the harness's older per-layer metrics are still there
    assert {"entry_s.linear", "engine_s.linear", "finish_s.linear"} <= set(line["metrics"])
