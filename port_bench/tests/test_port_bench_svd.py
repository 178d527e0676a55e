"""The SVD cell, ``svd4096x2048.top16``, at a tiny size on the CPU: its files
found by name, a traced run that the reference judges sound and that reports
the ``.svd`` metrics a CPU trace can give, ``correct`` false under each fault
of an answer and under the control, and the readers of the program's new
spans reading None for a program that lacks them (the parent's). On the card
(``-m cuda``): a few seconds of the cell, sound, with every new metric read.
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import maus_tpu_torch.solver.api as api
import maus_tpu_torch.solver.candidate as candidate
from port_bench import mix, run as run_mod

from .conftest import REPO, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "svd4096x2048.top16"
SVD_METRICS = {m["name"]: m for m in BENCH["per_layer"] if CELL in m.get("workloads", ())}
# the device's metrics: none without a device trace
DEVICE = {n for n, m in SVD_METRICS.items() if m["source"] == "device_trace"}
# the spans this cell's readers read that a program before them lacks
NEW_SPANS = {"maus.svd.block_round": "block_round_s.svd",
             "maus.engine.capped": "capped.svd",
             "maus.refine_svd.round": "finisher_rounds.svd"}


def test_the_cell_is_made_of_new_files_found_by_name():
    _, cell, config, traffic = run_mod.load_cell(REPO, CELL)
    assert cell["chips"] == 1 and config["name"] == "svd_c64_4096x2048_t16"
    assert traffic == {"operand": "svd_pool", "call": "svd"}
    assert (config["m"], config["n"], config["num_candidates"], config["target_solutions"],
            config["tol"], config["max_iterations"]) == (4096, 2048, 32, 16, 1e-8, 100)
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert entry["reduced"] == [] and config["assumed"] == ["pool", "max_iterations"]
    assert "requires" not in config
    inputs = mix.load_module(REPO, "port_bench/inputs/svd_pool.py")
    small = dict(config, m=24, n=20, pool=1)
    pool = inputs.setup(small, traffic, 123, "cpu")
    A, b, info = inputs.operand(small, traffic, pool, 124, 0, "cpu")
    assert A.shape == (24, 20) and A.dtype == torch.complex64 and b is None
    assert info["sigma_top"].tolist() == [0.8 ** k for k in range(16)]
    # the rephased operand keeps the generator's singular values
    sig = torch.linalg.svdvals(A.to(torch.complex128))
    assert torch.allclose(sig, inputs.spectrum(small), atol=1e-6)
    assert set(SVD_METRICS) == {
        "entry_s.svd", "engine_s.svd", "iterations.svd", "block_round_s.svd",
        "capped.svd", "finish_s.svd", "finisher_rounds.svd", "finisher_solves.svd",
        "p4_roofline.svd", "device_idle.svd"}
    for m in SVD_METRICS.values():
        assert m["workloads"] == [CELL] and m["moves"] == "answer_s"
        assert callable(run_mod.load_reader(REPO, m["name"]).read)
    p4 = run_mod.load_reader(REPO, "p4_roofline.svd")
    eig = run_mod.load_reader(REPO, "p4_roofline.eig")
    assert (p4.KERNELS, p4.CALLS) == (eig.KERNELS, eig.CALLS)


def _traced(root, capsys, monkeypatch):
    seen, made = [], run_mod.Run

    def captured(*args):
        seen.append(made(*args))
        return seen[-1]

    monkeypatch.setattr(run_mod, "Run", captured)
    rc, line, err = run_cell(root, CELL, capsys, trace=1)
    assert rc == 0 and line["correct"] is True, err
    return line, seen[0]


def test_traced_run_is_sound_and_reports_the_svd_metrics(tiny_root, capsys, monkeypatch):
    line, run = _traced(tiny_root, capsys, monkeypatch)
    assert set(line["checks"]) == {"failed", "svd_resid", "svd_short"}
    assert set(line["metrics"]) == set(SVD_METRICS) - DEVICE
    got = {k: v["value"] for k, v in line["metrics"].items()}
    traced = [r["report"]["iterations"] for r in run.records
              if r["traced"] and r["report"] is not None]
    assert got["iterations.svd"] == pytest.approx(sum(traced) / len(traced))
    # a tiny operand's dynamic target is met before the cap
    capped = sum(1 for n in traced if n >= 100) / len(traced)
    assert got["capped.svd"] == pytest.approx(capped)
    assert got["finisher_solves.svd"] == 7 * got["finisher_rounds.svd"] > 0
    for name in set(got) - {"capped.svd"}:
        assert got[name] > 0, name
    assert not {k for k in got if not k.endswith(".svd")}


def _without_new_spans(monkeypatch):
    """The program as it was before the new spans: it neither declares nor
    opens them."""
    import maus_tpu_torch.utils.metrics as metrics

    monkeypatch.setattr(metrics, "SPANS", tuple(
        s for s in metrics.SPANS if s[0] not in NEW_SPANS))

    def span(name, _span=metrics.span):
        return metrics._NULL_SPAN if name in NEW_SPANS else _span(name)

    for mod in (api, candidate):
        monkeypatch.setattr(mod, "span", span)


def test_readers_of_undeclared_spans_read_none(tiny_root, capsys, monkeypatch):
    _without_new_spans(monkeypatch)
    line, _ = _traced(tiny_root, capsys, monkeypatch)
    assert set(line["metrics"]) == set(SVD_METRICS) - DEVICE - set(NEW_SPANS.values())


_final_dedup = api._final_dedup


def _faulty(alter):
    def dedup(cfg, s, r):
        return alter(*_final_dedup(cfg, s, r))
    return dedup


def _copy_of_best(s, r):
    """The triplet of the largest σ other than the best one's (the list is
    best first) replaced by a copy of the best, its residual kept."""
    victim = max(range(1, len(s)), key=lambda p: s[p][0])
    return [s[0] if p == victim else x for p, x in enumerate(s)], r


FAULTS = {
    # every σ moved by 1e-6, each triplet still claimed at its residual
    "sigma_moved": lambda s, r: ([(x + 1e-6, u, v) for x, u, v in s], r),
    # one triplet a copy of the best
    "copy_of_best": _copy_of_best,
    # half the triplets left out
    "half_dropped": lambda s, r: (s[::2], r[::2]),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_faulty_answer_is_not_correct(tiny_root, capsys, monkeypatch, fault):
    monkeypatch.setattr(api, "_final_dedup", _faulty(FAULTS[fault]))
    rc, line, err = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and line["correct"] is False, err
    assert {k for k, c in line["checks"].items() if c["value"] > c["limit"]} - {"failed"}


def test_a_step_that_returns_its_state_unchanged_is_not_correct(tiny_root, capsys,
                                                                monkeypatch):
    step = candidate.step_svd

    def frozen(cfg, A, pop, strat):
        return pop, step(cfg, A, pop, strat)[1]

    monkeypatch.setattr(candidate, "step_svd", frozen)
    rc, line, err = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and line["correct"] is False, err


def test_control_is_not_correct(tiny_root, capsys):
    rc, line, err = run_cell(tiny_root, CELL, capsys, control=True)
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["svd_resid"]["value"] > line["checks"]["svd_resid"]["limit"]


@pytest.mark.cuda
def test_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "port_bench", "--workload", CELL,
                          "--seed", str(2**31 + 103), "--seconds", "6", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == set(SVD_METRICS)
    assert line["metrics"]["capped.svd"]["value"] == 1.0
    assert line["metrics"]["iterations.svd"]["value"] == 100.0
