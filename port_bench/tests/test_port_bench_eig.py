"""The general eig cell, ``eig4096.general``, at a tiny size on the CPU: its
files found by name, its traced run reporting the ``.eig`` metrics that a
CPU trace can give, and ``correct`` false under the eig-only fault of a
duplicated pair."""
from __future__ import annotations

import json

import pytest

import maus_tpu_torch.solver.api as api
from port_bench import mix, run as run_mod

from .conftest import REPO, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "eig4096.general"
EIG_METRICS = {m["name"]: m for m in BENCH["per_layer"] if CELL in m.get("workloads", ())}
# the device's metrics: none without a device trace
DEVICE = {n for n, m in EIG_METRICS.items() if m["source"] == "device_trace"}


def test_the_cell_is_made_of_new_files_found_by_name():
    _, cell, config, traffic = run_mod.load_cell(REPO, CELL)
    assert cell["chips"] == 1 and config["name"] == "eig_c64_n4096_t16"
    assert traffic == {"operand": "ginibre", "call": "eig"}
    assert (config["n"], config["num_candidates"], config["target_solutions"],
            config["tol"], config["max_iterations"]) == (4096, 32, 16, 1e-8, 200)
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert entry["reduced"] == [] and config["assumed"] == ["num_candidates"]
    inputs = mix.load_module(REPO, "port_bench/inputs/ginibre.py")
    A, b, info = inputs.operand({"n": 16}, traffic, None, 123, 0, "cpu")
    assert A.shape == (16, 16) and b is None and info == {}
    assert set(EIG_METRICS) == {
        "entry_s.eig", "hessenberg_s.eig", "hessenberg_idle_s.eig", "engine_s.eig",
        "iterations.eig", "finish_s.eig", "finisher_rounds.eig", "stragglers.eig",
        "k2_roofline.eig", "p4_roofline.eig", "device_idle.eig"}
    for m in EIG_METRICS.values():
        assert m["workloads"] == [CELL] and m["moves"] == "answer_s"
        assert callable(run_mod.load_reader(REPO, m["name"]).read)


def test_traced_run_reports_the_eig_metrics(tiny_root, capsys, monkeypatch):
    seen, made = [], run_mod.Run

    def captured(*args):
        seen.append(made(*args))
        return seen[-1]

    monkeypatch.setattr(run_mod, "Run", captured)
    rc, line, err = run_cell(tiny_root, CELL, capsys, trace=1)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["metrics"]) == set(EIG_METRICS) - DEVICE, err
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["stragglers.eig"] == 0.0        # an ordinary operand
    for name in set(got) - {"stragglers.eig"}:
        assert got[name] > 0, name
    (run,) = seen
    traced = [r["report"]["iterations"] for r in run.records
              if r["traced"] and r["report"] is not None]
    assert got["iterations.eig"] == pytest.approx(sum(traced) / len(traced))
    assert not {k for k in got if k.endswith(".linear")}


def _duplicated(f):
    """Every returned pair a copy of the best one, each still claimed at its
    residual: the program's own count says the target is met."""
    def dedup(cfg, s, r):
        s, r = f(cfg, s, r)
        return [s[0]] * len(s), [r[0]] * len(r)
    return dedup


def test_a_duplicated_pair_is_not_correct(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(api, "_final_dedup", _duplicated(api._final_dedup))
    rc, line, err = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] == 0
    assert line["checks"]["eig_short"]["value"] > 0
    assert line["checks"]["eig_resid"]["value"] <= line["checks"]["eig_resid"]["limit"]


def test_a_program_without_the_straggler_round_cannot_run_the_cell(tiny_root, capsys,
                                                                    monkeypatch):
    """The configuration's guarantee rests on the complex128 straggler round:
    a program that does not declare it is refused in set-up, before any
    request, with no result line."""
    import maus_tpu_torch.utils.metrics as metrics

    _, _, config, _ = run_mod.load_cell(REPO, CELL)
    assert config["requires"] == ["maus.eig.straggler"]
    served = []
    monkeypatch.setattr(mix.Mix, "serve", lambda self, req, control=False:
                        served.append(req))
    monkeypatch.setattr(metrics, "SPANS", tuple(
        s for s in metrics.SPANS if s[0] != "maus.eig.straggler"))
    with pytest.raises(SystemExit) as exc:
        run_cell(tiny_root, CELL, capsys)
    assert "maus.eig.straggler" in str(exc.value) and served == []
    assert capsys.readouterr().out == ""
