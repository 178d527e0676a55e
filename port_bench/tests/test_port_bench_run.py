"""Whole runs on the CPU at tiny sizes: the result line's keys, a cell made
of new files and entries alone, and ``correct`` coming out false under the
control and under each fault a cell can have."""
from __future__ import annotations

import copy
import json

import pytest

import maus_tpu_torch.solver.api as api
import maus_tpu_torch.solver.candidate as candidate
import maus_tpu_torch.solver.hermitian as hermitian

from .conftest import CELLS, REPO, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_with_the_result_keys(tiny_root, capsys, cell, trace):
    rc, line, err = run_cell(tiny_root, cell, capsys, trace=trace)
    assert rc == 0 and line["correct"] is True, err
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert set(line["device"]) == DEVICE | ({"busy_s", "window_s"} if trace else set())
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s"} < set(line["metrics"])     # peak_gib: the card only
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


NEW_INPUT = """
import torch
from port_bench import operands


def operand(config, traffic, state, seed, i, device):
    n = int(config["n"])
    g = operands.generator(seed, device)
    A = operands.cnormal(g, (n, n), torch.complex64, device) / n
    A += float(traffic["diagonal"]) * torch.eye(n, dtype=torch.complex64, device=device)
    return A, operands.cnormal(g, (n,), torch.complex64, device), {}
"""
NEW_CALL = """
from port_bench import program


def serve(config, req, control):
    import maus_tpu_torch as maus
    return maus.solve(req.A, req.b, tol=float(config["tol"]),
                      max_iterations=int(config["max_iterations"]),
                      num_candidates=int(config["num_candidates"]),
                      seed=req.solver_seed, device=req.A.device)


def reached_target(config, report):
    return program.reached(config, report, 1)


def answer(config, report):
    return program.linear_answer(report)
"""
NEW_REFERENCE = """
import torch


def judge(config, records, rebuilt):
    worst = 0.0
    for r in records:
        if r["answer"] is not None:
            A, b = rebuilt(r)
            A, b = A.to(torch.complex128), b.to(torch.complex128)
            res = (b - A @ r["answer"]).abs().max() / b.abs().max()
            worst = max(worst, float(res))
    return {"resid_inf": (worst, float(config["tol"]))}
"""
NEW_CELLS = {
    # a configuration and a mix of data alone, recombining an input kind and
    # a call that are there
    "data": ({"name": "eig_tiny_new", "reference": "port_bench/reference/eig.py", "n": 24,
              "num_candidates": 8, "target_solutions": 3, "tol": 1e-8, "max_iterations": 60},
             {"operand": "gue", "call": "eig"}, {},
             {"failed", "eig_resid", "eig_short"}),
    # a new input kind, call and reference, each a new file
    "code": ({"name": "lin_tiny_new", "reference": "port_bench/reference/inf_norm.py",
              "n": 24, "num_candidates": 8, "tol": 1e-8, "max_iterations": 30},
             {"operand": "diagonal_heavy", "call": "solve_plain", "diagonal": 4.0},
             {"inputs/diagonal_heavy.py": NEW_INPUT, "calls/solve_plain.py": NEW_CALL,
              "reference/inf_norm.py": NEW_REFERENCE},
             {"failed", "resid_inf"}),
}


@pytest.mark.parametrize("kind", list(NEW_CELLS))
def test_cell_of_new_files_and_entries_alone(tiny_root, capsys, kind):
    """A cell of a new configuration, added by new files and appended entries
    alone, reports the answer time; its one new metric is a per-layer one
    whose ``workloads`` names it."""
    config, traffic, code, checks = NEW_CELLS[kind]
    pb = tiny_root / "port_bench"
    for rel, text in code.items():
        assert not (pb / rel).exists()
        (pb / rel).write_text(text)
    name = config["name"]
    (pb / "configs" / f"{name}.json").write_text(json.dumps(config))
    (pb / "traffic" / f"{name}_mix.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "answers_n.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    before = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(before)
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"port_bench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.new", "config": name,
                               "traffic": f"{name}_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "answers_n", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "answer_s", "workloads": ["tiny.new"]})
    assert set(bench) == set(before)
    for key, entries in before.items():             # every entry there is unchanged
        kept = bench[key][:len(entries)] if isinstance(entries, list) else bench[key]
        assert kept == entries, key
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_cell(tiny_root, "tiny.new", capsys)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["metrics"]) == {"setup_s", "answer_s", "answer_p95_s"}  # peak_gib: the card
    assert all(line["metrics"][m]["value"] > 0 for m in ("answer_s", "answer_p95_s"))
    assert set(line["checks"]) == checks
    rc, line, err = run_cell(tiny_root, "tiny.new", capsys, trace=1)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["metrics"]) == {"answers_n"}
    assert line["metrics"]["answers_n"]["value"] == line["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, capsys, cell):
    rc, line, err = run_cell(tiny_root, cell, capsys, control=True)
    assert rc == 0 and line["correct"] is False, err
    assert any(c["value"] > c["limit"] for k, c in line["checks"].items() if k != "failed")


def _alter(sol):
    if len(sol) == 1:
        return (sol[0] * (1 + 1e-5),)
    return (sol[0] + 1e-5, sol[1])


FAULTS = {
    # an answer altered where it is produced
    "altered": lambda f: lambda cfg, s, r: f(cfg, [_alter(s[0])] + list(s[1:]), r),
    # half of the answers left out
    "half_missing": lambda f: _every_other(f),
}


def _every_other(f):
    state = {"n": 0}

    def dedup(cfg, s, r):
        state["n"] += 1
        return ([], []) if state["n"] % 2 else f(cfg, s, r)
    return dedup


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(tiny_root, capsys, monkeypatch, cell, fault):
    monkeypatch.setattr(api, "_final_dedup", FAULTS[fault](api._final_dedup))
    rc, line, err = run_cell(tiny_root, cell, capsys)
    assert rc == 0 and line["correct"] is False, err


def _frozen(step):
    def frozen(cfg, A, *args, **kw):
        pop, stats = step(cfg, A, *args, **kw)
        return args[-2] if len(args) >= 2 else kw["pop"], stats
    return frozen


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(tiny_root, capsys,
                                                                monkeypatch, cell):
    for mod, name in ((candidate, "step_linear"), (candidate, "step_eigen"),
                      (hermitian, "step_hermitian"), (hermitian, "step_hermitian_lanczos")):
        monkeypatch.setattr(mod, name, _frozen(getattr(mod, name)))
    rc, line, err = run_cell(tiny_root, cell, capsys)
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] == line["attempted"]


def test_no_card_no_result(tiny_root, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from port_bench.run import main

    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], root=tiny_root)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_without_the_program_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the run ends before
    any result, whatever the host."""
    import shutil
    import subprocess
    import sys

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "port_bench", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
