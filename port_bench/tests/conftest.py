"""Fixtures of the benchmark's CPU tests: a checkout-like root whose cells
run at tiny sizes, beside the real one."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


def tiny_config(config: dict) -> dict:
    """The configuration at a size the CPU runs in well under a second."""
    c = copy.deepcopy(config)
    c["n"] = 32
    if "cond" in c:
        c.update(cond=1e3, pool=2, num_candidates=8)
    else:
        c.update(num_candidates=12, target_solutions=4)
    return c


CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark's files under ``tmp`` with every configuration
    cut to a tiny size."""
    shutil.copytree(REPO / "port_bench", tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "*.pyc"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = tmp / entry["file"]
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)


def run_cell(root: Path, workload: str, capsys, seed: int = 2**31 + 11,
             seconds: float = 0.3, trace: int = 0, control: bool = False):
    """One run of ``workload`` under ``root`` on the CPU: (exit code, the
    result line as a dict or None, stderr)."""
    from port_bench.run import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(trace)], root=root, device="cpu", control=control)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
