"""What a run loads: no module whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``maus_tpu`` (``maus_tpu_torch`` is the
program, and allowed); and the plain references load nothing of the
program."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from port_bench import run

from .conftest import REPO


@pytest.mark.parametrize("name,bad", [
    ("maus_tpu", True), ("maus_tpu.solver.api", True), ("jax", True), ("jaxlib.xla", True),
    ("flax.linen", True), ("maus_tpu_torch", False), ("maus_tpu_torch.ops", False),
    ("jaxtyping", False), ("maus_tpux", False)])
def test_forbidden_compares_top_level_names_whole(monkeypatch, name, bad):
    for forbidden in run.FORBIDDEN:
        monkeypatch.delitem(sys.modules, forbidden, raising=False)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (run.forbidden_modules() != []) == bad


def test_a_run_loads_nothing_forbidden(tmp_path):
    """A whole tiny run in a fresh interpreter, then the look at sys.modules
    that the benchmark makes itself."""
    code = f"""
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / 'port_bench' / 'tests')!r})
from conftest import make_root
from pathlib import Path
from port_bench.run import main, forbidden_modules
root = make_root(Path({str(tmp_path)!r}))
for cell, trace in (("linear4096.known_cond", 1), ("linear4096.diagnosed", 0)):
    assert main(["--workload", cell, "--seed", "5", "--seconds", "0.2", "--trace",
                 str(trace)], root=root, device="cpu") == 0
print("FORBIDDEN", forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FORBIDDEN []" in out.stdout


def test_references_import_nothing_of_the_program():
    for path in (REPO / "port_bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else ["port_bench"]
            for n in names:
                assert n.partition(".")[0] in ("torch", "numpy", "math", "__future__"), \
                    (path.name, n)
    code = ("import sys; import port_bench.reference.linear, port_bench.reference.eig; "
            "print(sorted({m.partition('.')[0] for m in sys.modules} & "
            "{'maus_tpu_torch', 'maus_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
