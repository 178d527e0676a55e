"""The port's command-line interface (``python -m maus_tpu_torch``) on the
CPU, held to the JAX package's CLI: the reference's four scenarios with the
counts the JAX CLI reports on this CPU (1/1, 8/8, 8/8, 2/2; its scenarios
are run in tests/test_solver_e2e.py, so they are not rerun here), and the
generated eig and SVD runs with the LAPACK check. The two packages draw
different random numbers, so iteration counts are not compared."""
import re
import subprocess
import sys

import pytest
import torch

from maus_tpu_torch import cli

torch.set_num_threads(1)

JAX_SCENARIO_COUNTS = ["1/1", "8/8", "8/8", "2/2"]


def test_scenarios_pass_with_the_reference_counts(capsys):
    assert cli.main(["--cpu", "scenarios"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    assert len(lines) == 4 and all(ln.startswith("[PASS] scenario ") for ln in lines)
    counts = [re.search(r": (\d+/\d+) distinct in \d+ iters$", ln).group(1)
              for ln in lines]
    assert counts == JAX_SCENARIO_COUNTS
    assert "2B: N=8 Hermitian eig" in lines[2]


def test_eig_hermitian_check(capsys):
    assert cli.main(["--cpu", "eig", "--n", "8", "--hermitian", "--check"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"EIGENVALUE: 8/8 distinct solutions in \d+ iterations "
                    r"\(energy [0-9.]+\)$", out[0])
    assert sum(ln.startswith("  λ = ") for ln in out) == 8
    m = re.match(r"  vs LAPACK truth: matched (\d+)/(\d+), max err (\S+)$", out[-1])
    assert m and m.group(1) == m.group(2) == "8" and float(m.group(3)) < 1e-8


def test_svd_check(capsys):
    assert cli.main(["--cpu", "svd", "--check"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"SVD: 2/2 distinct solutions in \d+ iterations", out[0])
    m = re.match(r"  vs LAPACK truth: matched (\d+)/(\d+), max err (\S+)$", out[-1])
    assert m and m.group(1) == m.group(2) == "2" and float(m.group(3)) < 1e-6


def test_solve_exit_code_follows_convergence(capsys):
    """Converged → 0; an iteration budget too small to converge → 1."""
    assert cli.main(["--cpu", "solve", "--n", "16", "--check"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("SOLVE_LINEAR_SYSTEM: 1/1 distinct solutions")
    assert cli.main(["--cpu", "eig", "--n", "8", "--iters", "0"]) == 1


def test_parser_has_only_the_ported_subcommands(monkeypatch):
    """``age``, ``bench``, the checkpoint flags and the mesh flags
    (``--mesh-model``, ``--cpu-devices``, ``--backend``) are ported.
    ``--cpu-devices`` needs ``--cpu`` and runs gloo ranks, so it refuses
    ``--backend nccl``."""
    for argv in (["--cpu-devices", "2", "scenarios"],
                 ["--cpu", "--cpu-devices", "2", "--backend", "nccl", "solve"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
    parsed = []
    for name in ("cmd_age", "cmd_solve", "cmd_eig"):
        monkeypatch.setattr(cli, name, lambda args: parsed.append(args) or 0)
    assert cli.main(["age", "--cycles", "2", "--cands", "4", "--seed", "3",
                     "--islands", "2", "--json"]) == 0
    assert cli.main(["solve", "--checkpoint", "x", "--checkpoint-every", "2",
                     "--resume-from", "y"]) == 0
    assert cli.main(["--cpu", "--cpu-devices", "4", "eig", "--mesh-model",
                     "2"]) == 0
    assert cli.main(["--backend", "gloo", "eig", "--mesh-model", "2"]) == 0
    age, solve, eig_cpu, eig_card = parsed
    assert (age.cycles, age.cands, age.seed, age.islands, age.json) == (2, 4, 3, 2, True)
    assert (solve.checkpoint, solve.checkpoint_every, solve.resume_from) == ("x", 2, "y")
    assert (eig_cpu.cpu_devices, eig_cpu.mesh_model, eig_cpu.backend,
            eig_cpu.device) == (4, 2, "gloo", "cpu")
    assert (eig_card.mesh_model, eig_card.backend, eig_card.device) == \
        (2, "gloo", None)


def test_cpu_mesh_run_names_its_backend():
    """``--cpu --mesh-model`` with no backend named is refused by the
    library's rule (NCCL needs CUDA cards), before any rank starts; the CLI
    does not pick gloo for the caller."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        cli.main(["--cpu", "solve", "--n", "8", "--mesh-model", "2"])


def test_new_modules_import_without_jax():
    """The CLI and the Hermitian modules import neither jax nor the JAX
    package (the package-wide source scan is tests/test_torch_import.py)."""
    code = ("import sys, maus_tpu_torch.cli, maus_tpu_torch.solver.hermitian\n"
            "import maus_tpu_torch.ops.lanczos\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'maus_tpu.')) or m == 'maus_tpu')\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "maus_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "{solve,eig,svd,scenarios,bench,age}" in out.stdout


def test_bench_runs_the_headline_on_the_cpu(capsys):
    """``--cpu bench --quick --n 64``: the port's headline benchmark
    (``benchmarks/headline.py``) in complex64 on the CPU, its one JSON line
    with ``bench.py``'s keys, certified to 1e-8, exit code 0."""
    import json

    assert cli.main(["--cpu", "bench", "--quick", "--n", "64"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "solves_per_s"} <= set(line)
    assert line["metric"].startswith("time_to_tol(1e-08) N=64 illcond(k=1e+06) pop=16")
    assert line["achieved_rel"] <= 1e-8 and line["device"]["platform"] == "cpu"
