"""The port's measuring programs (``maus_tpu_torch/benchmarks/``) on the CPU
at N ≤ 128, each through ``main(argv, device="cpu")``, against the JAX
package's programs.

- Keys: each program's lines carry its JAX counterpart's keys. The
  headline's are read from ``bench.py`` itself, run in a subprocess
  (``--quick --n 64 --no-mfu``, JAX on the CPU); the others' are the key
  sets the JAX programs print (their source lines cited at each set).
- Parity: the headline solve and both eig_paths branches run from the same
  injected initial carry as the JAX package's evolve (the two packages draw
  different random numbers from a seed, so the state is carried over with
  ``utils/convert.carry_from_numpy``). The headline: the same iteration
  count, both certified ≤ tol, and x within a relative 1e-6 of the JAX
  solution (κ = 1e4: two iterates each certified near 1e-10 from the same
  trajectory differ far less than κ·tol). eig_paths: the same distinct
  count on each branch.
- The bound helper gives ``PERF.md`` §6's bounds, and without a card every
  ``main`` raises unless asked for the CPU.

The ``cuda`` tests run ``bench --quick`` and the scorecard on the card and
skip here."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maus_tpu_torch import cli
from maus_tpu_torch.benchmarks import (age, common, eig_paths, headline,
                                       scorecard, solve16k, spectral_large,
                                       throughput)

try:
    import jax
    import jax.numpy as jnp
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jax = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# the keys each JAX program prints
JAX_KEYS = {
    # benchmarks/throughput.py:68-73
    "throughput": {"metric", "value", "unit", "vs_baseline"},
    # benchmarks/spectral_large_probe.py:99-108
    "spectral_large": {"metric", "time_s", "num_distinct", "target", "n_at_tol",
                       "iterations", "max_resid", "resid_top_target",
                       "hbm_peak_gb"},
    # benchmarks/eig_paths.py:65-72
    "eig_paths": {"n", "cands", "target", "direct_hessenberg",
                  "jacobi_davidson_gmres", "jd_over_direct"},
    "eig_branch": {"s", "distinct", "iters", "min_res"},
    # benchmarks/solve16k_probe.py:138-144, less host_refactors (the TPU's
    # host-refactor handoff, not ported)
    "solve16k": {"metric", "value", "unit", "vs_baseline", "iters",
                 "scipy_per_solve_modeled_s"},
    # benchmarks/age_probe.py:37-42, 76-82, 110-114
    "age": [{"metric", "time_s", "vs_reference_240s", "best_fitness", "library"},
            {"metric", "time_s", "sims_per_s", "cell_steps_per_s", "mean_fitness"},
            {"metric", "time_s", "vs_reference_6.2s", "passed", "scenario_ok"}],
    # benchmarks/mfu.py:334-369, a kernel row and the HBM stream row
    "scorecard_row": {"shape", "time_s", "gflops", "mfu", "sol_frac"},
    "scorecard_stream": {"shape", "time_s", "gbs", "sol_frac"},
}
CPU_RECORD = {"platform", "kind", "count", "power_limit"}


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _on_cpu(row):
    assert set(row["device"]) == CPU_RECORD
    assert row["device"]["platform"] == "cpu" and row["device"]["power_limit"] is None


def _needs_jax():
    if jax is None:
        pytest.skip("needs the JAX package")


def test_headline_keys_are_bench_py_keys(capsys):
    """``bench.py --quick --n 64 --no-mfu`` (JAX on the CPU) and the port's
    headline at the same settings: bench.py's keys are all in the port's
    line, with ``layers`` covering the solve."""
    _needs_jax()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py", "--quick", "--n", "64",
                          "--no-mfu"], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_line = json.loads(out.stdout.strip().splitlines()[-1])
    assert headline.main(["--quick", "--n", "64", "--no-mfu"], device="cpu") == 0
    line, = _lines(capsys)
    assert set(jax_line) <= set(line)
    assert "MISS" not in line["metric"] and line["achieved_rel"] <= 1e-8
    assert line["metric"].split(" [")[0] == jax_line["metric"].split(" [")[0]
    assert set(line["layers"]) == {"init_s", "engine_s", "refine_s", "other_s"}
    assert abs(sum(line["layers"].values()) - line["value"]) < 1e-9
    assert line["peak_gib"] is None and line["k1_launches"] == 0 and "mfu" not in line
    _on_cpu(line)


def test_headline_solve_matches_jax_from_the_same_carry():
    """The headline's solve (evolve, best candidate, refine_split) against
    ``bench.py:_solve_fused``'s (evolve_while + refine_split_c64exact) on
    the same complex64 system and initial carry, N = 64, κ = 1e4."""
    _needs_jax()
    from maus_tpu.core.types import (ProblemKnowledge, ProblemType,
                                     SolverConfig)
    from maus_tpu.ops.refine import SplitComplex, refine_split_c64exact
    from maus_tpu.problems import generators as gen
    from maus_tpu.solver import evolve as ej
    from maus_tpu_torch.utils.convert import carry_from_numpy

    n, cond, tol, K = 64, 1e4, 1e-8, 16
    A, b = gen.ill_conditioned_system(n, cond, seed=3)
    A, b = A.astype(np.complex64), b.astype(np.complex64)
    cfg_t, kn_t = headline.config(n, K, cond, tol)
    cfg_j = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                         num_candidates=K, tol=tol, dtype=jnp.complex64,
                         convergence_floor=cfg_t.convergence_floor, refine=True,
                         max_refine_steps=60)
    kn_j = ProblemKnowledge(shape=(n, n), cond_estimate=cond)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    key = jax.random.PRNGKey(1)
    leaves = jax.tree.map(np.asarray, ej.init_carry(cfg_j, kn_j, Aj, key))
    carry, _ = ej.evolve_while(cfg_j, kn_j, Aj, bj, key, headline.MAX_ITERS, 1,
                               carry0=jax.tree.map(jnp.asarray, leaves))
    res = np.asarray(carry.pop.residual)
    best = int(np.argmin(np.where(np.isfinite(res), res, np.inf)))
    b64 = SplitComplex(jnp.asarray(b.real, jnp.float64), jnp.asarray(b.imag, jnp.float64))
    xs, rel_j = refine_split_c64exact(Aj, carry.fac, b64, carry.pop.v[best],
                                      steps=60, tol=0.3 * tol)
    x_j = np.asarray(xs.re) + 1j * np.asarray(xs.im)

    out = headline.solve(cfg_t, kn_t, torch.from_numpy(A), torch.from_numpy(b),
                         carry0=carry_from_numpy(leaves, CPU))
    assert out["iterations"] == int(carry.iteration)
    assert out["rel"] <= tol and float(rel_j) <= tol
    x_t = out["x"].numpy()
    assert np.linalg.norm(x_t - x_j) <= 1e-6 * np.linalg.norm(x_j)


@pytest.mark.parametrize("pref", ["DIRECT", "GMRES"])
def test_eig_paths_branch_matches_jax_from_the_same_carry(pref):
    """Each eig_paths branch from the JAX program's carry with the same
    ``solver_pref`` (N = 64, its settings otherwise): the same distinct
    count as the JAX evolve."""
    _needs_jax()
    import dataclasses

    from maus_tpu.core.types import (ProblemKnowledge, ProblemType,
                                     SolverConfig, SolverPreference)
    from maus_tpu.solver import evolve as ej
    from maus_tpu_torch.utils.convert import carry_from_numpy

    n, cands, target, iters = 64, 16, 6, 60
    rng = np.random.default_rng(0)
    A = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         / np.sqrt(n)).astype(np.complex64)
    cfg_j = SolverConfig(problem_type=ProblemType.EIGENVALUE, num_candidates=cands,
                         tol=1e-4, dtype=jnp.complex64, convergence_floor=2e-6,
                         refine=False, target_num_solutions=target)
    kn_j = ProblemKnowledge(shape=(n, n), cond_estimate=100.0)
    Aj = jnp.asarray(A)
    key = jax.random.PRNGKey(eig_paths.CARRY_SEED)
    leaves = jax.tree.map(np.asarray, ej.init_carry(cfg_j, kn_j, Aj, key))
    code = int(getattr(SolverPreference, pref))
    leaves = leaves._replace(strat=dataclasses.replace(
        leaves.strat, solver_pref=np.int32(code)))
    carry_j, _ = ej.evolve_while(cfg_j, kn_j, Aj, None, key, iters, target,
                                 carry0=jax.tree.map(jnp.asarray, leaves))

    cfg_t, kn_t = eig_paths.config(n, cands, target)
    carry0 = carry_from_numpy(leaves, CPU)
    assert int(carry0.strat.solver_pref) == code
    carry0 = eig_paths.with_preference(carry0, code)
    assert carry0.strat.solver_pref.dtype == torch.int32 and \
        carry0.strat.solver_pref.ndim == 0
    out = eig_paths.evolve_branch(cfg_t, kn_t, torch.from_numpy(A), carry0,
                                  iters, target)
    assert out["distinct"] == int(carry_j.strat.num_distinct) >= target
    assert np.isfinite(out["min_res"])


def test_eig_paths_line(capsys):
    assert eig_paths.main(["--n", "32", "--cands", "8", "--target", "3",
                           "--iters", "20"], device="cpu") == 0
    line, = _lines(capsys)
    assert JAX_KEYS["eig_paths"] <= set(line)
    for branch in ("direct_hessenberg", "jacobi_davidson_gmres"):
        assert JAX_KEYS["eig_branch"] <= set(line[branch])
    assert line["direct_hessenberg"]["distinct"] >= 3
    _on_cpu(line)


def test_throughput_line(capsys):
    assert throughput.main(["--n", "32", "--cands", "4", "--reps", "2"],
                           device="cpu") == 0
    line, = _lines(capsys)
    assert JAX_KEYS["throughput"] <= set(line)
    assert line["metric"] == "candidate_shifted_solves_per_sec N=32 pop=4"
    assert line["value"] > 0 and line["unit"] == "solves/s"
    _on_cpu(line)


def test_spectral_large_lines(capsys):
    assert spectral_large.main(["--sizes", "32", "--cands", "4", "--svd-shape",
                                "32x16", "--iters", "60"], device="cpu") == 0
    lines = _lines(capsys)
    assert [ln["metric"] for ln in lines] == ["eig N=32 general", "eig N=32 hermitian",
                                              "svd 32x16"]
    for ln in lines:
        assert JAX_KEYS["spectral_large"] <= set(ln)
        assert set(ln["timings"]) == {"setup_s", "engine_s", "finish_s"}
        assert ln["num_distinct"] >= 4 and ln["n_at_tol"] >= 4
        assert ln["hbm_peak_gb"] is None
        _on_cpu(ln)


def test_solve16k_line(capsys):
    assert solve16k.main(["--n", "64"], device="cpu") == 0
    line, = _lines(capsys)
    assert JAX_KEYS["solve16k"] <= set(line)
    assert line["metric"].startswith("time_to_tol(1e-08) N=64 illcond(k=1e+06) pop=16")
    assert line["achieved_rel"] <= 1e-8
    _on_cpu(line)


def test_age_lines(capsys):
    assert age.main(["--stage3-cands", "8"], device="cpu") == 0
    lines = _lines(capsys)
    assert len(lines) == 3
    for ln, keys in zip(lines, JAX_KEYS["age"]):
        assert keys <= set(ln)
        _on_cpu(ln)
    # the 5×20 seed-0 run's library, as tests/test_torch_age.py holds it
    assert lines[0]["library"] == 90
    assert lines[2]["passed"] == "4/4"


def test_scorecard_rows(capsys):
    assert scorecard.main(["--n-gemm", "32", "--n-qr", "32", "--k-lu", "4",
                           "--n-lu", "16", "--k-mv", "4", "--n-mv", "64"],
                          device="cpu") == 0
    line, = _lines(capsys)
    kernels = line["kernels"]
    assert set(kernels) == {"cgemm_calibration", "hbm_stream", "shared_qr_factor",
                            "batched_shifted_lu_solve", "hessenberg_shifted_solve",
                            "hessenberg_shifted_solve_eig_path",
                            "population_matvec", "true_residual"}
    for name, row in kernels.items():
        want = JAX_KEYS["scorecard_stream" if name == "hbm_stream" else "scorecard_row"]
        assert want <= set(row), name
        # the peaks are the card's: no device share from a CPU run
        assert row["sol_frac"] is None and row.get("mfu") is None
    _on_cpu(line)


def test_bound_helper_gives_perf_md_bounds():
    """PERF.md §6: K1 at 4096² complex64 0.0401 ms (bytes), K2 at
    (32, 4096) 0.112 ms (operations)."""
    k1_ms, k1_by = common.bound_ms(*common.k1_work(4096, 4096, torch.complex64),
                                   common.FP64_FLOPS)
    k2_ms, k2_by = common.bound_ms(*common.k2_work(32, 4096), common.FP32_FLOPS)
    assert (round(k1_ms, 4), k1_by) == (0.0401, "bytes")
    assert (round(k2_ms, 3), k2_by) == (0.112, "operations")
    rec = common.peaks(common.device_record(CPU))
    assert rec["hbm_tb_s"] == 3.35 and rec["power_limit"] is None


def test_every_main_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (headline, scorecard, throughput, spectral_large, eig_paths,
                solve16k, age):
        with pytest.raises(RuntimeError, match="CUDA card"):
            mod.main([])
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(["bench", "--quick"])


@pytest.mark.cuda
def test_bench_quick_on_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    assert cli.main(["bench", "--quick"]) == 0
    line, = _lines(capsys)
    assert line["achieved_rel"] <= 1e-8 and line["k1_launches"] > 0
    assert line["device"]["platform"] == "gpu" and line["peak_gib"] > 0


@pytest.mark.cuda
def test_scorecard_on_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    assert scorecard.main([]) == 0
    line, = _lines(capsys)
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    for name, row in line["kernels"].items():
        assert 0 < row["sol_frac"] <= 1.05, name
