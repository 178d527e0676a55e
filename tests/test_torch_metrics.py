"""Per-iteration metrics of the port (``evolve.evolve_metrics``,
``SolutionReport.metrics``, ``utils/metrics.py``) against the JAX package's
``evolve_scan``.

The JAX package's ``init_carry`` builds the state and ``carry_from_numpy``
carries it into the port (the packages draw different random numbers), as
in tests/test_torch_engine.py; then five iterations run in each package
with the engine tests' respawn-free settings, and the metrics rows are
compared field by field. Tolerances are the engine tests': floats to 1e-12
relative in complex128 and 1e-5 in complex64; counts and status codes
exactly. The row shapes follow the capture flags: (iterations,) scalars,
(iterations, K) candidate histories, (iterations, K, N) iterates, and
zero-size candidate fields without the flags."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maus_tpu
from maus_tpu.problems import generators as gen
from maus_tpu.solver import evolve as ej
from maus_tpu_torch import MausSolver, ProblemType, SolverConfig
from maus_tpu_torch import ProblemKnowledge as KnowledgeT
from maus_tpu_torch.solver import evolve as et
from maus_tpu_torch.utils import metrics as metrics_mod
from maus_tpu_torch.utils.convert import carry_from_numpy
from maus_tpu_torch.utils.precision import full_precision

torch.set_num_threads(1)

K = 8
N = 64
ITERS = 5
RESPAWN_FREE = dict(num_candidates=K, tol=1e-8, alpha_initial=0.2, alpha_grow=1.0)
EXACT = ("num_distinct", "candidate_status")
FIELDS = ("landscape_energy", "avg_residual", "avg_stuckness", "num_distinct",
          "min_residual", "psi_aggression", "threshold", "solve_fail_frac",
          "candidate_residuals", "candidate_alpha", "candidate_status",
          "candidate_params")


def _close(name, got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.all(np.isfinite(got) == np.isfinite(want)), name
    fin = np.isfinite(want)
    scale = np.max(np.abs(want[fin]), initial=0.0)
    assert np.max(np.abs(got[fin] - want[fin]), initial=0.0) <= \
        rtol * max(scale, 1e-30), (name, got, want)


@pytest.mark.parametrize("dtype,history,params", [
    (np.complex128, False, False), (np.complex128, True, False),
    (np.complex128, True, True), (np.complex64, False, True)])
def test_rows_match_jax_evolve_scan(dtype, history, params):
    rtol = 1e-5 if dtype == np.complex64 else 1e-12
    if dtype == np.complex128:
        A, b = gen.ill_conditioned_system(N, 1e2, seed=2)
    else:
        A, b = gen.well_conditioned_system(N, seed=2)
    A, b = A.astype(dtype), b.astype(dtype)
    kappa = float(np.linalg.cond(A))
    flags = dict(capture_history=history, capture_param_history=params)
    cfg_j = maus_tpu.SolverConfig(dtype=dtype, **RESPAWN_FREE, **flags)
    cfg_t = SolverConfig(dtype=dtype, **RESPAWN_FREE, **flags)
    kn_j = maus_tpu.ProblemKnowledge(shape=A.shape, cond_estimate=kappa)
    kn_t = KnowledgeT(shape=A.shape, cond_estimate=kappa)

    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    carry = ej.init_carry(cfg_j, kn_j, Aj, jax.random.PRNGKey(3))
    leaves = jax.tree.map(np.asarray, carry)
    ct = carry_from_numpy(leaves, torch.device("cpu"))
    _, mj = ej.evolve_scan(cfg_j, kn_j, Aj, bj, jax.random.PRNGKey(3), ITERS, 1,
                           carry0=jax.tree.map(jnp.asarray, leaves))
    with full_precision():
        _, mt = et.evolve_metrics(cfg_t, kn_t, torch.from_numpy(A),
                                  torch.from_numpy(b), 0, ITERS, 1, carry0=ct)

    assert tuple(f.name for f in et.dataclasses.fields(et.Metrics)) == FIELDS
    assert tuple(mj._fields) == FIELDS
    for f in FIELDS:
        got, want = getattr(mt, f).numpy(), np.asarray(getattr(mj, f))
        assert got.dtype == want.dtype, f
        if f in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            _close(f, got, want, rtol)
    assert mt.landscape_energy.shape == (ITERS,)
    assert mt.candidate_residuals.shape == ((ITERS, K) if history else (ITERS, 0))
    assert mt.candidate_status.dtype == torch.int8
    assert mt.candidate_params.shape == ((ITERS, K, N) if params else (ITERS, 0, 0))


def test_report_metrics_shapes_and_zero_rows_after_the_stop():
    """``SolutionReport.metrics``: one row per iteration up to
    max_iterations, all-zero rows once the loop has stopped; collecting them
    changes nothing in the run."""
    A, b = gen.well_conditioned_system(12, seed=2)
    cfg = SolverConfig(num_candidates=4, dtype=torch.complex128,
                       capture_history=True, capture_param_history=True)
    plain = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                       config=cfg, device="cpu").evolve(max_iterations=20)
    rep = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b, config=cfg,
                     device="cpu").evolve(max_iterations=20, collect_metrics=True)
    assert plain.metrics is None
    assert (rep.iterations, rep.residuals) == (plain.iterations, plain.residuals)
    m = rep.metrics
    assert set(m) == set(FIELDS)
    assert m["min_residual"].shape == (20,)
    assert m["candidate_residuals"].shape == m["candidate_alpha"].shape == (20, 4)
    assert m["candidate_params"].shape == (20, 4, 12)
    ran = rep.iterations
    assert 0 < ran < 20
    assert np.all(m["psi_aggression"][:ran] > 0) and m["num_distinct"][ran - 1] >= 1
    for f in FIELDS:
        assert not np.any(m[f][ran:]), f
    assert np.all(np.isfinite(m["candidate_params"][ran - 1]))
    assert not np.allclose(m["candidate_params"][0], m["candidate_params"][ran - 1])


def test_rows_without_capture_flags_are_zero_size():
    A, b = gen.well_conditioned_system(12, seed=2)
    rep = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                     initial_num_candidates=4, device="cpu").evolve(
        max_iterations=7, collect_metrics=True)
    m = rep.metrics
    assert m["avg_residual"].shape == (7,)
    assert m["candidate_residuals"].shape == m["candidate_status"].shape == (7, 0)
    assert m["candidate_params"].shape == (7, 0, 0)


def test_sink_timer_logging_and_profile(tmp_path, caplog):
    A, b = gen.well_conditioned_system(12, seed=2)
    rep = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                     initial_num_candidates=4, device="cpu").evolve(
        max_iterations=6, collect_metrics=True)
    path = tmp_path / "m.jsonl"
    sink = metrics_mod.MetricsSink(str(path))
    assert sink.write_trace(rep.metrics, prefix={"run": "a"}) == 6
    with caplog.at_level("INFO", logger="maus_tpu_torch"):
        with metrics_mod.timed("scope", sink):
            pass
    sink.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["iteration"] for ln in lines[:6]] == list(range(6))
    assert lines[0]["run"] == "a"
    assert lines[0]["min_residual"] == pytest.approx(rep.metrics["min_residual"][0])
    assert lines[-1]["timer"] == "scope" and lines[-1]["seconds"] >= 0
    assert any("scope:" in r.getMessage() for r in caplog.records)
    metrics_mod.configure_logging()
    assert metrics_mod.logger.handlers and metrics_mod.logger.name == "maus_tpu_torch"
    metrics_mod.logger.handlers.clear()
    with metrics_mod.profile_trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
