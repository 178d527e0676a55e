"""The population engine of the port against the JAX package, iteration by
iteration, from identical state.

The JAX package's ``init_carry`` builds the state; ``carry_from_numpy`` carries
it into the port (the two packages draw different random numbers, so state is
injected, not drawn). Then five iterations of ``make_iteration`` run in each
package. The settings are respawn-free (α starts at 0.2 and does not grow, so
no candidate converges, regresses or retires in five iterations), because a
respawn would draw fresh random iterates.

Tolerances: floats agree to the working dtype's rounding — 1e-12 relative in
complex128, 1e-5 in complex64 (the systems have κ ≤ 1e2, and every float is a
residual, step size or strategy scalar one or two operations from the shared
factorization). Codes, counters and the quantized Ψ agree exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maus_tpu
from maus_tpu.problems import generators as gen
from maus_tpu.solver import evolve as ej
from maus_tpu_torch import ProblemKnowledge as KnowledgeT
from maus_tpu_torch import SolverConfig as ConfigT
from maus_tpu_torch.solver import evolve as et
from maus_tpu_torch.utils.convert import carry_from_numpy

torch.set_num_threads(1)

K = 8
ITERS = 5
RESPAWN_FREE = dict(num_candidates=K, tol=1e-8, alpha_initial=0.2, alpha_grow=1.0)

POP_FLOATS = ("v", "residual", "prev_residual", "alpha", "weight")
POP_EXACT = ("status", "stuck", "psi_level", "retire_count")
STRAT_FLOATS = ("psi_aggression", "spawn_rate", "threshold", "landscape_energy",
                "avg_residual", "avg_stuckness", "frustration", "pref_failures")
STRAT_EXACT = ("solver_pref", "stability", "num_distinct", "target_dynamic")


def _system(dtype):
    if dtype == np.complex128:
        A, b = gen.ill_conditioned_system(64, 1e2, seed=2)
    else:
        A, b = gen.well_conditioned_system(64, seed=2)
    return A.astype(dtype), b.astype(dtype)


def _close(name, got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.max(np.abs(want)) if want.size else 0.0
    assert np.all(np.isfinite(got) == np.isfinite(want)), name
    fin = np.isfinite(want)
    assert np.max(np.abs(got[fin] - want[fin]), initial=0.0) <= rtol * max(scale, 1e-30), \
        (name, got, want)


@pytest.mark.parametrize("case", ["c128", "c64", "c128-refactor", "c128-gmres"])
def test_five_iterations_match(case):
    dtype = np.complex64 if case == "c64" else np.complex128
    rtol = 1e-5 if dtype == np.complex64 else 1e-12
    A, b = _system(dtype)
    kappa = float(np.linalg.cond(A))
    cfg_j = maus_tpu.SolverConfig(dtype=dtype, **RESPAWN_FREE)
    cfg_t = ConfigT(dtype=dtype, **RESPAWN_FREE)
    kn_j = maus_tpu.ProblemKnowledge(shape=A.shape, cond_estimate=kappa)
    kn_t = KnowledgeT(shape=A.shape, cond_estimate=kappa)

    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    carry = ej.init_carry(cfg_j, kn_j, Aj, jax.random.PRNGKey(3))
    leaves = jax.tree.map(np.asarray, carry)
    if case == "c128-refactor":
        # a stale Ψ: both packages must rebuild the factorization at iteration 1
        leaves = leaves._replace(psi_cached=np.float32(0.0))
    if case == "c128-gmres":
        leaves = leaves._replace(strat=dataclasses.replace(
            leaves.strat, solver_pref=np.int32(1)))

    cj = jax.tree.map(jnp.asarray, leaves)
    step_j = jax.jit(ej.make_iteration(cfg_j, kn_j, Aj, bj, None, 1))
    for _ in range(ITERS):
        cj, _ = step_j(cj)

    ct = carry_from_numpy(leaves, torch.device("cpu"))
    step_t = et.make_iteration(cfg_t, kn_t, torch.from_numpy(A),
                               torch.from_numpy(b), 1)
    for _ in range(ITERS):
        ct = step_t(ct)

    for f in POP_FLOATS:
        _close(f, getattr(ct.pop, f).numpy(), getattr(cj.pop, f), rtol)
    for f in POP_EXACT:
        np.testing.assert_array_equal(getattr(ct.pop, f).numpy(),
                                      np.asarray(getattr(cj.pop, f)), err_msg=f)
    for f in STRAT_FLOATS:
        _close(f, getattr(ct.strat, f).numpy(), getattr(cj.strat, f), rtol)
    for f in STRAT_EXACT:
        assert int(getattr(ct.strat, f)) == int(getattr(cj.strat, f)), f
    assert np.float32(ct.psi_cached.item()) == np.float32(cj.psi_cached)
    assert int(ct.iteration) == int(cj.iteration) == ITERS
    assert int(ct.stall_count) == int(cj.stall_count)
    _close("best_residual", ct.best_residual.numpy(), cj.best_residual, rtol)
    # the run really was respawn-free and never converged
    assert (ct.pop.retire_count.numpy() == 0).all()
    assert int(ct.strat.num_distinct) == 0
    if case == "c128-refactor":
        assert float(ct.psi_cached) > 0.0


def test_init_carry_shapes_and_dtypes():
    A, b = _system(np.complex64)
    cfg = ConfigT(dtype=np.complex64, num_candidates=K)
    kn = KnowledgeT(shape=A.shape, cond_estimate=2.0)
    c = et.init_carry(cfg, kn, torch.from_numpy(A), seed=5)
    assert c.pop.v.shape == (K, 64) and c.pop.v.dtype == torch.complex64
    np.testing.assert_allclose(torch.linalg.vector_norm(c.pop.v, dim=-1).numpy(),
                               1.0, rtol=1e-6)
    assert c.pop.status.dtype == torch.int8 and c.pop.keys.shape == (K, 2)
    assert c.psi_cached.dtype == torch.float32 and c.strat.threshold.dtype == torch.float32
    # per-slot streams: independent rows, reproducible from the seed
    c2 = et.init_carry(cfg, kn, torch.from_numpy(A), seed=5)
    np.testing.assert_array_equal(c.pop.v.numpy(), c2.pop.v.numpy())
    assert len({tuple(np.round(r, 6)) for r in c.pop.v.numpy().real}) == K
