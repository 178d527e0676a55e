"""The port's non-Hermitian eig path against the JAX package.

Layer by layer from identical state (the two packages draw different random
numbers, so state is injected, not drawn): ``step_eigen`` from a JAX carry
(``carry_from_numpy`` + ``hess_from_numpy``) through both of its branches,
``population.manage``'s eig respawn, and the FP64 finisher
``refine_eigenpairs``. Then end to end, where each package draws its own
population and both are held to the same outcome.

Tolerances: complex128 steps agree to 1e-10 (unit vectors and λ of a
‖A‖ ≈ 1 operand, three steps of inverse iteration whose shifted systems have
κ ≲ 1e3); finished eigenpairs reach the FP64 floor (1e-12 absolute on
‖A‖ ≈ 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maus_tpu
import maus_tpu_torch
from maus_tpu.ops import hessenberg as hj
from maus_tpu.ops.refine import SplitComplex
from maus_tpu.ops.refine_eig import refine_eigenpairs as refine_j
from maus_tpu.problems import generators as gen
from maus_tpu.solver import candidate as cand_j
from maus_tpu.solver import evolve as evolve_j
from maus_tpu.solver import population as pop_j
from maus_tpu.solver import strategy as strat_j
from maus_tpu_torch.core import rng as rng_t
from maus_tpu_torch.core.types import CandidateStatus
from maus_tpu_torch.ops.refine_eig import refine_eigenpairs as refine_t
from maus_tpu_torch.solver import candidate as cand_t
from maus_tpu_torch.solver import population as pop_t
from maus_tpu_torch.solver import strategy as strat_t
from maus_tpu_torch.solver.api import eig_convergence_floor
from maus_tpu_torch.utils.convert import carry_from_numpy, hess_from_numpy

torch.set_num_threads(1)

EIG = maus_tpu.ProblemType.EIGENVALUE
CPU = torch.device("cpu")


def _ginibre(n, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
            / np.sqrt(2 * n)).astype(dtype)


def _configs(K, **kw):
    return (maus_tpu.SolverConfig(problem_type=EIG, num_candidates=K, **kw),
            maus_tpu_torch.SolverConfig(problem_type=EIG, num_candidates=K, **kw))


def _carry(A, cfg_j, seed=1):
    kn = maus_tpu.ProblemKnowledge(shape=A.shape, cond_estimate=10.0)
    return jax.tree.map(np.asarray, evolve_j.init_carry(
        cfg_j, kn, jnp.asarray(A), jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("branch", ["hessenberg", "jacobi-davidson", "lu"])
def test_step_eigen_matches_jax(branch):
    """Three steps from one injected carry: the direct branch through the
    shared Hessenberg form (kernel K2's path), the Jacobi–Davidson branch
    (solver preference forced to GMRES), and the per-candidate LU branch
    (``use_hessenberg=False``)."""
    n, K = 32, 8
    A = _ginibre(n, seed=5)
    cfg_j, cfg_t = _configs(K, dtype=np.complex128, tol=1e-10)
    leaves = _carry(A, cfg_j)
    if branch == "jacobi-davidson":
        leaves = leaves._replace(strat=dataclasses.replace(
            leaves.strat, solver_pref=np.int32(1)))
    Aj = jnp.asarray(A)
    hc_j = hj.reduce_hessenberg_auto(Aj) if branch == "hessenberg" else None
    step_j = jax.jit(lambda p, s: cand_j.step_eigen(cfg_j, Aj, p, s,
                                                    hess_cache=hc_j))
    hc_t = None if hc_j is None else hess_from_numpy(
        jax.tree.map(np.asarray, hc_j), CPU)
    pj, sj = (jax.tree.map(jnp.asarray, leaves.pop),
              jax.tree.map(jnp.asarray, leaves.strat))
    ct = carry_from_numpy(leaves, CPU)
    pt, st = ct.pop, ct.strat
    At = torch.from_numpy(A)
    for _ in range(3):
        pj, stats_j = step_j(pj, sj)
        pt, stats_t = cand_t.step_eigen(cfg_t, At, pt, st, hess_cache=hc_t)
        np.testing.assert_allclose(pt.v.numpy(), np.asarray(pj.v), atol=1e-10)
        np.testing.assert_allclose(pt.lam.numpy(), np.asarray(pj.lam), atol=1e-10)
        np.testing.assert_allclose(pt.residual.numpy(), np.asarray(pj.residual),
                                   atol=1e-10)
        for f in ("status", "stuck", "psi_level"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(pj, f)), err_msg=f)
        assert float(stats_t.solve_fail_frac) == float(stats_j.solve_fail_frac)
        assert float(stats_t.regress_frac) == float(stats_j.regress_frac)
    # the steps did real work: residuals fell from the random start
    assert float(pt.residual.min()) < 1e-2


def _respawn_state(energy):
    """K = 8 slots on a normal 16² operand: slots 0 and 1 converged on two distinct
    eigenpairs, slot 2 a converged duplicate of slot 0, slots 3 and 4
    retired, slot 5 stuck at the retirement cap; the rest exploring."""
    n, K = 16, 8
    # a normal operand with a complex spectrum: its eigenvectors are
    # orthonormal, which the one-pass deflation of fresh vectors assumes
    rng = np.random.default_rng(2)
    V, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    A = (V * w) @ V.conj().T
    cfg_j, cfg_t = _configs(K, dtype=np.complex128, tol=1e-8)
    leaves = _carry(A, cfg_j, seed=4)
    pop = leaves.pop
    v, lam = pop.v.copy(), pop.lam.copy()
    v[0], lam[0] = V[:, 0], w[0]
    v[1], lam[1] = V[:, 1], w[1]
    v[2], lam[2] = V[:, 0] * np.exp(0.3j), w[0] + 1e-9
    C, R = int(CandidateStatus.CONVERGED), int(CandidateStatus.RETIRED)
    status = np.array([C, C, C, R, R, 1, 0, 1], np.int8)
    residual = np.array([1e-12, 2e-12, 3e-12, np.inf, np.inf, 0.5, 0.4, 0.3])
    stuck = np.array([0, 0, 0, 3, 9, 8, 1, 0], np.int32)
    pop = dataclasses.replace(pop, v=v, lam=lam, status=status, stuck=stuck,
                              residual=residual.astype(pop.residual.dtype))
    leaves = leaves._replace(pop=pop)
    spread = float(np.sqrt(np.linalg.norm(A) ** 2 / n
                           - abs(np.trace(A) / n) ** 2))
    center = complex(np.trace(A) / n)
    return A, w, V, cfg_j, cfg_t, leaves, spread, center, energy


@pytest.mark.parametrize("energy", [0.3, 0.9])
def test_eig_respawn_matches_jax_and_keeps_its_promises(energy):
    """Which slots retire and respawn, and every counter, match the JAX
    package exactly; the drawn values differ (different generators), so they
    are held to the rules instead: explorers are orthogonal to the claimed
    eigenvectors and start ≥ 0.05·spread from every claimed λ (or were
    bumped 0.2·spread away); at low landscape energy the even respawned
    slots warm-start near a leader."""
    A, w, V, cfg_j, cfg_t, leaves, spread, center, energy = _respawn_state(energy)
    pj = jax.tree.map(jnp.asarray, leaves.pop)
    sj = jax.tree.map(jnp.asarray, leaves.strat)
    ct = carry_from_numpy(leaves, CPU)
    dj = strat_j.compute_diagnostics(cfg_j, pj, sj, 8)
    dt = strat_t.compute_diagnostics(cfg_t, ct.pop, ct.strat, 8)
    np.testing.assert_array_equal(dt.distinct_leader.numpy(),
                                  np.asarray(dj.distinct_leader))
    np.testing.assert_array_equal(dt.duplicate.numpy(), np.asarray(dj.duplicate))
    assert dt.distinct_leader.tolist() == [True, True] + [False] * 6
    dj = dj._replace(landscape_energy=jnp.float32(energy))
    dt = dataclasses.replace(dt, landscape_energy=torch.tensor(energy))

    out_j = pop_j.manage(cfg_j, pj, sj, dj, 8, lam_scale=spread, lam_center=center)
    out_t = pop_t.manage(cfg_t, ct.pop, ct.strat, dt, 8,
                         lam_scale=torch.tensor(spread, dtype=torch.float32),
                         lam_center=torch.tensor(center, dtype=torch.complex128))
    for f in ("status", "stuck", "psi_level", "retire_count", "weight", "alpha",
              "residual"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy(),
                                      np.asarray(getattr(out_j, f)), err_msg=f)
    respawned = out_t.retire_count.numpy() > ct.pop.retire_count.numpy()
    # slot 2 (duplicate), 3 and 4 (retired) and 5 (pruned) all come back
    assert respawned.tolist() == [False, False, True, True, True, True, False, False]
    keep = ~respawned
    np.testing.assert_array_equal(out_t.v.numpy()[keep], ct.pop.v.numpy()[keep])

    rows = np.flatnonzero(respawned).tolist()
    # the explorers' shifts before the bump, drawn from the slots' own
    # streams (the spread is carried in float32, as in the JAX package)
    fresh = rng_t.normal_scalars(ct.pop.keys, rows, torch.complex128, CPU,
                                 stream=pop_t._FRESH_LAM).numpy() \
        * float(np.float32(spread)) + center
    v_new, lam_new = out_t.v.numpy(), out_t.lam.numpy()
    claimed = w[:2]
    for r, f0 in zip(rows, fresh):
        assert abs(np.linalg.norm(v_new[r]) - 1.0) < 1e-12
        warm = energy < 0.8 and r % 2 == 0
        if warm:
            overlap = np.abs(V[:, :2].conj().T @ v_new[r])
            assert overlap.max() > 0.9
            assert np.min(np.abs(lam_new[r] - claimed)) < 0.05 * (0.1 + energy) * 5
        else:
            assert np.max(np.abs(V[:, :2].conj().T @ v_new[r])) < 1e-12
            step = abs(lam_new[r] - f0)
            if step <= 1e-12:
                assert np.min(np.abs(lam_new[r] - claimed)) >= 0.05 * spread
            else:
                assert step == pytest.approx(0.2 * spread, rel=1e-6)
                assert np.min(np.abs(f0 - claimed)) < 0.05 * spread


def test_eig_respawn_bumps_a_shift_that_lands_on_a_claimed_eigenvalue():
    """Plant a leader's λ exactly where an explorer's fresh shift will land:
    the explorer is bumped 0.2·spread away (the JAX package's rule)."""
    A, w, V, cfg_j, cfg_t, leaves, spread, center, _ = _respawn_state(0.9)
    ct = carry_from_numpy(leaves, CPU)
    fresh = rng_t.normal_scalars(ct.pop.keys, [3], torch.complex128, CPU,
                                 stream=pop_t._FRESH_LAM).numpy()[0] \
        * float(np.float32(spread)) + center
    ct.pop.lam[1] = fresh
    dt = strat_t.compute_diagnostics(cfg_t, ct.pop, ct.strat, 8)
    dt = dataclasses.replace(dt, landscape_energy=torch.tensor(0.9))
    out = pop_t.manage(cfg_t, ct.pop, ct.strat, dt, 8,
                       lam_scale=torch.tensor(spread, dtype=torch.float32),
                       lam_center=torch.tensor(center, dtype=torch.complex128))
    assert abs(out.lam[3].item() - fresh) == pytest.approx(0.2 * spread, rel=1e-6)


def test_refine_eigenpairs_matches_jax():
    """Crude complex64 starts (vectors 1e-3 off, λ 1e-3 off) of six
    eigenpairs of a 64² Ginibre matrix: both finishers reach the FP64 floor
    and agree on λ."""
    n, K = 64, 6
    A = _ginibre(n, seed=9)
    w, V = np.linalg.eig(A)
    rng = np.random.default_rng(1)
    idx = rng.choice(n, K, replace=False)
    V0 = V[:, idx].T + 1e-3 * (rng.standard_normal((K, n))
                               + 1j * rng.standard_normal((K, n))) / np.sqrt(n)
    lam0 = w[idx] + 1e-3
    V0, lam0 = V0.astype(np.complex64), lam0.astype(np.complex64)
    lj, Vj, rj = refine_j(SplitComplex(jnp.asarray(A.real), jnp.asarray(A.imag)),
                          jnp.asarray(lam0), jnp.asarray(V0), steps=5)
    lam_j = np.asarray(lj.re) + 1j * np.asarray(lj.im)
    lt, Vt, rt = refine_t(torch.from_numpy(A), torch.from_numpy(lam0),
                          torch.from_numpy(V0), steps=5)
    assert lt.dtype == Vt.dtype == torch.complex128 and rt.dtype == torch.float64
    lam_t, V_t, r_t = lt.numpy(), Vt.numpy(), rt.numpy()
    assert np.max(np.asarray(rj)) <= 1e-12 and np.max(r_t) <= 1e-12
    np.testing.assert_allclose(lam_t, lam_j, atol=1e-10)
    np.testing.assert_allclose(lam_t, w[idx], atol=1e-10)
    for k in range(K):
        indep = np.linalg.norm(A @ V_t[k] - lam_t[k] * V_t[k])
        assert indep <= 1e-12 and abs(np.linalg.norm(V_t[k]) - 1) < 1e-12


def test_scenario2a_all_eight_in_both_packages():
    """Reference scenario 2A (tests/test_solver_e2e.py): all 8 eigenpairs of
    the general complex Laplace-like operator, λ within 1e-5 of
    ``np.linalg.eigvals``, in both packages."""
    A = gen.laplace_like_complex(8, make_hermitian=False)
    w_true = np.sort_complex(np.linalg.eigvals(A))
    rj = maus_tpu.eig(A, tol=1e-7, max_iterations=80, num_candidates=30)
    rt = maus_tpu_torch.eig(A, tol=1e-7, max_iterations=80, num_candidates=30,
                            device="cpu")
    for rep in (rj, rt):
        assert rep.num_distinct == rep.target_solutions == 8
        w_found = np.sort_complex(np.array([s[0] for s in rep.solutions]))
        assert np.max(np.abs(w_true - w_found)) < 1e-5
        for lam, v in rep.solutions:
            assert np.linalg.norm(A @ v - lam * v) < 1e-6
    assert rt.timings is not None and set(rt.timings) == {"setup_s", "engine_s",
                                                         "finish_s"}


def test_general_gaussian_eig_residuals():
    """As tests/test_solver_e2e.py holds the JAX package: a 16×16 complex
    Gaussian at tol 1e-6 with 48 candidates, most of the spectrum found and
    every pair's residual below 1e-5."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    rep = maus_tpu_torch.eig(A, tol=1e-6, max_iterations=150, num_candidates=48,
                             device="cpu")
    assert rep.num_distinct >= 8
    for lam, v in rep.solutions:
        assert np.linalg.norm(A @ v - lam * v) < 1e-5


@pytest.mark.parametrize("use_hessenberg", [True, False])
def test_eig_in_the_cards_working_dtype(use_hessenberg):
    """complex64 working dtype on the CPU at the card's eig floor
    min(max(50, √N)·ε₃₂, 1e-2): the engine accepts pairs at that floor and
    the FP64 finisher takes them to tol; the same in the JAX package. With
    ``use_hessenberg=False`` every shifted solve is a per-candidate LU."""
    A = gen.laplace_like_complex(8, make_hermitian=False)
    floor = eig_convergence_floor(torch.complex64, 8)
    cfg = maus_tpu_torch.SolverConfig(dtype=torch.complex64, convergence_floor=floor,
                                      use_hessenberg=use_hessenberg)
    rt = maus_tpu_torch.eig(torch.from_numpy(A.astype(np.complex64)), tol=1e-7,
                            max_iterations=80, num_candidates=30, config=cfg,
                            device="cpu")
    rj = maus_tpu.eig(A.astype(np.complex64), tol=1e-7, max_iterations=80,
                      num_candidates=30, config=maus_tpu.SolverConfig(
                          dtype=jnp.complex64, convergence_floor=floor,
                          use_hessenberg=use_hessenberg))
    w_true = np.sort_complex(np.linalg.eigvals(A.astype(np.complex64)
                                               .astype(np.complex128)))
    for rep in (rj, rt):
        assert rep.num_distinct == 8
        w_found = np.sort_complex(np.array([s[0] for s in rep.solutions]))
        assert np.max(np.abs(w_true - w_found)) < 1e-5
        assert max(rep.residuals) <= 1e-7


def test_eig_target_and_knowledge():
    """The target defaults to N and is clamped to the population; a given
    ProblemKnowledge skips the diagnosis."""
    A = _ginibre(12, seed=0)
    rep = maus_tpu_torch.eig(A, tol=1e-8, num_candidates=6, max_iterations=60,
                             device="cpu")
    assert rep.target_solutions == 6 and rep.num_distinct == 6
    kn = maus_tpu_torch.ProblemKnowledge(shape=A.shape, cond_estimate=10.0)
    rep2 = maus_tpu_torch.eig(A, tol=1e-8, num_candidates=8, target_solutions=3,
                              knowledge=kn, device="cpu")
    assert rep2.knowledge is kn and rep2.target_solutions == 3
    assert rep2.num_distinct >= 3
    for lam, v in rep2.solutions:
        assert np.linalg.norm(A @ v - lam * v) <= 1e-8


def test_hermitian_eig_and_svd_are_not_ported():
    """Both are ported now (SVD in the third slice, Hermitian eig in the
    fourth): a Hermitian operand runs through the Hermitian path (held to
    the JAX package in tests/test_torch_hermitian.py) and the SVD solver
    constructs (tests/test_torch_svd.py)."""
    A = gen.laplace_like_complex(8, make_hermitian=True)
    rep = maus_tpu_torch.eig(A, tol=1e-7, num_candidates=30, max_iterations=50,
                             device="cpu")
    assert rep.knowledge.is_hermitian and rep.num_distinct == 8
    for lam, v in rep.solutions:
        assert abs(lam.imag) < 1e-12 and np.linalg.norm(A @ v - lam * v) < 1e-7
    s = maus_tpu_torch.MausSolver(gen.low_rank_svd_matrix(5, 4),
                                  maus_tpu_torch.ProblemType.SVD, device="cpu")
    assert s.knowledge.shape == (5, 4) and s.knowledge.effective_rank == 2
