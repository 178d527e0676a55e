"""The port's Hermitian eig path and ``update_problem`` against the JAX
package.

One step of each Hermitian branch from identical state (the packages draw
different random numbers, so the carry is injected with ``carry_from_numpy``,
and eigenvector phases differ between LAPACK builds, so the shared eigh is
the JAX package's, handed over with ``eigh_from_numpy``). Then ``eig`` end to
end in both packages, each drawing its own population, as
tests/test_solver_e2e.py holds the JAX package; then ``update_problem``.

Tolerances, complex128 on operands of norm ~1-10: the shared-eigh step
snaps to the same decomposition in both packages (λ, v within 1e-12, the
residual one matrix product at rounding level, within 1e-12); the Lanczos
step runs the same 32-step recurrence (λ within 1e-10, v within 1e-10 after
aligning its phase, since the Ritz vectors carry the sign LAPACK gives the
tridiagonal's eigenvectors), and its residuals are float32 in both (1e-5
relative)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import maus_tpu
import maus_tpu_torch
from maus_tpu.problems import generators as gen
from maus_tpu.solver import evolve as evolve_j
from maus_tpu.solver import hermitian as herm_j
from maus_tpu_torch.core.types import CandidateStatus
from maus_tpu_torch.ops import lanczos as lanczos_t
from maus_tpu_torch.solver import hermitian as herm_t
from maus_tpu_torch.utils.convert import carry_from_numpy, eigh_from_numpy

torch.set_num_threads(1)

EIG = maus_tpu.ProblemType.EIGENVALUE
CPU = torch.device("cpu")
C = int(CandidateStatus.CONVERGED)


def _state(n, K, seed):
    """A Hermitian operand, both configs, and a JAX carry in which slots 0
    and 1 converged on the two largest-|λ| eigenpairs (so they are claimed)
    and the rest hold random start vectors."""
    A = gen.hermitian_matrix(n, seed=seed)
    w, V = np.linalg.eigh(A)
    cfg_j = maus_tpu.SolverConfig(problem_type=EIG, num_candidates=K,
                                  dtype=np.complex128, tol=1e-10)
    cfg_t = maus_tpu_torch.SolverConfig(problem_type=EIG, num_candidates=K,
                                        dtype=torch.complex128, tol=1e-10)
    kn = maus_tpu.ProblemKnowledge(shape=A.shape, is_hermitian=True,
                                   cond_estimate=10.0)
    leaves = jax.tree.map(np.asarray, evolve_j.init_carry(
        cfg_j, kn, jnp.asarray(A), jax.random.PRNGKey(seed)))
    pop = leaves.pop
    v, lam, status = pop.v.copy(), pop.lam.copy(), pop.status.copy()
    residual = pop.residual.copy()
    for slot, i in enumerate(np.argsort(-np.abs(w))[:2]):
        v[slot], lam[slot], status[slot] = V[:, i], w[i], C
        residual[slot] = 1e-14
    leaves = leaves._replace(pop=dataclasses.replace(
        pop, v=v, lam=lam, status=status, residual=residual))
    return A, cfg_j, cfg_t, leaves


def _jax_state(leaves):
    return (jax.tree.map(jnp.asarray, leaves.pop),
            jax.tree.map(jnp.asarray, leaves.strat))


def _align(Y, ref):
    """Each row of Y times the unit phase that best matches it to ``ref``."""
    p = np.sum(Y.conj() * ref, axis=-1)
    return Y * np.where(np.abs(p) > 0, p / np.maximum(np.abs(p), 1e-300), 1)[:, None]


def test_step_hermitian_matches_jax():
    n, K = 24, 8
    A, cfg_j, cfg_t, leaves = _state(n, K, seed=3)
    Aj = jnp.asarray(A)
    cache_j = herm_j.eigh_setup(Aj)
    cache_t = eigh_from_numpy(jax.tree.map(np.asarray, cache_j), CPU)
    pj, sj = _jax_state(leaves)
    ct = carry_from_numpy(leaves, CPU)
    pj, stats_j = herm_j.step_hermitian(cfg_j, Aj, cache_j, pj, sj)
    pt, stats_t = herm_t.step_hermitian(cfg_t, torch.from_numpy(A), cache_t,
                                        ct.pop, ct.strat)
    for f in ("status", "stuck"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    np.testing.assert_allclose(pt.lam.numpy(), np.asarray(pj.lam), atol=1e-12)
    np.testing.assert_allclose(pt.v.numpy(), np.asarray(pj.v), atol=1e-12)
    np.testing.assert_allclose(pt.residual.numpy(), np.asarray(pj.residual),
                               atol=1e-12)
    np.testing.assert_array_equal(pt.weight.numpy(), np.asarray(pj.weight))
    assert float(stats_t.solve_fail_frac) == float(stats_j.solve_fail_frac) == 0.0
    # every active slot snapped onto an unclaimed eigenpair and converged
    w = np.linalg.eigvalsh(A)
    claimed = ct.pop.lam.numpy()[:2].real
    for lam in pt.lam.numpy()[2:].real:
        assert np.min(np.abs(w - lam)) < 1e-12
        assert np.min(np.abs(claimed - lam)) > 1e-8
    assert (pt.status.numpy() == C).all()


def test_step_hermitian_lanczos_matches_jax():
    n, K = 64, 6
    A, cfg_j, cfg_t, leaves = _state(n, K, seed=4)
    Aj = jnp.asarray(A)
    pj, sj = _jax_state(leaves)
    ct = carry_from_numpy(leaves, CPU)
    calls = lanczos_t.CALLS
    pj, _ = herm_j.step_hermitian_lanczos(cfg_j, Aj, pj, sj)
    pt, _ = herm_t.step_hermitian_lanczos(cfg_t, torch.from_numpy(A),
                                          ct.pop, ct.strat)
    assert lanczos_t.CALLS == calls + 1
    for f in ("status", "stuck"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    lam_j = np.asarray(pj.lam)
    np.testing.assert_allclose(pt.lam.numpy(), lam_j, atol=1e-10)
    np.testing.assert_allclose(_align(pt.v.numpy(), np.asarray(pj.v)),
                               np.asarray(pj.v), atol=1e-10)
    np.testing.assert_allclose(pt.residual.numpy(), np.asarray(pj.residual),
                               rtol=1e-5, atol=1e-12)
    # the picks avoided the claimed eigenvalues (the converged slots keep
    # theirs): no active slot took λ of slot 0 or 1
    claimed = lam_j[:2].real
    for lam in lam_j[2:].real:
        assert np.min(np.abs(claimed - lam)) > 1e-5


def _check_hermitian_pairs(rep, A, lam_tol, res_tol):
    w = np.linalg.eigvalsh(A)
    for lam, v in rep.solutions:
        assert np.min(np.abs(w - lam.real)) < lam_tol
        assert np.linalg.norm(A @ v - lam * v) < res_tol


def test_scenario2b_all_eight_in_both_packages():
    """Reference scenario 2B: all 8 eigenpairs of the Hermitian
    Laplace-like operator through the shared eigh, eigenvalues within 1e-9
    of ``eigvalsh``, in both packages."""
    A = gen.laplace_like_complex(8, make_hermitian=True)
    rj = maus_tpu.eig(A, tol=1e-7, max_iterations=50, num_candidates=30)
    calls = lanczos_t.CALLS
    rt = maus_tpu_torch.eig(A, tol=1e-7, max_iterations=50, num_candidates=30,
                            device="cpu")
    assert lanczos_t.CALLS == calls     # the shared-eigh branch
    w_true = np.sort(np.linalg.eigvalsh(A))
    for rep in (rj, rt):
        assert rep.knowledge.is_hermitian
        assert rep.num_distinct == rep.target_solutions == 8
        w_found = np.sort([s[0].real for s in rep.solutions])
        assert np.max(np.abs(w_true - w_found)) < 1e-9
    assert rt.timings["setup_s"] >= 0.0


def test_hermitian_coverage_exceeds_population_in_both_packages():
    """Capacity 6 < 12 eigenpairs: the target is clamped to 6 and met."""
    A = gen.hermitian_matrix(12, seed=3)
    for rep in (maus_tpu.eig(A, tol=1e-7, max_iterations=40, num_candidates=6),
                maus_tpu_torch.eig(A, tol=1e-7, max_iterations=40,
                                   num_candidates=6, device="cpu")):
        assert rep.num_distinct == rep.target_solutions == 6
        _check_hermitian_pairs(rep, A, 1e-9, 1e-7)


def test_sparse_hermitian_takes_lanczos_in_both_packages():
    """A scipy.sparse Hermitian tridiagonal is diagnosed sparse and takes
    the deflated-Lanczos branch; at least 4 distinct extremal pairs."""
    n = 48
    rng = np.random.default_rng(4)
    d = rng.standard_normal(n) * 3
    off = rng.standard_normal(n - 1) * 0.5
    A_dense = np.diag(d) + np.diag(off, 1) + np.diag(off, -1)
    A = sp.csc_matrix(A_dense)
    rj = maus_tpu.eig(A, tol=1e-6, max_iterations=30, num_candidates=8)
    calls = lanczos_t.CALLS
    rt = maus_tpu_torch.eig(A, tol=1e-6, max_iterations=30, num_candidates=8,
                            device="cpu")
    assert lanczos_t.CALLS - calls == rt.iterations > 0
    for rep in (rj, rt):
        assert rep.knowledge.is_hermitian and rep.knowledge.is_sparse_input
        assert rep.num_distinct >= 4
        _check_hermitian_pairs(rep, A_dense, 1e-5, 1e-5)


def test_eigh_max_n_switches_to_lanczos_in_both_packages():
    """``eigh_max_n = 16`` sends a dense 32² Hermitian operand down the
    Lanczos branch; at least 4 pairs at the dense spectrum's eigenvalues."""
    A = gen.hermitian_matrix(32, seed=5)
    reps = []
    for pkg, dt in ((maus_tpu, np.complex128), (maus_tpu_torch, torch.complex128)):
        cfg = pkg.SolverConfig(problem_type=EIG, num_candidates=8, tol=1e-6,
                               eigh_max_n=16, dtype=dt)
        kw = {} if pkg is maus_tpu else {"device": "cpu"}
        s = pkg.MausSolver(A, EIG, config=cfg, global_convergence_tol=1e-6, **kw)
        calls = lanczos_t.CALLS
        reps.append(s.evolve(max_iterations=30))
        if pkg is maus_tpu_torch:
            assert lanczos_t.CALLS - calls == reps[-1].iterations > 0
    for rep in reps:
        assert rep.num_distinct >= 4
        _check_hermitian_pairs(rep, A, 1e-5, 1e-5)


# -- update_problem -----------------------------------------------------------

def test_update_problem_scenario1_swap():
    """Reference scenario 1: construct on I₅, swap in the dynamic system and
    its b, solve to 1e-7; the knowledge and target follow the new operand as
    in the JAX package."""
    A, b = gen.dynamic_solve_system(5, t_step=19, time_max_iter=20)
    solvers = []
    for pkg, kw in ((maus_tpu, {}), (maus_tpu_torch, {"device": "cpu"})):
        s = pkg.MausSolver(np.eye(5), pkg.ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=np.ones(5), initial_num_candidates=15,
                           global_convergence_tol=1e-7, **kw)
        s.update_problem(matrix=A, b_vector=b)
        solvers.append(s)
    sj, st = solvers
    assert st.target_solutions == sj.target_solutions == 1
    for f in ("shape", "is_hermitian", "is_positive_definite", "is_singular"):
        assert getattr(st.knowledge, f) == getattr(sj.knowledge, f), f
    assert st.knowledge.cond_estimate == pytest.approx(sj.knowledge.cond_estimate,
                                                       rel=1e-6)
    rep = st.evolve(max_iterations=50)
    assert rep.num_distinct >= 1
    x = rep.best()[0]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-7


def test_update_problem_hermitian_swap_keeps_fast_path():
    """A Hermitian operand swapped into a solver built on I₄₈ is diagnosed
    Hermitian and takes the shared-eigh branch (no Lanczos call), with the
    target re-derived from the new operand."""
    rng = np.random.default_rng(3)
    n = 48
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (G + G.conj().T) / 2
    sj = maus_tpu.MausSolver(np.eye(n), EIG, initial_num_candidates=8)
    sj.update_problem(matrix=H)
    st = maus_tpu_torch.MausSolver(np.eye(n), EIG, initial_num_candidates=8,
                                   device="cpu")
    A_true0 = st.A_true
    st.update_problem(matrix=H)
    assert st.knowledge.is_hermitian and sj.knowledge.is_hermitian
    assert st.target_solutions == sj.target_solutions == 8
    assert st.A_true is not A_true0 and st._A64 is None
    calls = lanczos_t.CALLS
    rep = st.evolve(max_iterations=30)
    assert lanczos_t.CALLS == calls
    assert rep.num_distinct >= 1
    lam_true = np.sort(np.linalg.eigvalsh(H))
    for lam, v in rep.solutions:
        assert np.min(np.abs(lam_true - lam.real)) < 1e-6


def test_update_problem_b_only_swap_keeps_the_operand():
    rng = np.random.default_rng(4)
    n = 24
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    s = maus_tpu_torch.MausSolver(A, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=np.ones(n), initial_num_candidates=4,
                                  device="cpu")
    s.evolve(max_iterations=20)
    A0, A_true0, kn0 = s.A, s.A_true, s.knowledge
    b = rng.standard_normal(n)
    s.update_problem(b_vector=b)
    assert s.A is A0 and s.A_true is A_true0 and s.knowledge is kn0
    assert s._fac_cache is None
    np.testing.assert_array_equal(s.b_true.numpy(), b.astype(np.complex128))
    rep = s.evolve(max_iterations=20)
    assert rep.num_distinct >= 1
    x = rep.best()[0]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8


def test_update_problem_b_shape_mismatch_raises():
    s = maus_tpu_torch.MausSolver(np.eye(5), maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=np.ones(5), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        s.update_problem(b_vector=np.ones(6))
