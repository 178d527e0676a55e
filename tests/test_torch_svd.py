"""The port's SVD path against the JAX package.

Layer by layer from identical state (the two packages draw different random
numbers, so state is injected, not drawn): ``step_svd`` in both of its modes
from a JAX carry (``carry_from_numpy``), the SVD arms of
``compute_diagnostics`` (leaders, the tiny-σ exclusion, the dynamic
effective-rank target) and ``population.manage``, and the FP64 finisher
``refine_svd_triplets``. Then ``svd()`` end to end: the reference scenarios
(each package draws its own population and both reach the same triplets),
the headline operand at 256×128 from the JAX package's initial population,
and the reference's exact-rank off-by-one.

Tolerances: complex128 steps agree to 1e-10 (unit vectors and σ of an
‖A‖₂ = 3 operand after three block rounds whose QRs and small SVD are
backward stable to ~1e-15); finished triplets reach the FP64 floor (1e-10
of ‖A‖₂, the JAX package's own bar in tests/test_refine_eig.py), and their
σ agree to 1e-10 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maus_tpu
import maus_tpu_torch
from maus_tpu.ops.refine import SplitComplex
from maus_tpu.ops.refine_eig import refine_svd_triplets as refine_j
from maus_tpu.problems import generators as gen
from maus_tpu.solver import candidate as cand_j
from maus_tpu.solver import evolve as evolve_j
from maus_tpu.solver import population as pop_j
from maus_tpu.solver import strategy as strat_j
from maus_tpu_torch.core.types import CandidateStatus
from maus_tpu_torch.ops.refine_eig import refine_svd_triplets as refine_t
from maus_tpu_torch.solver import candidate as cand_t
from maus_tpu_torch.solver import evolve as evolve_t
from maus_tpu_torch.solver import population as pop_t
from maus_tpu_torch.solver import strategy as strat_t
from maus_tpu_torch.utils.convert import carry_from_numpy

torch.set_num_threads(1)

SVD = maus_tpu.ProblemType.SVD
CPU = torch.device("cpu")


def _haar(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _operand(m, n, sig, seed=0):
    """U·diag(σ)·Vᴴ with Haar U, V (phases fixed), as the JAX package's SVD
    probe builds its operand (benchmarks/spectral_large_probe.py)."""
    rng = np.random.default_rng(seed)
    U = _haar(rng, m)[:, :n]
    V = _haar(rng, n)
    return (U * sig) @ V.conj().T, U, V


def _headline(m, n, top):
    """The headline spectrum cut to (m, n): σ = 0.8^k for k < top, then
    logspace(−2, −4) for the rest."""
    sig = np.concatenate([0.8 ** np.arange(top), np.logspace(-2, -4, n - top)])
    return _operand(m, n, sig)[0], sig


def _configs(K, **kw):
    return (maus_tpu.SolverConfig(problem_type=SVD, num_candidates=K, **kw),
            maus_tpu_torch.SolverConfig(problem_type=SVD, num_candidates=K, **kw))


def _carry(A, cfg_j, seed=1):
    kn = maus_tpu.ProblemKnowledge(shape=A.shape, cond_estimate=10.0,
                                   effective_rank=min(A.shape))
    return jax.tree.map(np.asarray, evolve_j.init_carry(
        cfg_j, kn, jnp.asarray(A), jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("orthogonalize", [True, False])
def test_step_svd_matches_jax(orthogonalize):
    """Three steps from one injected carry, complex128: the block
    Rayleigh–Ritz round and the per-candidate alternating power
    iteration."""
    A = _operand(24, 16, np.linspace(3.0, 0.1, 16), seed=2)[0]
    cfg_j, cfg_t = _configs(6, dtype=np.complex128, tol=1e-10,
                            orthogonalize=orthogonalize)
    leaves = _carry(A, cfg_j)
    Aj = jnp.asarray(A)
    step_j = jax.jit(lambda p, s: cand_j.step_svd(cfg_j, Aj, p, s))
    pj, sj = (jax.tree.map(jnp.asarray, leaves.pop),
              jax.tree.map(jnp.asarray, leaves.strat))
    ct = carry_from_numpy(leaves, CPU)
    pt, st = ct.pop, ct.strat
    assert pt.u is not None and pt.u.shape == (6, 24)
    At = torch.from_numpy(A)
    first = None
    for _ in range(3):
        pj, stats_j = step_j(pj, sj)
        pt, stats_t = cand_t.step_svd(cfg_t, At, pt, st)
        for f in ("v", "u", "lam", "residual", "alpha"):
            np.testing.assert_allclose(getattr(pt, f).numpy(),
                                       np.asarray(getattr(pj, f)), atol=1e-10,
                                       err_msg=f)
        for f in ("status", "stuck", "psi_level"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(pj, f)), err_msg=f)
        assert float(stats_t.solve_fail_frac) == float(stats_j.solve_fail_frac)
        assert float(stats_t.regress_frac) == float(stats_j.regress_frac)
        first = pt.residual.clone() if first is None else first
    # the steps did real work: the best residual fell after the first step
    assert float(pt.residual.min()) < float(first.min())


def _svd_state(floor_converged):
    """K = 8 slots on a 12×8 operand with σ = 3, 2, 1, ...: slots 0-2
    converged on the top three triplets, slot 3 a converged phase-rotated
    duplicate of slot 0, slot 4 converged at a tiny σ (1e-6, below
    σ_rel·σ_max), slot 5 converged at σ = 0 (a null triplet), slot 6
    exploring, slot 7 retired. With ``floor_converged=False`` slots 4 and 5
    are exploring instead."""
    sig = np.array([3.0, 2.0, 1.0, 0.5, 0.2, 0.1, 0.05, 1e-6])
    A, U, V = _operand(12, 8, sig, seed=4)
    cfg_j, cfg_t = _configs(8, dtype=np.complex128, tol=1e-8)
    leaves = _carry(A, cfg_j, seed=3)
    pop = leaves.pop
    u, v, lam = pop.u.copy(), pop.v.copy(), pop.lam.copy()
    for k in range(3):
        u[k], v[k], lam[k] = U[:, k], V[:, k], sig[k]
    u[3], v[3], lam[3] = U[:, 0] * np.exp(0.4j), V[:, 0] * np.exp(0.4j), 3.0 + 1e-9
    u[4], v[4], lam[4] = U[:, 7], V[:, 7], 1e-6
    v[5], lam[5] = V[:, 7], 0.0
    C, R, E = (int(CandidateStatus.CONVERGED), int(CandidateStatus.RETIRED),
               int(CandidateStatus.EXPLORING))
    s45 = C if floor_converged else E
    status = np.array([C, C, C, C, s45, s45, E, R], np.int8)
    residual = np.array([1e-12, 2e-12, 3e-12, 4e-12, 5e-12, 6e-12, 0.3, np.inf])
    pop = dataclasses.replace(pop, u=u, v=v, lam=lam, status=status,
                              residual=residual.astype(pop.residual.dtype))
    return A, cfg_j, cfg_t, leaves._replace(pop=pop)


@pytest.mark.parametrize("floor_converged", [True, False])
def test_compute_diagnostics_svd_matches_jax(floor_converged):
    A, cfg_j, cfg_t, leaves = _svd_state(floor_converged)
    pj = jax.tree.map(jnp.asarray, leaves.pop)
    sj = jax.tree.map(jnp.asarray, leaves.strat)
    ct = carry_from_numpy(leaves, CPU)
    dj = strat_j.compute_diagnostics(cfg_j, pj, sj, 8)
    dt = strat_t.compute_diagnostics(cfg_t, ct.pop, ct.strat, 8)
    for f in ("distinct_leader", "duplicate", "num_distinct", "target_dynamic",
              "stability"):
        np.testing.assert_array_equal(np.asarray(getattr(dt, f)),
                                      np.asarray(getattr(dj, f)), err_msg=f)
    for f in ("avg_residual", "avg_stuckness", "landscape_energy"):
        assert float(getattr(dt, f)) == pytest.approx(float(getattr(dj, f)),
                                                      rel=1e-6), f
    # slot 3 duplicates slot 0; the tiny σ of slot 4 leaves the count but is
    # no duplicate; the null triplet of slot 5 counts
    assert dt.duplicate.tolist() == [False] * 3 + [True] + [False] * 4
    if floor_converged:
        assert dt.distinct_leader.tolist() == [True] * 3 + [False, False, True,
                                                            False, False]
        assert int(dt.num_distinct) == 4
        assert int(dt.target_dynamic) == 3     # floor reached: the rank itself
    else:
        assert int(dt.num_distinct) == 3
        assert int(dt.target_dynamic) == 4     # one more until the floor shows


@pytest.mark.parametrize("floor_converged", [True, False])
def test_svd_respawn_matches_jax(floor_converged):
    """Which slots retire and respawn, and every counter, match the JAX
    package, the spawn budget counted against the dynamic target; respawned
    slots restart at σ = 1 with fresh unit vectors u and v (drawn from the
    port's own streams)."""
    A, cfg_j, cfg_t, leaves = _svd_state(floor_converged)
    pj = jax.tree.map(jnp.asarray, leaves.pop)
    sj = jax.tree.map(jnp.asarray, leaves.strat)
    ct = carry_from_numpy(leaves, CPU)
    dj = strat_j.compute_diagnostics(cfg_j, pj, sj, 8)
    dt = strat_t.compute_diagnostics(cfg_t, ct.pop, ct.strat, 8)
    out_j = pop_j.manage(cfg_j, pj, sj, dj, 8)
    out_t = pop_t.manage(cfg_t, ct.pop, ct.strat, dt, 8)
    for f in ("status", "stuck", "psi_level", "retire_count", "weight", "alpha",
              "residual"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy(),
                                      np.asarray(getattr(out_j, f)), err_msg=f)
    respawned = out_t.retire_count.numpy() > ct.pop.retire_count.numpy()
    assert respawned.any()
    keep = ~respawned
    for f in ("u", "v", "lam"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy()[keep],
                                      getattr(ct.pop, f).numpy()[keep])
    assert np.all(out_t.lam.numpy()[respawned] == 1.0)
    for f in ("u", "v"):
        norms = np.linalg.norm(getattr(out_t, f).numpy()[respawned], axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-12)


def _refine_inputs():
    """The inputs of tests/test_refine_eig.py::TestSvdNewton: five
    triplets of a 40×32 Gaussian matrix, 1e-4 off."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 32)) + 1j * rng.standard_normal((40, 32))
    U, s, Vh = np.linalg.svd(A, full_matrices=False)
    k = 5
    u0 = U[:, :k].T + 1e-4 * (rng.standard_normal((k, 40))
                              + 1j * rng.standard_normal((k, 40)))
    v0 = Vh[:k].conj() + 1e-4 * (rng.standard_normal((k, 32))
                                 + 1j * rng.standard_normal((k, 32)))
    return A, s, u0, v0, s[:k] * (1 + 1e-4)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_refine_svd_triplets_matches_jax(dtype):
    A, s, u0, v0, sig0 = _refine_inputs()
    A64 = SplitComplex(jnp.asarray(A.real), jnp.asarray(A.imag))
    sj, Uj, Vj, rj = refine_j(A64, jnp.asarray(sig0, dtype), jnp.asarray(u0, dtype),
                              jnp.asarray(v0, dtype), steps=6)
    st, Ut, Vt, rt = refine_t(torch.from_numpy(A), torch.from_numpy(sig0.astype(dtype)),
                              torch.from_numpy(u0.astype(dtype)),
                              torch.from_numpy(v0.astype(dtype)), steps=6)
    assert st.dtype == rt.dtype == torch.float64
    assert Ut.dtype == Vt.dtype == torch.complex128
    anorm = s[0]
    assert np.all(np.asarray(rj) < 1e-10 * anorm)
    assert np.all(rt.numpy() < 1e-10 * anorm)
    np.testing.assert_allclose(st.numpy(), s[:5], rtol=1e-10)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-10)
    # a triplet's (u, v) is unique up to one common phase, which the
    # working-dtype solves leave to rounding: align it, then compare
    u_j = np.asarray(Uj.re) + 1j * np.asarray(Uj.im)
    v_j = np.asarray(Vj.re) + 1j * np.asarray(Vj.im)
    ph = np.sum(u_j.conj() * Ut.numpy(), axis=1)
    ph = (ph / np.abs(ph))[:, None]
    np.testing.assert_allclose(Ut.numpy() / ph, u_j, atol=1e-8)
    np.testing.assert_allclose(Vt.numpy() / ph, v_j, atol=1e-8)
    for k in range(5):
        sig, u, v = st[k].item(), Ut[k].numpy(), Vt[k].numpy()
        indep = (np.linalg.norm(A @ v - sig * u)
                 + np.linalg.norm(A.conj().T @ u - sig * v))
        assert indep == pytest.approx(rt[k].item(), rel=1e-6, abs=1e-13)


def test_refine_svd_null_triplet_passes_through():
    """A σ = 0 start is returned unchanged with the residual of the returned
    triplet (tests/test_refine_eig.py's honesty check), in both packages."""
    rng = np.random.default_rng(5)
    m, n = 32, 24
    A = (rng.standard_normal((m, 3)) + 1j * rng.standard_normal((m, 3))) @ \
        (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    u0 = rng.standard_normal((1, m)) + 1j * rng.standard_normal((1, m))
    v0 = rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
    u0 /= np.linalg.norm(u0)
    v0 /= np.linalg.norm(v0)
    c64 = np.complex64
    sj, _, _, rj = refine_j(SplitComplex(jnp.asarray(A.real), jnp.asarray(A.imag)),
                            jnp.zeros(1, c64), jnp.asarray(u0, c64),
                            jnp.asarray(v0, c64), steps=4)
    st, Ut, Vt, rt = refine_t(torch.from_numpy(A), torch.zeros(1, dtype=torch.complex64),
                              torch.from_numpy(u0.astype(c64)),
                              torch.from_numpy(v0.astype(c64)), steps=4)
    assert st.item() == 0.0 == float(np.asarray(sj)[0])
    np.testing.assert_allclose(Vt.numpy(), v0.astype(c64).astype(np.complex128)
                               / np.linalg.norm(v0.astype(c64)), atol=1e-15)
    actual = np.linalg.norm(A @ Vt[0].numpy()) + np.linalg.norm(A.conj().T @ Ut[0].numpy())
    assert rt.item() == pytest.approx(actual, rel=1e-10)
    assert rt.item() == pytest.approx(float(np.asarray(rj)[0]), rel=1e-10)


@pytest.mark.parametrize("args,kw,found", [
    ((5, 4), {}, 2),                               # reference scenario 3
    ((32, 8), dict(target_rank=3, seed=5), 7),
])
def test_svd_reference_scenarios_in_both_packages(args, kw, found):
    """Each package draws its own population; both find the same triplets,
    each at tol by an independent residual."""
    A = gen.low_rank_svd_matrix(*args, **kw)
    rj = maus_tpu.svd(A, tol=1e-6)
    rt = maus_tpu_torch.svd(A, tol=1e-6, device="cpu")
    assert rj.num_distinct == rt.num_distinct == rt.target_solutions == found
    assert rt.converged and rj.converged
    np.testing.assert_allclose(np.sort([s[0] for s in rt.solutions]),
                               np.sort([s[0] for s in rj.solutions]), rtol=1e-10)
    for sig, u, v in rt.solutions:
        assert np.linalg.norm(A @ v - sig * u) + \
            np.linalg.norm(A.conj().T @ u - sig * v) <= 1e-6


def _same_start(monkeypatch, A, **kw):
    """svd() in both packages from the JAX package's initial population:
    the port's ``init_carry`` hands out the JAX carry."""
    s_j = maus_tpu.MausSolver(A, SVD, global_convergence_tol=kw["tol"],
                              initial_num_candidates=kw["num_candidates"],
                              target_solutions=kw["target_solutions"])
    leaves = jax.tree.map(np.asarray, evolve_j.init_carry(
        s_j.config, s_j.knowledge, s_j.A, s_j._key))
    monkeypatch.setattr(evolve_t, "init_carry",
                        lambda *a, **k: carry_from_numpy(leaves, CPU))
    rj = s_j.evolve(kw["max_iterations"])
    rt = maus_tpu_torch.svd(A, device="cpu", **kw)
    return rj, rt


def test_svd_headline_operand_from_one_start(monkeypatch):
    """The headline operand cut to 256×128 (8 targets, 16 candidates, tol
    1e-6) from the same initial population: the same count, target and
    convergence verdict, σ to 1e-10 relative, the top eight σ = 0.8^k, every
    residual ≤ tol by an independent complex128 residual."""
    A, sig = _headline(256, 128, 8)
    kw = dict(tol=1e-6, max_iterations=100, num_candidates=16, target_solutions=8)
    rj, rt = _same_start(monkeypatch, A, **kw)
    assert rt.num_distinct == rj.num_distinct >= 8
    assert rt.target_solutions == rj.target_solutions
    assert rt.converged == rj.converged
    assert rt.iterations == rj.iterations
    sig_j = np.sort([s[0] for s in rj.solutions])[::-1]
    sig_t = np.sort([s[0] for s in rt.solutions])[::-1]
    np.testing.assert_allclose(sig_t, sig_j, rtol=1e-10)
    np.testing.assert_allclose(sig_t[:8], 0.8 ** np.arange(8), rtol=1e-10)
    for (s, u, v), res in zip(rt.solutions, rt.residuals):
        indep = np.linalg.norm(A @ v - s * u) + np.linalg.norm(A.conj().T @ u - s * v)
        assert res <= 1e-6 and indep <= 1e-6


def test_svd_exact_rank_off_by_one_matches_jax():
    """The reference's off-by-one (ROADMAP Queue 3): three separated σ and a
    slowly converging tail above the rank cut. Both packages find the three,
    keep the target one above (no below-cut σ converges), run every
    iteration and report ``converged=False``; each draws its own
    population."""
    sig = np.concatenate([[1.0, 0.8, 0.6], 0.05 * np.linspace(1, 0.8, 21)])
    A = _operand(48, 24, sig)[0]
    kw = dict(tol=1e-6, max_iterations=40, num_candidates=6)
    rj = maus_tpu.svd(A, **kw)
    rt = maus_tpu_torch.svd(A, device="cpu", **kw)
    for rep in (rj, rt):
        assert rep.num_distinct == 3 and rep.target_solutions == 4
        assert rep.iterations == 40 and not rep.converged
        assert rep.knowledge.effective_rank == 24
    np.testing.assert_allclose(np.sort([s[0] for s in rt.solutions]), [0.6, 0.8, 1.0],
                               rtol=1e-10)


def test_svd_knowledge_and_rank_probe_match_jax():
    """The diagnosis of a rectangular operand: the same shape, density,
    effective rank and condition estimate as the JAX package (host probe,
    exact below 512), and the device sketch of a tensor input."""
    A, _ = _headline(96, 40, 8)
    A[np.abs(A) < 0.002] = 0.0
    kj = maus_tpu.MausSolver(A, SVD).knowledge
    s_t = maus_tpu_torch.MausSolver(A, SVD, device="cpu")
    kt = s_t.knowledge
    assert kt.shape == kj.shape == (96, 40)
    assert kt.effective_rank == kj.effective_rank == 40
    assert kt.density == kj.density
    assert kt.cond_estimate == pytest.approx(kj.cond_estimate, rel=1e-8)
    assert not (kt.is_hermitian or kt.is_complex_symmetric)
    kd = maus_tpu_torch.MausSolver(torch.from_numpy(A), SVD, device="cpu").knowledge
    assert kd.effective_rank == 40 and kd.density == kt.density
    assert kd.cond_estimate == pytest.approx(kj.cond_estimate, rel=1e-6)
    assert s_t.target_solutions == min(40, s_t.config.num_candidates)
