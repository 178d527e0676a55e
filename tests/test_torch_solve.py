"""The slice end to end: ``maus_tpu_torch.solve`` against ``maus_tpu.solve`` on
the same numpy systems, in the default working dtype (complex128 on the CPU)
and in complex64, the card's working dtype.

The two packages draw different random initial populations, so their iterates
are compared by outcome: the same convergence verdict and report fields, both
solutions within tol by an independent numpy complex128 residual, and
‖x_port − x_jax‖ ≤ 10·κ·tol·‖x_jax‖ (each is certified within tol in residual,
hence within κ·tol of the exact solution).

complex64 runs use one explicit config for both packages: the convergence
floor max(50, 2κ)·ε₃₂ and 60 refinement steps, as the JAX package's bench
configures its headline solve."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import maus_tpu
from maus_tpu.problems import generators as gen
import maus_tpu_torch
from maus_tpu.solver import diagnose as dj
from maus_tpu.utils import truth as tj
from maus_tpu_torch.solver import diagnose as dt
from maus_tpu_torch.solver.api import convergence_floor
from maus_tpu_torch.utils import truth as tt

torch.set_num_threads(1)

TOL = 1e-8
EPS32 = float(np.finfo(np.float32).eps)

SYSTEMS = {
    "ill-64-1e2": lambda: gen.ill_conditioned_system(64, 1e2),
    "ill-64-1e6": lambda: gen.ill_conditioned_system(64, 1e6),
    "ill-256-1e2": lambda: gen.ill_conditioned_system(256, 1e2),
    "ill-256-1e6": lambda: gen.ill_conditioned_system(256, 1e6),
    "well-64": lambda: gen.well_conditioned_system(64),
    "hpd-64": lambda: _hpd_system(64),
}


def _hpd_system(n, seed=7):
    """Hermitian positive definite: diagnosis sends it down the Cholesky path."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return B @ B.conj().T / n + 0.1 * np.eye(n), b


def _c64_configs(kappa):
    floor = float(max(50.0, 2.0 * kappa) * EPS32)
    return (maus_tpu.SolverConfig(dtype=jnp.complex64, convergence_floor=floor,
                                  max_refine_steps=60),
            maus_tpu_torch.SolverConfig(dtype=torch.complex64,
                                        convergence_floor=floor,
                                        max_refine_steps=60))


def _rel(A, x, b):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["default", "complex64"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_solve_matches_jax(system, dtype):
    A, b = SYSTEMS[system]()
    kappa = float(np.linalg.cond(A))
    cfg_j = cfg_t = None
    if dtype == "complex64":
        cfg_j, cfg_t = _c64_configs(kappa)
    kw = dict(tol=TOL, max_iterations=50, num_candidates=16)
    rj = maus_tpu.solve(A, b, config=cfg_j, **kw)
    rt = maus_tpu_torch.solve(A, b, config=cfg_t, device="cpu", **kw)

    assert rt.converged == rj.converged
    assert rt.converged
    for f in ("problem_type", "num_distinct", "target_solutions"):
        assert int(getattr(rt, f)) == int(getattr(rj, f)), f
    assert rt.knowledge.cond_estimate == pytest.approx(rj.knowledge.cond_estimate,
                                                       rel=1e-9)
    for f in ("shape", "is_hermitian", "is_complex_symmetric", "is_sparse_input",
              "is_positive_definite", "is_singular"):
        assert getattr(rt.knowledge, f) == getattr(rj.knowledge, f), f
    assert len(rt.solutions) == len(rt.residuals) == rt.num_distinct

    x_t, x_j = rt.best()[0], rj.best()[0]
    assert x_t.dtype == np.complex128 and x_t.shape == b.shape
    assert _rel(A, x_t, b) <= TOL and _rel(A, x_j, b) <= TOL
    assert min(rt.residuals) <= TOL
    # the report's residual is the certified one, up to its FP64 rounding
    bar = 1e-15 * np.linalg.norm(A) * np.linalg.norm(x_t) / np.linalg.norm(b)
    assert abs(min(rt.residuals) - _rel(A, x_t, b)) <= bar
    assert np.linalg.norm(x_t - x_j) <= 10 * kappa * TOL * np.linalg.norm(x_j)


def test_solve_accepts_tensors_and_keeps_their_device():
    """A tensor input runs where ``device`` says: a CPU tensor with
    ``device="cpu"`` stays on the CPU, in the CPU's complex128 working dtype
    (without ``device`` it would go to the card, see the tests below)."""
    A, b = gen.well_conditioned_system(32, seed=5)
    At = torch.from_numpy(A.astype(np.complex64))
    bt = torch.from_numpy(b.astype(np.complex64))
    s = maus_tpu_torch.MausSolver(At, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=bt, device="cpu")
    assert s.device.type == "cpu" and s.config.dtype == torch.complex128
    rep = s.evolve(50)
    assert rep.converged and _rel(A.astype(np.complex64), rep.best()[0], b.astype(
        np.complex64)) <= TOL


def test_default_device_raises_without_cuda():
    """Without ``device`` the entry points run on the card; where there is
    none they raise and name ``device="cpu"`` instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    A, b = gen.well_conditioned_system(8)
    calls = (lambda: maus_tpu_torch.solve(A, b),
             lambda: maus_tpu_torch.solve(torch.from_numpy(A), torch.from_numpy(b)),
             lambda: maus_tpu_torch.eig(A),
             lambda: maus_tpu_torch.MausSolver(
                 A, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b))
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.cuda
def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, b = gen.well_conditioned_system(32, seed=5)
    s = maus_tpu_torch.MausSolver(A, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=torch.from_numpy(b))
    assert s.device.type == "cuda" and s.config.dtype == torch.complex64
    At = torch.from_numpy(A).to("cuda")
    s = maus_tpu_torch.MausSolver(At, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=b)
    assert s.device == At.device


def test_convergence_floor_policy():
    assert convergence_floor(torch.complex128, 1e6) == 0.0
    assert convergence_floor(torch.complex64, 1.0) == pytest.approx(50 * EPS32)
    assert convergence_floor(torch.complex64, 1e6) == pytest.approx(2e6 * EPS32)
    assert convergence_floor(torch.complex64, float("inf")) == 1.0


def test_floor_cap_divergence_from_reference():
    """Recorded divergence: the JAX package caps the complex64 floor at 1e-2,
    below what a complex64 solve reaches on this κ = 1e6 system, so its
    candidates stall and ``solve`` returns no solution. The port runs the same
    engine (with the reference's floor it stalls the same way) but its floor
    policy accepts at max(50, 2κ)·ε₃₂ and refinement certifies tol."""
    A, b = gen.ill_conditioned_system(256, 1e6, seed=0)
    kappa = float(np.linalg.cond(A))
    ref_floor = float(min(max(50.0, 2.0 * kappa) * EPS32, 1e-2))
    kw = dict(tol=TOL, max_iterations=50, num_candidates=16)
    rj = maus_tpu.solve(A, b, config=maus_tpu.SolverConfig(
        dtype=jnp.complex64, convergence_floor=ref_floor), **kw)
    assert not rj.converged and rj.solutions == []
    rt_ref = maus_tpu_torch.solve(A, b, config=maus_tpu_torch.SolverConfig(
        dtype=torch.complex64, convergence_floor=ref_floor), device="cpu", **kw)
    assert not rt_ref.converged
    rt = maus_tpu_torch.solve(A, b, config=maus_tpu_torch.SolverConfig(
        dtype=torch.complex64,
        convergence_floor=convergence_floor(torch.complex64, kappa)),
        device="cpu", **kw)
    assert rt.converged and _rel(A, rt.best()[0], b) <= TOL


def test_duplicate_detection_divergence_from_reference():
    """Recorded divergence: on κ = 1e6 systems, K bitwise-identical converged
    candidates of norm 1e6 to 1e8 in complex64. The JAX package decides
    ‖x_i − x_j‖ < 100·tol from ‖x_i‖² + ‖x_j‖² − 2·Re⟨x_i, x_j⟩, whose f32
    cancellation noise (~ε·‖x‖², far above (100·tol)²) decides the answer
    by its sign: where it rounds up, the JAX package counts all K as
    distinct. The port takes the differences themselves and counts one on
    every input."""
    import dataclasses

    import jax

    from maus_tpu.solver import evolve as ej
    from maus_tpu.solver import strategy as sj
    from maus_tpu_torch.solver import strategy as st
    from maus_tpu_torch.utils.convert import carry_from_numpy

    K = 16
    cfg_j = maus_tpu.SolverConfig(dtype=jnp.complex64, num_candidates=K)
    cfg_t = maus_tpu_torch.SolverConfig(dtype=torch.complex64, num_candidates=K)
    counts_j = []
    for n, seed, norm in ((64, 2, 1e7), (64, 0, 1e6), (128, 1, 1e6), (64, 3, 1e8)):
        A, b = gen.ill_conditioned_system(n, 1e6, seed=seed)
        x = np.linalg.solve(A, b)
        x = (x * (norm / np.linalg.norm(x))).astype(np.complex64)
        kn = maus_tpu.ProblemKnowledge(shape=A.shape, cond_estimate=1e6)
        carry = ej.init_carry(cfg_j, kn, jnp.asarray(A.astype(np.complex64)),
                              jax.random.PRNGKey(0))
        leaves = jax.tree.map(np.asarray, carry)
        pop = dataclasses.replace(
            leaves.pop, v=np.tile(x, (K, 1)),
            status=np.full(K, int(maus_tpu.core.types.CandidateStatus.CONVERGED),
                           np.int8),
            residual=np.full(K, 1e-9, np.float32))
        leaves = leaves._replace(pop=pop)
        dj_ = sj.compute_diagnostics(cfg_j, jax.tree.map(jnp.asarray, pop),
                                     jax.tree.map(jnp.asarray, leaves.strat), 1)
        counts_j.append(int(dj_.num_distinct))
        ct = carry_from_numpy(leaves, torch.device("cpu"))
        dt_ = st.compute_diagnostics(cfg_t, ct.pop, ct.strat, 1)
        assert int(dt_.num_distinct) == 1
        assert int(dt_.duplicate.sum()) == K - 1
    assert max(counts_j) == K


def test_rejects_what_is_not_ported():
    """SVD and Hermitian eig are ported (the SVD solver constructs, a
    Hermitian eig runs), and malformed operands raise ValueError."""
    A, b = gen.well_conditioned_system(8)
    s = maus_tpu_torch.MausSolver(A, maus_tpu_torch.ProblemType.SVD, device="cpu")
    assert s.knowledge.effective_rank == 8
    rep = maus_tpu_torch.eig(gen.hermitian_matrix(8), device="cpu")
    assert rep.knowledge.is_hermitian and rep.num_distinct == 8
    with pytest.raises(ValueError):
        maus_tpu_torch.solve(A[:, :6], b, device="cpu")
    with pytest.raises(ValueError):
        maus_tpu_torch.solve(A, b[:5], device="cpu")
    with pytest.raises(ValueError):
        maus_tpu_torch.eig(A[:, :6], device="cpu")
    bad = A.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError):
        maus_tpu_torch.solve(bad, b, device="cpu")


@pytest.mark.parametrize("kind", ["general", "hermitian-pd", "hermitian-indefinite",
                                  "complex-symmetric", "sparse"])
def test_diagnose_matches_jax(kind):
    rng = np.random.default_rng(11)
    n = 48
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = {"general": B,
         "hermitian-pd": B @ B.conj().T + np.eye(n),
         "hermitian-indefinite": B + B.conj().T,
         "complex-symmetric": B + B.T,
         "sparse": np.diag(np.arange(1.0, n + 1)) + 0j}[kind]
    kj = dj.diagnose(A, maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM)
    kt = dt.diagnose(A, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM)
    for f in ("shape", "is_hermitian", "is_complex_symmetric", "is_sparse_input",
              "is_positive_definite", "is_singular", "density"):
        assert getattr(kt, f) == getattr(kj, f), f
    assert kt.cond_estimate == pytest.approx(kj.cond_estimate, rel=1e-9)
    # the device path (complex64-exact working copy) classifies the same way
    A64 = A.astype(np.complex64)
    kd = dt.diagnose(None, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM,
                     device_operand=torch.from_numpy(A64), device_exact=True)
    kh = dt.diagnose(A64, maus_tpu_torch.ProblemType.SOLVE_LINEAR_SYSTEM)
    for f in ("is_hermitian", "is_complex_symmetric", "is_sparse_input",
              "is_positive_definite", "density"):
        assert getattr(kd, f) == getattr(kh, f), f


@pytest.mark.parametrize("kappa", [1e2, 1e4])
def test_device_cond_probe(kappa):
    """The on-device probe (used above 512², and for tensor inputs) estimates
    κ within a factor 4 of the exact value while complex64 IR resolves it,
    like the JAX package's probe on the same operand."""
    A, _ = gen.ill_conditioned_system(128, kappa, seed=1)
    A64 = A.astype(np.complex64)
    exact = np.linalg.cond(A64.astype(np.complex128))
    est_t = dt.estimate_cond_device(torch.from_numpy(A64))
    est_j = dj.estimate_cond_device(jnp.asarray(A64))
    for est in (est_t, est_j):
        assert exact / 4 <= est <= exact * 4


@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6, 1e13])
def test_cond_probe_rinv_form_matches_triangular_form(kappa):
    """The probe's one form (the linear path's QR bundle: reflectors and an
    explicit R⁻¹, on every device and size) estimates κ within the factor 4
    of :func:`test_device_cond_probe` of the exact value while complex64 IR
    resolves κ, and answers ∞ at κ = 1e13, past what a complex64
    factorization can resolve."""
    A, _ = gen.ill_conditioned_system(256, kappa, seed=1)
    A64 = A.astype(np.complex64)
    est = dt._cond_from_probe(dt._cond_probe_device(torch.from_numpy(A64)))
    if kappa > 1e10:
        assert est == np.inf
    else:
        exact = np.linalg.cond(A64.astype(np.complex128))
        assert exact / 4 <= est <= exact * 4


def test_cond_probe_one_residual_per_iterate(monkeypatch):
    """Each IR solve of the probe computes 1 + ir_steps FP64 residuals, each
    through K1's entry on the complex64 operand (no widened copy): at the
    defaults 6 inverse iterations × 2 solves × 11 = 132 (two products an IR
    step made 252)."""
    from maus_tpu_torch.ops.kernels import residual

    seen = []
    real = residual.true_residual

    def counting(A, x, b):
        seen.append(A.dtype)
        return real(A, x, b)

    monkeypatch.setattr(residual, "true_residual", counting)
    A, _ = gen.ill_conditioned_system(64, 1e4, seed=2)
    dt._cond_probe_device(torch.from_numpy(A.astype(np.complex64)))
    assert len(seen) == 6 * 2 * (1 + 10) == 132
    assert set(seen) == {torch.complex64}


def test_truth_report_matches_jax():
    """utils/truth on the port's report gives what the JAX package's gives."""
    A, b = gen.well_conditioned_system(32, seed=9)
    rep = maus_tpu_torch.solve(A, b, tol=1e-10, device="cpu")
    rt_ = tt.compare(rep, A, b)
    rj_ = tj.compare(rep, A, b)
    assert rt_.matched == rj_.matched == 1 and rt_.total_found == 1
    assert rt_.max_abs_error == rj_.max_abs_error <= 1e-9
    np.testing.assert_array_equal(tt.compute_truth(A, rep.problem_type, b),
                                  tj.compute_truth(A, maus_tpu.ProblemType(
                                      int(rep.problem_type)), b))
