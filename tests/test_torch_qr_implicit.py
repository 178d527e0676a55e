"""The linear path's one QR form (``ops/batched_solve.QRReflectors``).

Every single-operand QR of the port, the engine's, refinement's and the
condition probe's, on the CPU and on the card and at every N, keeps geqrf's
Householder vectors with R⁻¹ and applies Qᴴ (or Q, for a solve by Aᴴ)
block by block from their compact-WY factors. Here the bundle is held to
an explicit Q from ``torch.linalg.qr``: Qᴴ·b, the solutions by A and by Aᴴ
agree to the working precision, the blocks' T reproduce
``torch.linalg.householder_product``, refinement takes the explicit
bundle's number of steps, a solver and its checkpoint template take the
bundle with nothing patched, and a carry holding it survives a checkpoint
bit for bit. The ``cuda``-marked test runs on the card without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_qr_implicit.py``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from maus_tpu_torch.ops import batched_solve as bs
from maus_tpu_torch.ops import refine

torch.set_num_threads(1)

DTYPES = [torch.complex64, torch.complex128]
# (N, nb): nb divides N, nb does not divide N, nb ≥ N
SHAPES = [(64, 16), (64, 48), (64, 64), (200, 40), (200, 64), (200, 256),
          (256, 64), (256, 96), (256, 512)]


def _eps(dtype):
    return torch.finfo(torch.float32 if dtype == torch.complex64 else torch.float64).eps


def _operand(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed + n)
    A = torch.complex(torch.randn(n, n, generator=g, dtype=torch.float64),
                      torch.randn(n, n, generator=g, dtype=torch.float64))
    return (A / n ** 0.5 + 2 * torch.eye(n, dtype=A.dtype)).to(dtype)


def _rhs(shape, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                         torch.randn(shape, generator=g, dtype=torch.float64)).to(dtype)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _implicit(A, nb, monkeypatch):
    monkeypatch.setattr(bs, "wy_block", lambda n: nb)
    return bs.factor_qr(A)


def _explicit(A):
    """The explicit-Q bundle of A, with R⁻¹, from ``torch.linalg.qr``."""
    q, r = torch.linalg.qr(A)
    return bs.QRFactors(q, r, bs.invert_triangular(r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nb", SHAPES)
def test_implicit_bundle_solves_as_the_explicit_q_does(n, nb, dtype, monkeypatch):
    A = _operand(n, dtype)
    fac = _implicit(A, nb, monkeypatch)
    ref = _explicit(A)
    assert isinstance(fac, bs.QRReflectors)
    assert fac.t.shape == (-(-n // nb), nb, nb)
    tol = 20 * _eps(dtype) * n ** 0.5
    for shape in ((n,), (3, n), (2, 2, n)):
        b = _rhs(shape, dtype)
        b0 = b.clone()
        x = bs.solve_qr(fac, b)
        assert torch.equal(b, b0)                     # the right-hand side is not touched
        assert x.shape == b.shape
        assert _rel(x, bs.solve_qr(ref, b)) < tol * torch.linalg.cond(A).item()
        qh = bs.QRReflectors(fac.v, fac.t, torch.eye(n, dtype=dtype))
        assert _rel(bs.solve_qr(qh, b), (ref.q.mH @ b.reshape(-1, n).mT).mT.reshape(shape)) < tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nb", SHAPES)
def test_adjoint_solve_is_q_times_r_inverse_adjoint(n, nb, dtype, monkeypatch):
    """``solve_qr_adj`` gives x = Q·R⁻ᴴ·b, the solve by Aᴴ, as an explicit Q
    and R from ``torch.linalg.qr`` give it, and Q·b alone with R⁻¹ = I."""
    A = _operand(n, dtype, seed=9)
    fac = _implicit(A, nb, monkeypatch)
    q, r = torch.linalg.qr(A)
    tol = 20 * _eps(dtype) * n ** 0.5
    for shape in ((n,), (3, n), (2, 2, n)):
        b = _rhs(shape, dtype, seed=4)
        b0 = b.clone()
        x = bs.solve_qr_adj(fac, b)
        assert torch.equal(b, b0)
        assert x.shape == b.shape
        B = b.reshape(-1, n).mT
        want = q @ torch.linalg.solve_triangular(r.mH, B, upper=False)
        assert _rel(x, want.mT.reshape(shape)) < tol * torch.linalg.cond(A).item()
        assert _rel((A.mH @ x.reshape(-1, n).mT).mT.reshape(shape), b) < tol * 10
        q_only = bs.QRReflectors(fac.v, fac.t, torch.eye(n, dtype=dtype))
        assert _rel(bs.solve_qr_adj(q_only, b), (q @ B).mT.reshape(shape)) < tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nb", SHAPES)
def test_wy_blocks_multiply_to_householder_product(n, nb, dtype, monkeypatch):
    A = _operand(n, dtype, seed=7)
    fac = _implicit(A, nb, monkeypatch)
    a, tau = torch.geqrf(A)
    eye = torch.eye(n, dtype=dtype)
    Q = eye.clone()
    for k in range(fac.t.shape[0]):
        j = k * nb
        w = min(nb, n - j)
        vk = fac.v[:, j:j + w]
        Q = Q @ (eye - vk @ fac.t[k, :w, :w] @ vk.mH)
        assert torch.equal(fac.t[k].triu(), fac.t[k])
        assert not fac.t[k, w:].any() and not fac.t[k, :, w:].any()
    assert _rel(Q, torch.linalg.householder_product(a, tau)) < 20 * _eps(dtype) * n ** 0.5
    assert torch.equal(fac.v, a.tril(-1) + eye)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_reflector_with_tau_zero(dtype, monkeypatch):
    """Columns that are already reduced (zero below a real diagonal) give
    geqrf reflectors with τ = 0, which the T recurrence takes as the
    identity."""
    n, nb = 96, 32
    A = _operand(n, dtype, seed=3)
    A[:, :40] = torch.triu(A[:, :40])
    A.diagonal()[:40] = A.diagonal()[:40].abs() + 1
    _, tau = torch.geqrf(A)
    assert (tau[:39] == 0).all()
    fac = _implicit(A, nb, monkeypatch)
    assert torch.isfinite(torch.view_as_real(fac.t)).all()
    b = _rhs((n,), dtype)
    x = bs.solve_qr(fac, b)
    assert _rel(x, bs.solve_qr(_explicit(A), b)) < \
        100 * _eps(dtype) * torch.linalg.cond(A).item()


def _nan_below(a):
    """``a`` with its strictly lower triangle NaN: a product that read any
    of it, even against a zero, would come out NaN."""
    n = a.shape[-1]
    below = torch.ones(n, n, dtype=torch.bool, device=a.device).tril(-1)
    return a.clone().masked_fill_(below, float("nan"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rinv_reads_only_geqrfs_upper_triangle(dtype):
    A = _operand(300, dtype, seed=5)
    a, _ = torch.geqrf(A)
    rinv = bs.invert_triangular(a)
    assert torch.equal(bs.invert_triangular(_nan_below(a)), rinv)
    assert torch.equal(bs.factor_qr(A).rinv, rinv)
    assert _rel(rinv, bs.invert_triangular(torch.linalg.qr(A)[1])) < 20 * _eps(dtype)


@pytest.mark.parametrize("n", [64, 1100])
def test_the_cpu_takes_the_one_form_at_every_n(n):
    """On the CPU, below the card's old gate of N = 1024 and above it, the
    probe's QR, the shared QR and ``init_carry``'s checkpoint template are
    all the one bundle, with nothing patched."""
    from maus_tpu_torch.core.types import ProblemKnowledge, SolverConfig
    from maus_tpu_torch.solver import evolve

    A = _operand(n, torch.complex64)
    nb = bs.wy_block(n)
    for fac in (bs.factor_qr(A), bs.shared_factor_qr(A, 1e-6)):
        assert isinstance(fac, bs.QRReflectors)
        assert (fac.v.shape, fac.t.shape) == ((n, n), (-(-n // nb), nb, nb))
    template = evolve.init_carry(SolverConfig(dtype=A.dtype),
                                 ProblemKnowledge(shape=(n, n)), A, seed=0,
                                 template=True)
    assert type(template.fac) is bs.QRReflectors
    assert [getattr(template.fac, f).shape for f in ("v", "t", "rinv")] == \
        [(n, n), (-(-n // nb), nb, nb), (n, n)]
    assert all(getattr(template.fac, f).is_meta for f in ("v", "t", "rinv"))
    assert bs.qr_template(n, A.dtype).t.shape == template.fac.t.shape


@pytest.mark.parametrize("n,block", [(64, 64), (1024, 128), (2048, 256), (4096, 512),
                                     (6000, 512), (16384, 512), (100000, 512)])
def test_wy_block_is_a_few_dozen_blocks(n, block):
    assert bs.wy_block(n) == block


def test_shared_factor_shifts_as_the_explicit_form():
    from maus_tpu_torch.ops.regularize import apply_shift

    A = _operand(128, torch.complex128)
    fac = bs.shared_factor_qr(A, 0.25)
    ref = _explicit(apply_shift(A, 0.25))
    b = _rhs((128,), torch.complex128)
    assert _rel(bs.solve_qr(fac, b), bs.solve_qr(ref, b)) < 1e-12
    assert _rel(bs.solve_any(fac, b), bs.solve_any(ref, b)) < 1e-12


def test_refine_split_takes_the_explicit_bundles_steps(monkeypatch):
    from maus_tpu_torch.benchmarks.common import make_system

    n = 256
    A, b = make_system(n, 1e4, 2, torch.device("cpu"))
    b = b.to(torch.complex128)
    steps = {}
    for implicit in (False, True):
        fac = bs.factor_qr(A) if implicit else _explicit(A)
        calls = []

        def counted(f, r, calls=calls):
            calls.append(1)
            return bs.solve_any(f, r)

        monkeypatch.setattr(refine, "solve_any", counted)
        x0 = bs.solve_qr(fac, b.to(A.dtype))
        x, rel = refine.refine_split(A, fac, b, x0, steps=60, tol=1e-10)
        assert rel <= 1e-10
        steps[implicit] = len(calls)
    assert abs(steps[True] - steps[False]) <= 1


def _solver(n=96):
    """A linear MausSolver on the CPU, as it is: its shared factorizations
    take the one form there as on the card."""
    from maus_tpu_torch.solver.api import MausSolver
    from maus_tpu_torch.core.types import ProblemKnowledge, ProblemType

    A, b = _system(n)
    kn = ProblemKnowledge(shape=(n, n), cond_estimate=1e3)
    return MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                      initial_num_candidates=8, knowledge=kn, device="cpu")


def _system(n):
    from maus_tpu_torch.benchmarks.common import make_system

    A, b = make_system(n, 1e3, 4, torch.device("cpu"))
    return A.numpy(), b.numpy()


def test_checkpoint_round_trip_of_the_implicit_bundle(tmp_path):
    from maus_tpu_torch.solver import evolve
    from maus_tpu_torch.utils import checkpoint

    solver = _solver()
    carry = evolve.init_carry(solver.config, solver.knowledge, solver.A, seed=11)
    template = evolve.init_carry(solver.config, solver.knowledge, solver.A, seed=11,
                                 template=True)
    assert isinstance(carry.fac, bs.QRReflectors)
    assert type(template.fac) is type(carry.fac)
    for name in ("v", "t", "rinv"):
        leaf, meta = getattr(carry.fac, name), getattr(template.fac, name)
        assert meta.is_meta
        assert (meta.shape, meta.dtype) == (leaf.shape, leaf.dtype)
    path = str(tmp_path / "carry.npz")
    checkpoint.save_state(path, carry)
    loaded = checkpoint.load_state(path, template, device="cpu")
    assert isinstance(loaded.fac, bs.QRReflectors)
    for name in ("v", "t", "rinv"):
        assert torch.equal(getattr(loaded.fac, name), getattr(carry.fac, name))
    b = _rhs((solver.A.shape[0],), solver.A.dtype)
    assert torch.equal(bs.solve_any(loaded.fac, b), bs.solve_any(carry.fac, b))


def test_a_forced_solve_counts_one_implicit_q_per_factorization():
    """Every shared factorization of a solve, refinement's included, takes
    the one form and opens one ``maus.factor.implicit_q`` inside its
    ``maus.factor``; the answer is certified."""
    from maus_tpu_torch.utils import metrics

    solver = _solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        report = solver.evolve(30)
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("maus.factor")]
    fac = [(s, e) for n, s, e in events if n == "maus.factor"]
    implicit = [(s, e) for n, s, e in events if n == "maus.factor.implicit_q"]
    assert "maus.factor.implicit_q" in {n for n, _ in metrics.SPANS}
    assert len(implicit) == len(fac) >= 1
    for s, e in implicit:
        assert any(fs <= s and e <= fe for fs, fe in fac)
    assert report.converged
    A, b = _system(96)
    x = np.asarray(report.solutions[0][0], np.complex128)
    assert np.linalg.norm(A.astype(np.complex128) @ x - b) / np.linalg.norm(b) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2048])
def test_the_card_takes_the_implicit_form(n):
    """On the card a one-vector solve by A and one by Aᴴ each replay a
    captured graph of the bundle's own, and agree with the eager solves of a
    batch and with an explicit Q."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from maus_tpu_torch.benchmarks.common import make_system

    kappa = 1e4
    A, b = make_system(n, kappa, 3, torch.device("cuda"))
    fac = bs.shared_factor_qr(A, 0.0)
    ref = _explicit(A)
    assert isinstance(fac, bs.QRReflectors)
    assert _rel(bs.solve_qr(fac, b), bs.solve_qr(ref, b)) <= 10 * _eps(A.dtype) * kappa
    big = [t for t in (fac.v, fac.t, fac.rinv) if t.numel() >= n * n]
    assert len(big) <= 2
    assert fac.t.numel() < n * n
    x = bs.solve_qr(fac, b)                     # the graph's first, eager solve
    assert fac.graph is not None
    assert torch.equal(bs.solve_qr(fac, b), x)  # a replay
    assert _rel(bs.solve_qr(fac, b[None])[0], x) < 10 * _eps(A.dtype)
    y = bs.solve_qr_adj(fac, b)                 # the adjoint graph's first solve
    assert fac.graph_adj is not None and fac.graph_adj is not fac.graph
    assert torch.equal(bs.solve_qr_adj(fac, b), y)
    assert _rel(bs.solve_qr_adj(fac, b[None])[0], y) < 10 * _eps(A.dtype)
    want = ref.q @ torch.linalg.solve_triangular(ref.r.mH, b[:, None], upper=False)[:, 0]
    assert _rel(y, want) <= 10 * _eps(A.dtype) * kappa
    a, _ = torch.geqrf(A)
    assert torch.equal(bs.invert_triangular(_nan_below(a)), bs.invert_triangular(a))
