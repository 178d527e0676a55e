"""K2's QR form (``hess_solve_qr``, CUDA source ``csrc/hess_solve.cu``: the
top-down Givens sweep in the TPU kernel's order, on no solver path), the
wrapper checks K2 shares with it, and the eig path's solves around K2,
against the JAX package on the same numpy inputs.

On the CPU ``hess_solve_qr`` runs its kernel's plain version. It is held to
the JAX package's ``_hess_solve_scan`` in complex128 (same rotations, same
order: 1e-12 relative), and to the Pallas kernel run in interpret mode at the
relative-residual bar tests/test_pallas.py holds that kernel to (5e-5 in
complex64). The kernel itself runs only on a CUDA card (the ``cuda`` tests
below, which skip here). K2 as the solver path runs it, the RQ sweep, is
tested in tests/test_torch_hess_solve_rq.py."""
import numpy as np
import pytest
import torch

from maus_tpu_torch.ops import hessenberg as ht
from maus_tpu_torch.ops.kernels import hess_solve

try:
    import jax.numpy as jnp

    from maus_tpu.ops import hessenberg as hj
    from maus_tpu.ops.pallas.hess_solve import hess_solve_batched_pallas
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jnp = hj = hess_solve_batched_pallas = None

torch.set_num_threads(1)


def _problem(k, n, seed=0):
    """H from a real reduction (random triangular fixtures are exponentially
    ill-conditioned), shifts inside the spectrum, standard-normal rows b_k."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        / np.sqrt(n)
    H = np.array(hj.reduce_hessenberg(jnp.asarray(A)).h)
    lams = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) * 0.3
    B = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
    return A, H, lams, B


def _rel_residual(H, shifts, W, B):
    n = H.shape[0]
    return np.array([np.linalg.norm((H + s * np.eye(n)) @ w - b) / np.linalg.norm(b)
                     for s, w, b in zip(shifts, W, B)])


@pytest.mark.parametrize("k,n", [(1, 1), (3, 7), (5, 130)])
def test_plain_matches_jax_scan(k, n):
    """At N = 1 the JAX scan does not trace (its two-row slice exceeds the
    operand), so the reference there is b / (h − λ) itself."""
    pytest.importorskip("jax")
    _, H, lams, B = _problem(k, n, seed=n)
    if n == 1:
        w_j = B / (H[0, 0] - lams)[:, None]
    else:
        w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(lams),
                                             jnp.asarray(B)))
    launches = hess_solve.LAUNCHES_QR
    w_t = hess_solve.hess_solve_qr(torch.from_numpy(H), torch.from_numpy(-lams),
                                   torch.from_numpy(B)).numpy()
    assert hess_solve.LAUNCHES_QR == launches   # the plain version does not count
    assert np.linalg.norm(w_t - w_j) <= 1e-12 * np.linalg.norm(w_j)
    assert np.max(_rel_residual(H, -lams, w_t, B)) <= 1e-12


def test_plain_matches_interpret_mode_pallas():
    """N = 128, K = 16, complex64: both at the 5e-5 residual bar, and within
    1e-4 of each other relative to ‖w‖ (two complex64 sweeps of the same
    rotations, κ(H − λI) ≲ 1e2 at these shifts)."""
    pytest.importorskip("jax")
    _, H, lams, B = _problem(16, 128, seed=0)
    H64, s64, B64 = (H.astype(np.complex64), (-lams).astype(np.complex64),
                     B.astype(np.complex64))
    w_p = np.asarray(hess_solve_batched_pallas(
        jnp.asarray(H64), jnp.asarray(s64), jnp.asarray(B64), interpret=True))
    w_t = hess_solve.hess_solve_qr(torch.from_numpy(H64), torch.from_numpy(s64),
                                   torch.from_numpy(B64)).numpy()
    assert w_t.dtype == np.complex64
    assert np.max(_rel_residual(H, -lams, w_p, B)) < 5e-5
    assert np.max(_rel_residual(H, -lams, w_t, B)) < 5e-5
    assert np.linalg.norm(w_t - w_p) <= 1e-4 * np.linalg.norm(w_p)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_exact_zero_pivot_gives_non_finite_rows(dtype):
    """(H + sI) singular with an exact-zero pivot: every row of the solve is
    non-finite, as in the JAX package (the Ψ ladder reads such rows as
    failed solves)."""
    pytest.importorskip("jax")
    H = np.zeros((5, 5), dtype)
    H[0, 1] = 1.0
    shifts = np.zeros(2, dtype)
    B = np.ones((2, 5), dtype)
    w_t = hess_solve.hess_solve_qr(torch.from_numpy(H), torch.from_numpy(shifts),
                                   torch.from_numpy(B))
    assert not torch.isfinite(torch.view_as_real(w_t)).all(dim=-1).all(dim=-1).any()
    w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(-shifts),
                                         jnp.asarray(B)))
    assert not np.isfinite(w_j).all(axis=-1).any()


@pytest.mark.parametrize("with_psi", [False, True])
def test_solve_shifted_via_hessenberg_matches_dense_and_jax(with_psi):
    pytest.importorskip("jax")
    k, n = 6, 48
    A, _, lams, B = _problem(k, n, seed=11)
    psi = np.linspace(1e-3, 1e-1, k) if with_psi else None
    cache_t = ht.reduce_hessenberg_auto(torch.from_numpy(A))
    w_t = ht.solve_shifted_via_hessenberg(
        cache_t, torch.from_numpy(lams), torch.from_numpy(B),
        None if psi is None else torch.from_numpy(psi)).numpy()
    cache_j = hj.reduce_hessenberg_auto(jnp.asarray(A))
    w_j = np.asarray(hj.solve_shifted_via_hessenberg(
        cache_j, jnp.asarray(lams), jnp.asarray(B),
        None if psi is None else jnp.asarray(psi)))
    shifts = -lams + (0.0 if psi is None else psi)
    w_d = np.stack([np.linalg.solve(A + s * np.eye(n), b) for s, b in zip(shifts, B)])
    assert np.linalg.norm(w_t - w_d) <= 1e-11 * np.linalg.norm(w_d)
    assert np.linalg.norm(w_t - w_j) <= 1e-12 * np.linalg.norm(w_j)


def _bad_calls():
    H = torch.zeros((4, 4), dtype=torch.complex64)
    s = torch.zeros(3, dtype=torch.complex64)
    B = torch.zeros((3, 4), dtype=torch.complex64)
    return {
        "float32": ((H.real.contiguous(), s.real.contiguous(), B.real.contiguous()),
                    TypeError),
        "mixed dtypes": ((H.to(torch.complex128), s, B), TypeError),
        "H 1-D": ((H.reshape(-1), s, B), ValueError),
        "shifts 2-D": ((H, s[:, None], B), ValueError),
        "H not square": ((torch.zeros((4, 5), dtype=torch.complex64), s, B),
                         ValueError),
        "shifts wrong length": ((H, torch.zeros(2, dtype=torch.complex64), B),
                                ValueError),
        "H strided": ((torch.zeros((8, 4), dtype=torch.complex64)[::2], s, B),
                      ValueError),
        "B transposed view": ((H, s, torch.zeros((4, 3), dtype=torch.complex64).T),
                              ValueError),
        "empty": ((torch.zeros((4, 4), dtype=torch.complex64),
                   torch.zeros(0, dtype=torch.complex64),
                   torch.zeros((0, 4), dtype=torch.complex64)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    args, exc = _bad_calls()[case]
    with pytest.raises(exc):
        hess_solve.hess_solve(*args)


def _card_problem(k, n, dtype, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rdt = dtype.to_real()
    A = torch.complex(torch.randn(n, n, generator=g, dtype=rdt, device="cuda"),
                      torch.randn(n, n, generator=g, dtype=rdt, device="cuda")) \
        / float(np.sqrt(2 * n))
    H = ht.reduce_hessenberg_auto(A).h
    s = torch.complex(torch.randn(k, generator=g, dtype=rdt, device="cuda"),
                      torch.randn(k, generator=g, dtype=rdt, device="cuda")) * 0.3
    B = torch.complex(torch.randn(k, n, generator=g, dtype=rdt, device="cuda"),
                      torch.randn(k, n, generator=g, dtype=rdt, device="cuda"))
    return H, s, B


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("k,n", [(1, 1), (7, 129), (3, 1000), (4, 512), (2, 33)])
def test_kernel_matches_plain_on_card(dtype, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H, s, B = _card_problem(k, n, dtype)
    launches = hess_solve.LAUNCHES_QR
    w_k = hess_solve.hess_solve_qr(H, s, B)
    torch.cuda.synchronize()
    assert hess_solve.LAUNCHES_QR == launches + 1
    w_p = hess_solve.hess_solve_plain(H, s, B)
    bar = 5e-5 if dtype == torch.complex64 else 1e-12
    Hh = torch.triu(H, diagonal=-1)
    for w in (w_k, w_p):
        r = torch.linalg.vector_norm(w @ Hh.T + s[:, None] * w - B, dim=-1) \
            / torch.linalg.vector_norm(B, dim=-1)
        assert float(r.max()) <= bar


@pytest.mark.cuda
def test_kernel_zero_pivot_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H = torch.zeros((5, 5), dtype=torch.complex64, device="cuda")
    H[0, 1] = 1.0
    w = hess_solve.hess_solve_qr(
        H, torch.zeros(2, dtype=torch.complex64, device="cuda"),
        torch.ones((2, 5), dtype=torch.complex64, device="cuda"))
    assert not torch.isfinite(torch.view_as_real(w)).all(dim=-1).all(dim=-1).any()


@pytest.mark.cuda
def test_kernel_carried_row_in_global_memory_on_card():
    """N = 10241 in complex128 is past the kernel's shared-memory budget for
    the carried row, which then lives in a global scratch row. H is 3I plus
    a random Hessenberg part of Frobenius norm ≈ 0.7 (well conditioned)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    n = hess_solve._SHARED_ROW_BYTES // 16 + 1
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    H = torch.triu(torch.randn(n, n, generator=g, dtype=torch.complex128,
                               device="cuda"), diagonal=-1) / n \
        + 3.0 * torch.eye(n, dtype=torch.complex128, device="cuda")
    s = torch.full((1,), 0.5 + 0.5j, dtype=torch.complex128, device="cuda")
    B = torch.randn(1, n, generator=g, dtype=torch.complex128, device="cuda")
    w = hess_solve.hess_solve_qr(H, s, B)
    torch.cuda.synchronize()
    r = torch.linalg.vector_norm(w @ torch.triu(H, diagonal=-1).T + s[:, None] * w - B)
    assert float(r / torch.linalg.vector_norm(B)) <= 1e-12
