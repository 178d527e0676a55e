"""Kernel K2 as the solver path runs it: the bottom-up RQ sweep fused with the
back substitution (``hess_solve``, CUDA source ``csrc/hess_solve_rq.cu``),
against the JAX package on the same numpy inputs.

On the CPU the wrapper runs the kernel's plain version,
``hess_solve_rq_plain``. It takes the rotations in another order than the
JAX package's top-down QR scan (``_hess_solve_scan``) and the Pallas
kernel, so it is held to them by what both orders guarantee, never element
by element near a singular system: the relative residual
‖(H + s_k I)w_k − b_k‖/‖b_k‖ at the bar tests/test_pallas.py holds the
Pallas kernel to (5e-5 in complex64, 1e-12 in complex128), the normwise
backward error, and the solution's direction (within 1e-12 in complex128,
where the unnormalised solutions differ by their near-null component, set
by the system's conditioning). Where the systems are well conditioned the
two orders also agree element by element. The kernel runs only on a CUDA
card (the ``cuda`` tests below, which skip here)."""
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

BAR = {np.complex64: 5e-5, np.complex128: 1e-12}


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


def _backward_error(H, shifts, W, B):
    n = H.shape[0]
    out = []
    for s, w, b in zip(shifts, W, B):
        M = H + s * np.eye(n)
        out.append(np.linalg.norm(M @ w - b)
                   / (np.linalg.norm(M) * np.linalg.norm(w) + np.linalg.norm(b)))
    return np.array(out)


def _direction(W):
    """Each row scaled to unit norm, with the phase of its largest entry
    taken out."""
    W = W / np.linalg.norm(W, axis=-1, keepdims=True)
    i = np.argmax(np.abs(W), axis=-1)
    ph = W[np.arange(len(W)), i] / np.abs(W[np.arange(len(W)), i])
    return W / ph[:, None]


def _rq(H, shifts, B):
    return hess_solve.hess_solve_rq_plain(
        torch.from_numpy(H), torch.from_numpy(shifts), torch.from_numpy(B)).numpy()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("k,n", [(3, 7), (5, 130), (16, 64)])
def test_rq_plain_matches_jax_scan(k, n, dtype):
    """Both orders at the residual bar in the working dtype; in complex128
    they also agree within 1e-11 of ‖w‖ (κ(H − λI) ≲ 1e2 at these
    shifts). Through the wrapper on the CPU: the plain version, no launch."""
    pytest.importorskip("jax")
    _, H, lams, B = _problem(k, n, seed=n)
    H, shifts, B = H.astype(dtype), (-lams).astype(dtype), B.astype(dtype)
    w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(-shifts),
                                         jnp.asarray(B)))
    launches, launches_qr = hess_solve.LAUNCHES, hess_solve.LAUNCHES_QR
    w_t = hess_solve.hess_solve(torch.from_numpy(H), torch.from_numpy(shifts),
                                torch.from_numpy(B)).numpy()
    assert (hess_solve.LAUNCHES, hess_solve.LAUNCHES_QR) == (launches, launches_qr)
    assert w_t.dtype == dtype
    np.testing.assert_array_equal(w_t, _rq(H, shifts, B))
    H128, s128, B128 = (H.astype(np.complex128), shifts.astype(np.complex128),
                        B.astype(np.complex128))
    assert np.max(_rel_residual(H128, s128, w_t, B128)) <= BAR[dtype]
    assert np.max(_rel_residual(H128, s128, w_j, B128)) <= BAR[dtype]
    if dtype == np.complex128:
        assert np.linalg.norm(w_t - w_j) <= 1e-11 * np.linalg.norm(w_j)


def test_rq_plain_matches_interpret_mode_pallas():
    """N = 128, K = 16, complex64: both at the 5e-5 residual bar, and within
    1e-4 of each other relative to ‖w‖ (two complex64 solves of the same
    systems in two orders, κ(H − λI) ≲ 1e2 at these shifts)."""
    pytest.importorskip("jax")
    _, H, lams, B = _problem(16, 128, seed=0)
    H64, s64, B64 = (H.astype(np.complex64), (-lams).astype(np.complex64),
                     B.astype(np.complex64))
    w_p = np.asarray(hess_solve_batched_pallas(
        jnp.asarray(H64), jnp.asarray(s64), jnp.asarray(B64), interpret=True))
    w_t = _rq(H64, s64, B64)
    assert w_t.dtype == np.complex64
    assert np.max(_rel_residual(H, -lams, w_p, B)) < 5e-5
    assert np.max(_rel_residual(H, -lams, w_t, B)) < 5e-5
    assert np.linalg.norm(w_t - w_p) <= 1e-4 * np.linalg.norm(w_p)


@pytest.mark.parametrize("distance", [1e-4, 1e-8, 1e-12])
def test_rq_plain_near_an_eigenvalue(distance):
    """Shifts within ``distance`` of eigenvalues of H (complex128, N = 64):
    the normwise backward error of both orders under the 1e-12 bar, and the
    two solutions' directions within 1e-12 of each other, though their
    lengths differ by up to ~1e-4 relative at 1e-12 (the near-null
    component)."""
    pytest.importorskip("jax")
    n, k = 64, 3
    _, H, _, B = _problem(k, n, seed=3)
    lams = np.linalg.eigvals(H)[:k] + distance * np.exp(1j * np.array([0.3, 1.1, 2.0]))
    w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(lams),
                                         jnp.asarray(B)))
    w_t = _rq(H, -lams, B)
    assert np.max(_backward_error(H, -lams, w_t, B)) <= 1e-12
    assert np.max(_backward_error(H, -lams, w_j, B)) <= 1e-12
    gap = np.linalg.norm(_direction(w_t) - _direction(w_j), axis=-1)
    assert np.max(gap) <= 1e-12


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_rq_exact_zero_pivot_gives_non_finite_rows(dtype):
    """(H + sI) singular with an exact-zero pivot (the last column of H is
    zero, so R[N−1, N−1] = 0): every row of the solve is non-finite, as in
    the JAX package (the Ψ ladder reads such rows as failed solves)."""
    pytest.importorskip("jax")
    H = np.zeros((5, 5), dtype)
    H[0, 1] = 1.0
    shifts = np.zeros(2, dtype)
    B = np.ones((2, 5), dtype)
    w_t = hess_solve.hess_solve(torch.from_numpy(H), torch.from_numpy(shifts),
                                torch.from_numpy(B)).numpy()
    assert not np.isfinite(w_t).all(axis=-1).any()
    w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(-shifts),
                                         jnp.asarray(B)))
    assert not np.isfinite(w_j).all(axis=-1).any()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", [1, 2])
def test_rq_plain_smallest_systems(n, dtype):
    """N = 1 (no rotation: w = b / (h + s); the JAX scan does not trace
    there, its two-row slice exceeds the operand) and N = 2 (one rotation),
    against a dense solve."""
    rng = np.random.default_rng(n)
    H = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(dtype)
    shifts = (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(dtype)
    B = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(dtype)
    w_t = _rq(H, shifts, B)
    w_d = np.stack([np.linalg.solve(H.astype(np.complex128) + s * np.eye(n), b)
                    for s, b in zip(shifts, B)])
    tol = 1e-5 if dtype == np.complex64 else 1e-13
    assert np.linalg.norm(w_t - w_d) <= tol * np.linalg.norm(w_d)
    if n == 2 and hj is not None:
        w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(-shifts),
                                             jnp.asarray(B)))
        assert np.linalg.norm(w_t - w_j) <= tol * np.linalg.norm(w_j)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_rq_plain_reducible_h(dtype):
    """A zero subdiagonal entry (a reducible H): that step's rotation is the
    identity. Against a dense solve and the JAX scan."""
    pytest.importorskip("jax")
    _, H, lams, B = _problem(4, 40, seed=7)
    H = H.copy()
    H[20, 19] = 0.0
    H[33, 32] = 0.0
    H, shifts, B = H.astype(dtype), (-lams).astype(dtype), B.astype(dtype)
    w_t = _rq(H, shifts, B)
    H128 = H.astype(np.complex128)
    w_d = np.stack([np.linalg.solve(H128 + s * np.eye(40), b)
                    for s, b in zip(shifts, B.astype(np.complex128))])
    w_j = np.asarray(hj._hess_solve_scan(jnp.asarray(H), jnp.asarray(-shifts),
                                         jnp.asarray(B)))
    tol = 1e-4 if dtype == np.complex64 else 1e-12
    assert np.linalg.norm(w_t - w_d) <= tol * np.linalg.norm(w_d)
    assert np.linalg.norm(w_t - w_j) <= tol * np.linalg.norm(w_j)
    assert np.max(_rel_residual(H128, shifts, w_t, B.astype(np.complex128))) \
        <= BAR[dtype]


@pytest.mark.parametrize("with_psi", [False, True])
def test_solve_shifted_hessenberg_through_rq_matches_dense(with_psi):
    """``solve_shifted_hessenberg`` (the eig step's call into K2) with and
    without the Ψ ladder's ψ, against a dense solve of H − λI + ψI and the
    JAX package's solve_shifted_hessenberg."""
    pytest.importorskip("jax")
    k, n = 6, 48
    _, H, lams, B = _problem(k, n, seed=11)
    psi = np.linspace(1e-3, 1e-1, k) if with_psi else None
    w_t = ht.solve_shifted_hessenberg(
        torch.from_numpy(H), torch.from_numpy(lams), torch.from_numpy(B),
        None if psi is None else torch.from_numpy(psi)).numpy()
    w_j = np.asarray(hj.solve_shifted_hessenberg(
        jnp.asarray(H), jnp.asarray(lams), jnp.asarray(B),
        None if psi is None else jnp.asarray(psi)))
    shifts = -lams + (0.0 if psi is None else psi)
    w_d = np.stack([np.linalg.solve(H + s * np.eye(n), b) for s, b in zip(shifts, B)])
    assert np.linalg.norm(w_t - w_d) <= 1e-12 * np.linalg.norm(w_d)
    assert np.linalg.norm(w_t - w_j) <= 1e-12 * np.linalg.norm(w_j)


# (N, dtype, the home of the rows past the register fit) at the default
# block size: the register fit is 512 × 8 rows in complex64 and 512 × 4 in
# complex128; past it the state goes to shared memory while it fits there
HOMES = [(1, torch.complex64, "registers"), (129, torch.complex64, "registers"),
         (1000, torch.complex64, "registers"), (4096, torch.complex64, "registers"),
         (10241, torch.complex64, "shared"), (17856, torch.complex64, "shared"),
         (17857, torch.complex64, "global"),
         (1, torch.complex128, "registers"), (129, torch.complex128, "registers"),
         (1000, torch.complex128, "registers"), (3001, torch.complex128, "shared"),
         (10241, torch.complex128, "global")]


@pytest.mark.parametrize("n,dtype,home", HOMES)
def test_rq_plan_picks_the_state_home_by_shape(n, dtype, home):
    plan = hess_solve.rq_plan(n, dtype)
    assert plan["home"] == home
    assert plan["threads"] == hess_solve.RQ_THREADS
    assert plan["rows"] == hess_solve.RQ_ROWS[(dtype, plan["threads"])]
    assert plan["spill_rows"] == max(0, n - plan["threads"] * plan["rows"])
    assert plan["smem"] <= hess_solve._SMEM_LIMIT


def test_rq_plan_rejects_a_block_size_without_a_kernel():
    with pytest.raises(ValueError):
        hess_solve.rq_plan(100, torch.complex128, threads=1024)


def _card_problem(k, n, dtype, seed=0):
    """A well-conditioned shifted H on the card: 3I plus a random upper
    Hessenberg part of Frobenius norm ≈ 0.7 (no reduction, so any N is
    cheap), shifts of modulus ≤ 0.5."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    H = torch.triu(torch.randn(n, n, generator=g, dtype=dtype, device="cuda"),
                   diagonal=-1) / n + 3.0 * torch.eye(n, dtype=dtype, device="cuda")
    s = 0.35 * torch.randn(k, generator=g, dtype=dtype, device="cuda")
    B = torch.randn(k, n, generator=g, dtype=dtype, device="cuda")
    return H, s, B


def _card_residual(H, s, W, B):
    Hh = torch.triu(H, diagonal=-1)
    return torch.linalg.vector_norm(W @ Hh.T + s[:, None] * W - B, dim=-1) \
        / torch.linalg.vector_norm(B, dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,home",
                         [h for h in HOMES if h[0] in (1, 129, 1000, 3001, 10241, 17857)])
def test_rq_kernel_matches_plain_on_card(n, dtype, home):
    """The kernel against its plain version in each state home, at odd N:
    both at the residual bar, within 2× of each other's residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    assert hess_solve.rq_plan(n, dtype)["home"] == home
    k = 3 if n < 5000 else 1
    H, s, B = _card_problem(k, n, dtype)
    launches = hess_solve.LAUNCHES
    w_k = hess_solve.hess_solve(H, s, B)
    torch.cuda.synchronize()
    assert hess_solve.LAUNCHES == launches + 1
    w_p = hess_solve.hess_solve_rq_plain(H, s, B)
    bar = 5e-5 if dtype == torch.complex64 else 1e-12
    r_k = float(_card_residual(H, s, w_k, B).max())
    r_p = float(_card_residual(H, s, w_p, B).max())
    assert bool(torch.isfinite(torch.view_as_real(w_k)).all())
    assert r_k <= max(bar, 2 * r_p) and r_p <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [256, 512, 1024])
def test_rq_kernel_block_sizes_on_card(threads):
    """Every block size of RQ_ROWS at a reduced H, (7, 1000) complex64 and,
    where it has a kernel, complex128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    for dtype in (torch.complex64, torch.complex128):
        if (dtype, threads) not in hess_solve.RQ_ROWS:
            continue
        H, s, B = _card_problem(7, 1000, dtype, seed=threads)
        w_k = hess_solve.hess_solve(H, s, B, threads=threads)
        w_p = hess_solve.hess_solve_rq_plain(H, s, B)
        bar = 5e-5 if dtype == torch.complex64 else 1e-12
        assert float(_card_residual(H, s, w_k, B).max()) <= bar
        assert float(_card_residual(H, s, w_p, B).max()) <= bar


@pytest.mark.cuda
def test_rq_kernel_zero_pivot_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H = torch.zeros((5, 5), dtype=torch.complex64, device="cuda")
    H[0, 1] = 1.0
    w = hess_solve.hess_solve(H, torch.zeros(2, dtype=torch.complex64, device="cuda"),
                              torch.ones((2, 5), dtype=torch.complex64, device="cuda"))
    assert not torch.isfinite(torch.view_as_real(w)).all(dim=-1).all(dim=-1).any()


@pytest.mark.cuda
def test_solve_shifted_via_hessenberg_launches_the_rq_kernel_on_card():
    """The eig step's solve goes through the RQ kernel (LAUNCHES moves) and
    never through the QR kernel (LAUNCHES_QR does not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    n, k = 200, 4
    A = torch.randn(n, n, generator=g, dtype=torch.complex64, device="cuda") / n ** 0.5
    cache = ht.reduce_hessenberg_auto(A)
    lams = 0.3 * torch.randn(k, generator=g, dtype=torch.complex64, device="cuda")
    B = torch.randn(k, n, generator=g, dtype=torch.complex64, device="cuda")
    launches, launches_qr = hess_solve.LAUNCHES, hess_solve.LAUNCHES_QR
    W = ht.solve_shifted_via_hessenberg(cache, lams, B)
    torch.cuda.synchronize()
    assert hess_solve.LAUNCHES == launches + 1
    assert hess_solve.LAUNCHES_QR == launches_qr
    R = W @ A.T - lams[:, None] * W - B
    assert float((torch.linalg.vector_norm(R, dim=-1)
                  / torch.linalg.vector_norm(B, dim=-1)).max()) <= 5e-4
