"""Kernels P3 and P4 (batched LU with partial pivoting) against the JAX
package's parked Pallas kernels on the same numpy inputs.

On the CPU the port's wrappers run the plain versions (the same algorithm in
torch operations). ``lu_factor_plain`` is held to
``benchmarks/parked/pallas_lu.py::lu_factor_batched`` (P3) and
``benchmarks/parked/pallas_lu_blocked.py::lu_factor_batched_blocked`` (P4),
both run in interpret mode: the pivots must be equal (the JAX kernels record
them 0-based, the port 1-based as ``torch.linalg.lu_factor`` does), the
packed factors within 1e-4·max|H| (complex64 elimination of N ≤ 128 random
Gaussian matrices: the factors of two such runs differ by rounding only).
complex128 is held to ``jax.scipy.linalg.lu_factor`` by the solutions and
the backward error: LAPACK ranks pivots by |Re| + |Im| where these kernels
rank by |a|², so its pivots may differ. The kernels themselves run only on a
CUDA card (the ``cuda`` tests below, which skip here)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from maus_tpu_torch.ops.kernels import lu as klu

try:
    import jax.numpy as jnp
    import jax.scipy.linalg as jsla
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jnp = jsla = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def _parked(name):
    """A parked Pallas kernel module, imported by file path."""
    path = os.path.join(REPO, "benchmarks", "parked", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_parked_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(k, n, seed=0, dtype=np.complex64, shift=0.0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((k, n, n)) + 1j * rng.standard_normal((k, n, n))
    return (H + shift * np.eye(n)).astype(dtype)


def _backward_error(H, lu, piv):
    """max over the batch of ‖P·H − L·U‖_F / ‖H‖_F, P from the 1-based
    sequential interchanges ``piv``."""
    worst = 0.0
    n = H.shape[-1]
    for h, f, p in zip(H, lu, piv):
        perm = np.arange(n)
        for i, j in enumerate(np.asarray(p) - 1):
            perm[[i, j]] = perm[[j, i]]
        L = np.tril(f, -1) + np.eye(n)
        U = np.triu(f)
        worst = max(worst, np.linalg.norm(h[perm] - L @ U) / np.linalg.norm(h))
    return worst


def _solve_residual(H, lu, piv, seed=1):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(H.shape[:2]) + 1j * rng.standard_normal(H.shape[:2])
    b = b.astype(H.dtype)
    x = torch.linalg.lu_solve(torch.from_numpy(lu), torch.from_numpy(piv),
                              torch.from_numpy(b)[..., None])[..., 0].numpy()
    r = np.einsum("kij,kj->ki", H.astype(np.complex128), x) - b
    return np.max(np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("k,n", [(3, 16), (2, 64)])
def test_plain_matches_interpret_mode_unblocked_pallas(k, n):
    pytest.importorskip("jax")
    H = _batch(k, n, seed=n, shift=2.0)
    lu_j, piv_j = _parked("pallas_lu").lu_factor_batched(jnp.asarray(H),
                                                          interpret=True)
    launches = klu.LAUNCHES, klu.PANEL_LAUNCHES, klu.CLUSTER_PANEL_LAUNCHES
    lu_t, piv_t = klu.lu_factor(torch.from_numpy(H))
    assert (klu.LAUNCHES, klu.PANEL_LAUNCHES,
            klu.CLUSTER_PANEL_LAUNCHES) == launches   # plain: no count
    assert lu_t.dtype == torch.complex64 and piv_t.dtype == torch.int32
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j) + 1)
    assert np.abs(lu_t.numpy() - np.asarray(lu_j)).max() <= 1e-4 * np.abs(H).max()
    # the unblocked panel over all N columns is P3 itself
    lu_p = torch.from_numpy(H.copy())
    piv_p = torch.empty((k, n), dtype=torch.int32)
    klu.lu_panel(lu_p, piv_p, 0, n)
    np.testing.assert_array_equal(piv_p.numpy(), np.asarray(piv_j) + 1)
    assert np.abs(lu_p.numpy() - np.asarray(lu_j)).max() <= 1e-4 * np.abs(H).max()


def test_plain_matches_interpret_mode_blocked_pallas():
    pytest.importorskip("jax")
    k, n = 2, 128
    H = _batch(k, n, seed=7)
    lu_j, piv_j = _parked("pallas_lu_blocked").lu_factor_batched_blocked(
        jnp.asarray(H), interpret=True)
    lu_t, piv_t = klu.lu_factor(torch.from_numpy(H))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j) + 1)
    assert np.abs(lu_t.numpy() - np.asarray(lu_j)).max() <= 1e-4 * np.abs(H).max()
    assert _backward_error(H, lu_t.numpy(), piv_t.numpy()) <= 10 * np.sqrt(n) * EPS32


@pytest.mark.parametrize("k,n,nb", [(1, 1, 64), (5, 129, 64), (2, 70, 16),
                                    (3, 100, 7)])
def test_blocked_equals_unblocked_on_ragged_shapes(k, n, nb):
    """Any N, any panel width, the last panel ragged: the blocked plain LU
    picks the unblocked one's pivots and agrees with it to rounding, and its
    normwise backward error is ≤ 10·√N·ε."""
    H = _batch(k, n, seed=k + n)
    lu_b, piv_b = klu.lu_factor_plain(torch.from_numpy(H), nb=nb)
    lu_u, piv_u = klu.lu_factor_plain(torch.from_numpy(H), nb=n)
    np.testing.assert_array_equal(piv_b.numpy(), piv_u.numpy())
    assert np.abs(lu_b.numpy() - lu_u.numpy()).max() <= 1e-4 * np.abs(H).max()
    assert _backward_error(H, lu_b.numpy(), piv_b.numpy()) <= 10 * np.sqrt(n) * EPS32
    assert _solve_residual(H, lu_b.numpy(), piv_b.numpy()) <= 1e-3


@pytest.mark.parametrize("n", [33, 130])
def test_complex128_matches_jax_lu_factor(n):
    """complex128 against ``jax.scipy.linalg.lu_factor`` (LAPACK): the same
    solutions to 1e-12 and both backward errors at the FP64 floor; the 2-D
    input comes back 2-D, as from ``torch.linalg.lu_factor``."""
    pytest.importorskip("jax")
    H = _batch(1, n, seed=n, dtype=np.complex128)[0]
    lu_j, piv_j = jsla.lu_factor(jnp.asarray(H))
    lu_t, piv_t = klu.lu_factor(torch.from_numpy(H))
    assert lu_t.shape == (n, n) and piv_t.shape == (n,)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x_j = np.asarray(jsla.lu_solve((lu_j, piv_j), jnp.asarray(b)))
    x_t = torch.linalg.lu_solve(lu_t, piv_t, torch.from_numpy(b)[:, None])[:, 0].numpy()
    assert np.linalg.norm(x_t - x_j) <= 1e-12 * np.linalg.norm(x_j) * np.linalg.cond(H)
    assert _backward_error(H[None], lu_t.numpy()[None], piv_t.numpy()[None]) \
        <= 10 * np.sqrt(n) * EPS64
    assert _backward_error(H[None], np.asarray(lu_j)[None],
                           np.asarray(piv_j)[None] + 1) <= 10 * np.sqrt(n) * EPS64


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_zero_pivot_contract(dtype):
    """An exactly singular H: zero multipliers below the zero pivot, a zero
    on U's diagonal, and a non-finite solve, as in the Pallas kernel."""
    pytest.importorskip("jax")
    H = np.zeros((2, 5, 5), dtype)
    H[:, 0, 1] = 1.0
    H[1, 2, 0] = 3.0
    lu_t, piv_t = klu.lu_factor(torch.from_numpy(H))
    lu_h = lu_t.numpy()
    assert (np.diagonal(lu_h, axis1=1, axis2=2) == 0).any(axis=1).all()
    assert np.isfinite(lu_h).all()
    x = torch.linalg.lu_solve(lu_t, piv_t, torch.ones((2, 5, 1), dtype=lu_t.dtype))
    assert not torch.isfinite(torch.view_as_real(x)).all(dim=-1).all(dim=(1, 2)).any()
    if dtype == np.complex64:
        lu_j, piv_j = _parked("pallas_lu").lu_factor_batched(jnp.asarray(H),
                                                              interpret=True)
        np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j) + 1)
        np.testing.assert_array_equal(lu_h, np.asarray(lu_j))


def test_factor_and_shifted_solve_go_through_the_port_lu(monkeypatch):
    """ops/batched_solve factors with the port's LU, not torch.linalg."""
    from maus_tpu_torch.ops import batched_solve as bt

    calls = []
    real = bt.lu_factor
    monkeypatch.setattr(bt, "lu_factor", lambda H: calls.append(H.shape) or real(H))
    monkeypatch.setattr(torch.linalg, "lu_factor", None)
    H = torch.from_numpy(_batch(3, 12, shift=5.0, dtype=np.complex128))
    b = torch.ones((3, 12), dtype=torch.complex128)
    x = bt.solve_factored(bt.factor(H), b)
    assert torch.linalg.vector_norm(torch.einsum("kij,kj->ki", H, x) - b) <= 1e-12 * 12
    W, attempts = bt.batched_shifted_solve(H[0], torch.zeros(3, dtype=torch.complex128),
                                           torch.zeros(3, dtype=torch.int32), 1e-12,
                                           torch.tensor(1.0), b)
    assert calls == [(3, 12, 12), (3, 12, 12)] and attempts.tolist() == [0, 0, 0]


def _bad_factor_inputs():
    z = torch.zeros
    return {
        "float32": (z((2, 4, 4)), TypeError),
        "not square": (z((2, 4, 5), dtype=torch.complex64), ValueError),
        "1-D": (z(4, dtype=torch.complex64), ValueError),
        "4-D": (z((1, 2, 4, 4), dtype=torch.complex64), ValueError),
        "empty": (z((0, 4, 4), dtype=torch.complex64), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_factor_inputs()))
def test_lu_factor_rejects(case):
    H, exc = _bad_factor_inputs()[case]
    with pytest.raises(exc):
        klu.lu_factor(H)


def test_lu_panel_rejects():
    lu = torch.zeros((2, 6, 6), dtype=torch.complex64)
    piv = torch.zeros((2, 6), dtype=torch.int32)
    for args in ((lu, piv, 3, 3), (lu, piv, 0, 7), (lu, piv.long(), 0, 2),
                 (lu.transpose(1, 2), piv, 0, 2), (lu[0], piv, 0, 2),
                 (lu, piv[:, :5], 0, 2)):
        with pytest.raises(ValueError):
            klu.lu_panel(*args)


# ---- the panel kernel's choice and the launch bookkeeping (pure Python) ----

C64, C128 = 8, 16    # bytes of a complex64 and a complex128 entry


def _everywhere(n):
    """``active_clusters`` of a card that holds ``n`` clusters of any size."""
    return lambda C, rows, width: n


@pytest.mark.parametrize("K,n_rows,width,itemsize,want", [
    (8, 4096, 64, C64, 16),      # the eig finisher's first panel: 128 KB a CTA
    (8, 2048, 64, C64, 16),      # the SVD finisher's first panel
    (8, 64, 64, C64, 16),        # the last panel of a finisher batch
    (1, 7024, 64, C64, 16),      # 439 rows a CTA: just inside the fit
    (1, 7025, 64, C64, 0),       # 440 rows: just outside, the one-block kernel
    (1, 3520, 64, C128, 16),     # complex128: 220 rows just inside
    (1, 3521, 64, C128, 0),      # 221 rows just outside
    (8, 4096, 64, C128, 0),      # complex128 at the eig shape: one-block kernel
    (3, 100, 65, C64, 0),        # wider than a cluster kernel's panel
    (3, 256, 256, C64, 0),       # the whole unblocked LU of a 256² matrix
    (1, 1, 1, C64, 16),
])
def test_choose_panel_kernel_by_shape(K, n_rows, width, itemsize, want):
    assert klu.choose_panel_kernel(K, n_rows, width, itemsize, _everywhere(8)) == want


def test_choose_panel_kernel_weighs_waves_against_rows():
    """Seven clusters of 16 fit the card: the batch of 8 would run in two
    waves of 256 rows a CTA, so 14 CTAs of 293 rows in one wave win; with
    no cluster of 16 resident, 14 again; with seven clusters of any size
    (the H100's count past C = 8 at 4096 rows), two waves of 16; with
    nothing resident, the one-block kernel. The occupancy is asked with
    the rows and width."""
    asked = []

    def seven_of_16(C, rows, width):
        asked.append((C, rows, width))
        return 7 if C == 16 else 8
    assert klu.choose_panel_kernel(8, 4096, 64, C64, seven_of_16) == 14
    assert (16, 256, 64) in asked and (14, 293, 64) in asked
    assert klu.choose_panel_kernel(8, 4096, 64, C64,
                                   lambda C, r, w: 0 if C == 16 else 8) == 14
    assert klu.choose_panel_kernel(8, 4096, 64, C64, _everywhere(7)) == 16
    assert klu.choose_panel_kernel(8, 4096, 64, C64, _everywhere(0)) == 0
    # a batch of 1 fits in one wave anywhere: the most CTAs, the fewest rows
    assert klu.choose_panel_kernel(1, 4096, 64, C64, seven_of_16) == 16


def test_cluster_smem_bytes_and_limit():
    assert klu.cluster_smem_bytes(256, 64, C64) == 256 * (65 * 8 + 4)
    assert klu.cluster_smem_bytes(439, 64, C64) <= klu.SMEM_LIMIT < \
        klu.cluster_smem_bytes(440, 64, C64)
    assert klu.SMEM_LIMIT <= 232448   # sm_90's opt-in shared memory per block


@pytest.mark.parametrize("N,widths", [(1, [1]), (64, [64]), (100, [64, 36]),
                                      (4096, [64] * 64), (2047, [64] * 31 + [63])])
def test_panel_routes_cover_every_panel(N, widths):
    """One route per panel, each asked with that panel's rows and width."""
    asked = []

    def active(C, rows, width):
        asked.append(width)
        return 4
    routes = klu.panel_routes(8, N, C64, active)
    assert len(routes) == len(widths) == -(-N // klu.NB)
    assert all(r in klu.CLUSTER_SIZES for r in routes)
    assert sorted(set(asked)) == sorted(set(widths))


def test_launch_bookkeeping_of_one_factorization(monkeypatch):
    """``_count_factor``: one factorization, each panel on the kernel its
    route names, one K3 update per panel but the last."""
    from maus_tpu_torch.ops.kernels import cgemm

    for name in ("LAUNCHES", "PANEL_LAUNCHES", "CLUSTER_PANEL_LAUNCHES"):
        monkeypatch.setattr(klu, name, 0)
    monkeypatch.setattr(cgemm, "LAUNCHES", 0)
    klu._count_factor([16, 16, 12, 0])
    assert (klu.LAUNCHES, klu.CLUSTER_PANEL_LAUNCHES, klu.PANEL_LAUNCHES,
            cgemm.LAUNCHES) == (1, 3, 1, 3)
    klu._count_factor([0])
    assert (klu.LAUNCHES, klu.CLUSTER_PANEL_LAUNCHES, klu.PANEL_LAUNCHES,
            cgemm.LAUNCHES) == (2, 3, 2, 3)


@pytest.mark.parametrize("args", [(0, 64, 3), (0, 64, 32), (0, 65, 16),
                                  (0, 64, 16, torch.complex128, 4096)])
def test_lu_panel_rejects_a_cluster_that_does_not_fit(args):
    """An explicit cluster size is checked against the shape before any
    device dispatch: a size the kernel does not take, a panel wider than 64
    columns, a slice past a CTA's shared memory."""
    s, e, C, *rest = args
    dtype, n = rest if rest else (torch.complex64, 128)
    lu = torch.zeros((1, n, n), dtype=dtype)
    piv = torch.zeros((1, n), dtype=torch.int32)
    with pytest.raises(ValueError):
        klu.lu_panel(lu, piv, s, e, cluster=C)


def test_lu_panel_with_a_cluster_size_runs_the_plain_version_on_cpu():
    H = _batch(2, 70, seed=3)
    a = torch.from_numpy(H.copy())
    b = torch.from_numpy(H.copy())
    pa = torch.zeros((2, 70), dtype=torch.int32)
    pb = pa.clone()
    klu.lu_panel(a, pa, 0, 64, cluster=16)
    klu.lu_panel_plain(b, pb, 0, 64)
    assert torch.equal(a, b) and torch.equal(pa, pb)


def _card_batch(k, n, dtype):
    g = torch.Generator(device="cuda")
    g.manual_seed(k * 1000 + n)
    rdt = dtype.to_real()
    return torch.complex(torch.randn(k, n, n, generator=g, dtype=rdt, device="cuda"),
                         torch.randn(k, n, n, generator=g, dtype=rdt, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("k,n", [(1, 1), (5, 129), (3, 300), (2, 64), (16, 256)])
def test_kernel_matches_plain_on_card(dtype, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H = _card_batch(k, n, dtype)
    launches = klu.LAUNCHES, klu.PANEL_LAUNCHES + klu.CLUSTER_PANEL_LAUNCHES
    lu_k, piv_k = klu.lu_factor(H)
    torch.cuda.synchronize()
    assert klu.LAUNCHES == launches[0] + 1
    assert klu.PANEL_LAUNCHES + klu.CLUSTER_PANEL_LAUNCHES == \
        launches[1] + (n + klu.NB - 1) // klu.NB
    lu_p, piv_p = klu.lu_factor_plain(H)
    eps = EPS32 if dtype == torch.complex64 else EPS64
    Hh = H.cpu().numpy()
    assert _backward_error(Hh, lu_k.cpu().numpy(), piv_k.cpu().numpy()) \
        <= 10 * np.sqrt(n) * eps
    assert int((piv_k != piv_p).sum()) == 0
    assert float((lu_k - lu_p).abs().max()) <= 1e-3 * float(H.abs().max()) * \
        (1.0 if dtype == torch.complex64 else 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(3, 40), (16, 256)])
def test_panel_kernel_matches_plain_on_card(k, n):
    """The whole unblocked LU (one panel over [0, N): P3's counterpart) and
    a 64-column panel in the middle of a matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H = _card_batch(k, n, torch.complex64)
    for s, e in ((0, n), (n // 3, min(n, n // 3 + 64))):
        a, b = H.clone(), H.clone()
        pa = torch.zeros((k, n), dtype=torch.int32, device="cuda")
        pb = pa.clone()
        klu.lu_panel(a, pa, s, e)
        klu.lu_panel_plain(b, pb, s, e)
        torch.cuda.synchronize()
        assert torch.equal(pa, pb)
        assert float((a - b).abs().max()) <= 1e-3 * float(H.abs().max())


@pytest.mark.cuda
def test_kernel_zero_pivot_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H = torch.zeros((2, 5, 5), dtype=torch.complex64, device="cuda")
    H[:, 0, 1] = 1.0
    lu_k, piv_k = klu.lu_factor(H)
    x = torch.linalg.lu_solve(lu_k, piv_k, torch.ones((2, 5, 1), dtype=H.dtype,
                                                      device="cuda"))
    assert not torch.isfinite(torch.view_as_real(x)).all(dim=-1).all(dim=(1, 2)).any()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")


def _panel_vs_plain(H, s, e, cluster=None):
    """The panel on the card (``cluster`` as for ``lu_panel``) and the plain
    version on copies of H; returns (max|Δ|, pivots differing, the counts
    of one-block and cluster launches it made)."""
    k, n, _ = H.shape
    a, b = H.clone(), H.clone()
    pa = torch.zeros((k, n), dtype=torch.int32, device=H.device)
    pb = pa.clone()
    before = klu.PANEL_LAUNCHES, klu.CLUSTER_PANEL_LAUNCHES
    klu.lu_panel(a, pa, s, e, cluster=cluster)
    klu.lu_panel_plain(b, pb, s, e)
    torch.cuda.synchronize()
    return (float((a - b).abs().max()), int((pa != pb).sum()),
            (klu.PANEL_LAUNCHES - before[0], klu.CLUSTER_PANEL_LAUNCHES - before[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(8, 2048), (8, 4096)])
def test_cluster_panel_at_the_finisher_shapes(k, n):
    """The finishers' first 64-column panel: the cluster kernel, the plain
    version's pivots, entries within 1e-4·max|H|."""
    _need_card()
    H = _card_batch(k, n, torch.complex64)
    err, mism, (block, cluster) = _panel_vs_plain(H, 0, 64)
    assert (block, cluster) == (0, 1)
    assert mism == 0 and err <= 1e-4 * float(H.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,cluster_kernel", [
    (7024, torch.complex64, True), (7025, torch.complex64, False),
    (3520, torch.complex128, True), (3521, torch.complex128, False)])
def test_panel_kernel_choice_at_the_shared_memory_boundary(n, dtype, cluster_kernel):
    """One matrix just inside and just outside the cluster kernel's
    shared-memory fit, complex64 and complex128: the kernel the pure
    choice names runs, and agrees with the plain version."""
    _need_card()
    H = _card_batch(1, n, dtype)
    err, mism, (block, cluster) = _panel_vs_plain(H, 0, 64)
    assert (block, cluster) == ((0, 1) if cluster_kernel else (1, 0))
    tol = 1e-4 if dtype == torch.complex64 else 1e-12
    assert mism == 0 and err <= tol * float(H.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", klu.CLUSTER_SIZES)
@pytest.mark.parametrize("k", [1, 3])
def test_cluster_panel_every_cluster_size(k, cluster):
    _need_card()
    H = _card_batch(k, 300, torch.complex64)
    for s, e in ((0, 64), (100, 137), (290, 300)):
        err, mism, (block, clustered) = _panel_vs_plain(H, s, e, cluster)
        assert (block, clustered) == (0, 1)
        assert mism == 0 and err <= 1e-4 * float(H.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [129, 1000, 2047])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cluster_panel_and_factor_on_ragged_shapes(n, dtype):
    """Ragged N: the first, a middle and the ragged last panel against the
    plain version, then the whole blocked LU by its backward error
    ≤ 10·√N·ε."""
    _need_card()
    H = _card_batch(2, n, dtype)
    last = (n - 1) // klu.NB * klu.NB
    tol = 1e-4 if dtype == torch.complex64 else 1e-12
    for s, e in ((0, 64), (n // 2, n // 2 + 64), (last, n)):
        err, mism, _ = _panel_vs_plain(H, s, e)
        assert mism == 0 and err <= tol * float(H.abs().max())
    lu_k, piv_k = klu.lu_factor(H)
    eps = EPS32 if dtype == torch.complex64 else EPS64
    assert _backward_error(H.cpu().numpy(), lu_k.cpu().numpy(), piv_k.cpu().numpy()) \
        <= 10 * np.sqrt(n) * eps


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1, 512), (3, 512), (8, 1024)])
def test_factor_on_card_backward_error_and_counts(k, n):
    """The blocked LU of ``maus_lu_factor``: backward error ≤ 10·√N·ε, H unchanged,
    one factorization, ⌈N/NB⌉ cluster panels and ⌈N/NB⌉ − 1 K3 updates."""
    from maus_tpu_torch.ops.kernels import cgemm

    _need_card()
    H = _card_batch(k, n, torch.complex64)
    H0 = H.clone()
    before = (klu.LAUNCHES, klu.CLUSTER_PANEL_LAUNCHES, klu.PANEL_LAUNCHES,
              cgemm.LAUNCHES)
    lu_k, piv_k = klu.lu_factor(H)
    torch.cuda.synchronize()
    panels = -(-n // klu.NB)
    assert (klu.LAUNCHES - before[0], klu.CLUSTER_PANEL_LAUNCHES - before[1],
            klu.PANEL_LAUNCHES - before[2], cgemm.LAUNCHES - before[3]) == \
        (1, panels, 0, panels - 1)
    assert torch.equal(H, H0)
    assert _backward_error(H.cpu().numpy(), lu_k.cpu().numpy(), piv_k.cpu().numpy()) \
        <= 10 * np.sqrt(n) * EPS32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_zero_pivot_in_a_later_panel_through_maus_lu_factor(dtype):
    """Rows and columns [100, 130) zero: the second panel meets zero pivots
    (cluster kernel, fused interchange and solve), the factors stay finite,
    U's diagonal holds zeros and a solve is non-finite."""
    _need_card()
    H = _card_batch(2, 130, dtype)
    H[:, 100:, :] = 0
    H[:, :, 100:] = 0
    lu_k, piv_k = klu.lu_factor(H)
    assert bool(torch.isfinite(torch.view_as_real(lu_k)).all())
    assert bool((torch.diagonal(lu_k, dim1=1, dim2=2)[:, 100:] == 0).all())
    x = torch.linalg.lu_solve(lu_k, piv_k, torch.ones((2, 130, 1), dtype=dtype,
                                                      device="cuda"))
    assert not torch.isfinite(torch.view_as_real(x)).all(dim=-1).all(dim=(1, 2)).any()
