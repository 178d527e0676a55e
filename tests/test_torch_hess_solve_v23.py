"""Kernels P1 and P2, the two blocked variants of K2 (the batched shifted
Hessenberg solve), against the JAX package on the same numpy inputs.

On the CPU the wrappers ``hess_solve_v2`` and ``hess_solve_v3`` (the
redesigned kernels, csrc/hess_stream.cuh) run their kernels' plain
versions. Those are held to the TPU kernels they replace
(``benchmarks/hess_v2_probe.py::hess_solve_v2`` and
``benchmarks/hess_v3_probe.py::hess_solve_v3``, run in interpret mode and
loaded by path, since the probes are scripts) at the relative-residual bar
tests/test_pallas.py holds K2's TPU kernel to (5e-5 in complex64), and
within 1e-4·‖w‖ of them (two complex64 sweeps of the same rotations,
κ(H − λI) ≲ 1e2 at these shifts); and to K2's plain version in complex128
(1e-11 relative: the same rotations, P2's in divide-free form, and the same
triangular solve in another order). The kernels themselves run only on a
CUDA card (the ``cuda`` tests below, which skip here)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from maus_tpu_torch.ops import hessenberg as ht
from maus_tpu_torch.ops.kernels import hess_solve

try:
    import jax.numpy as jnp

    from maus_tpu.ops import hessenberg as hj
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jnp = hj = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"v2": (hess_solve.hess_solve_v2, hess_solve.hess_solve_v2_plain,
                   "LAUNCHES_V2"),
            "v3": (hess_solve.hess_solve_v3, hess_solve.hess_solve_v3_plain,
                   "LAUNCHES_V3")}


def _probe(variant):
    """The JAX package's probe module ``benchmarks/hess_<variant>_probe.py``,
    imported by file path."""
    path = os.path.join(REPO, "benchmarks", f"hess_{variant}_probe.py")
    spec = importlib.util.spec_from_file_location(f"_hess_{variant}_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _problem(k, n, seed=0):
    """H from a real reduction (random triangular fixtures are exponentially
    ill-conditioned), shifts inside the spectrum, standard-normal rows b_k."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        / np.sqrt(n)
    H = np.array(hj.reduce_hessenberg(jnp.asarray(A)).h)
    lams = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) * 0.3
    B = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
    return H, lams, B


def _rel_residual(H, shifts, W, B):
    n = H.shape[0]
    return np.array([np.linalg.norm((H + s * np.eye(n)) @ w - b) / np.linalg.norm(b)
                     for s, w, b in zip(shifts, W, B)])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("k,n", [(16, 128), (32, 256)])
def test_plain_matches_interpret_mode_probe(variant, k, n):
    pytest.importorskip("jax")
    wrapper, _, counter = VARIANTS[variant]
    H, lams, B = _problem(k, n, seed=n)
    H64, s64, B64 = (H.astype(np.complex64), (-lams).astype(np.complex64),
                     B.astype(np.complex64))
    probe = getattr(_probe(variant), f"hess_solve_{variant}")
    w_p = np.asarray(probe(jnp.asarray(H64), jnp.asarray(s64), jnp.asarray(B64),
                           interpret=True))
    launches = getattr(hess_solve, counter)
    w_t = wrapper(torch.from_numpy(H64), torch.from_numpy(s64),
                  torch.from_numpy(B64)).numpy()
    assert getattr(hess_solve, counter) == launches   # plain: no launch counted
    assert w_t.dtype == np.complex64
    assert np.max(_rel_residual(H, -lams, w_p, B)) < 5e-5
    assert np.max(_rel_residual(H, -lams, w_t, B)) < 5e-5
    assert np.linalg.norm(w_t - w_p) <= 1e-4 * np.linalg.norm(w_p)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("k,n", [(1, 1), (3, 7), (5, 130)])
def test_plain_matches_k2_plain_in_complex128(variant, k, n):
    """Ragged N: one partial block (N = 1, 7) and a full block above a
    partial one (N = 130 = 2·64 + 2)."""
    pytest.importorskip("jax")
    _, plain, _ = VARIANTS[variant]
    H, lams, B = _problem(k, n, seed=n + 1)
    Ht, st, Bt = torch.from_numpy(H), torch.from_numpy(-lams), torch.from_numpy(B)
    w_1 = hess_solve.hess_solve_plain(Ht, st, Bt).numpy()
    w_v = plain(Ht, st, Bt).numpy()
    assert np.linalg.norm(w_v - w_1) <= 1e-11 * np.linalg.norm(w_1)
    assert np.max(_rel_residual(H, -lams, w_v, B)) <= 1e-12


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_zero_pivot_gives_non_finite_rows(variant):
    """H = e₀e₁ᵀ with zero shifts: the triangular factor's last diagonal is
    an exact zero, and every row of W is non-finite, as K2's contract says."""
    _, plain, _ = VARIANTS[variant]
    H = torch.zeros((5, 5), dtype=torch.complex64)
    H[0, 1] = 1.0
    w = plain(H, torch.zeros(2, dtype=torch.complex64),
              torch.ones((2, 5), dtype=torch.complex64))
    assert not torch.isfinite(torch.view_as_real(w)).all(dim=-1).all(dim=-1).any()


def test_divide_free_rotation_matches_k2s():
    """P2's rotation equals K2's c = |a|/r, s = sign(a)·conj(b)/r, with the
    identity at b = 0 and sign 1 at a = 0."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    b = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    a[1], b[2] = 0.0, 0.0
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    c1, s1 = hess_solve._givens(at, bt)
    c3, s3 = hess_solve._givens_rsqrt(at, bt)
    np.testing.assert_allclose(c3.numpy(), c1.numpy(), atol=1e-15)
    np.testing.assert_allclose(s3.numpy(), s1.numpy(), atol=1e-15)
    assert c3[2] == 1 and s3[2] == 0 and c3[1] == 0


def _bad_calls():
    H = torch.zeros((4, 4), dtype=torch.complex64)
    s = torch.zeros(3, dtype=torch.complex64)
    B = torch.zeros((3, 4), dtype=torch.complex64)
    return {
        "float32": ((H.real.contiguous(), s.real.contiguous(), B.real.contiguous()),
                    TypeError),
        "mixed dtypes": ((H.to(torch.complex128), s, B), TypeError),
        "H 1-D": ((H.reshape(-1), s, B), ValueError),
        "H not square": ((torch.zeros((4, 5), dtype=torch.complex64), s, B),
                         ValueError),
        "shifts wrong length": ((H, torch.zeros(2, dtype=torch.complex64), B),
                                ValueError),
        "B transposed view": ((H, s, torch.zeros((4, 3), dtype=torch.complex64).T),
                              ValueError),
        "empty": ((torch.zeros((4, 4), dtype=torch.complex64),
                   torch.zeros(0, dtype=torch.complex64),
                   torch.zeros((0, 4), dtype=torch.complex64)), ValueError),
    }


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(variant, case):
    args, exc = _bad_calls()[case]
    with pytest.raises(exc):
        VARIANTS[variant][0](*args)


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


def _card_residual(H, s, W, B):
    Hh = torch.triu(H, diagonal=-1)
    return float((torch.linalg.vector_norm(W @ Hh.T + s[:, None] * W - B, dim=-1)
                  / torch.linalg.vector_norm(B, dim=-1)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("k,n", [(1, 1), (7, 129), (3, 1000), (4, 512), (2, 64)])
def test_kernel_matches_plain_on_card(variant, dtype, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    wrapper, plain, counter = VARIANTS[variant]
    H, s, B = _card_problem(k, n, dtype)
    launches = getattr(hess_solve, counter)
    w_k = wrapper(H, s, B)
    torch.cuda.synchronize()
    assert getattr(hess_solve, counter) == launches + 1
    w_p = plain(H, s, B)
    bar = 5e-5 if dtype == torch.complex64 else 1e-12
    assert _card_residual(H, s, w_k, B) <= bar
    assert _card_residual(H, s, w_p, B) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_zero_pivot_on_card(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    H = torch.zeros((5, 5), dtype=torch.complex64, device="cuda")
    H[0, 1] = 1.0
    w = VARIANTS[variant][0](H, torch.zeros(2, dtype=torch.complex64, device="cuda"),
                             torch.ones((2, 5), dtype=torch.complex64, device="cuda"))
    assert not torch.isfinite(torch.view_as_real(w)).all(dim=-1).all(dim=-1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_carried_row_in_global_memory_on_card(variant):
    """The carried row in global memory: N = 16673 in complex128 is past the
    redesigned sweep's shared-memory fit for the columns beyond its 480 × 5
    in registers (hess_solve.blocked_plan), and N = 8193 past the 128 KB
    budget of the row-loop body (kept as hess_solve_v2/_v3_rowloop). Each operand
    is 3I plus a small random Hessenberg part, well conditioned without a
    reduction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rowloop = getattr(hess_solve, f"hess_solve_{variant}_rowloop")
    for n, solve in ((16673, VARIANTS[variant][0]), (8193, rowloop)):
        H = torch.triu(torch.randn(n, n, generator=g, dtype=torch.complex128,
                                   device="cuda"), diagonal=-1) / n \
            + 3.0 * torch.eye(n, dtype=torch.complex128, device="cuda")
        s = torch.full((1,), 0.5 + 0.5j, dtype=torch.complex128, device="cuda")
        B = torch.randn(1, n, generator=g, dtype=torch.complex128, device="cuda")
        if solve is not rowloop:
            assert hess_solve.blocked_plan(1, n, torch.complex128)["home"] == "global"
        w = solve(H, s, B)
        assert _card_residual(H, s, w, B) <= 1e-12
        del H, B, w
        torch.cuda.empty_cache()
