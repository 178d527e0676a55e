"""Kernel K3 (the complex GEMM) against the JAX package on the same numpy
inputs.

On the CPU the port's wrappers run the plain version (four real-plane
products). It is held to the Pallas kernel ``maus_tpu.ops.pallas.cgemm.cgemm``
run in interpret mode, at the rtol/atol of 2e-4 that tests/test_pallas.py
holds that kernel to against XLA, and to numpy's complex128 product at
4·K·ε₃₂·max|a|·max|b| (one rounding per real product and per sum over K).
The kernel itself runs only on a CUDA card (the ``cuda`` tests below, which
skip here)."""
import numpy as np
import pytest
import torch

from maus_tpu_torch.ops.kernels import cgemm as kc

try:
    import jax.numpy as jnp

    from maus_tpu.ops.pallas.cgemm import cgemm as cgemm_pallas
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jnp = cgemm_pallas = None

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def _rand(rng, *shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _bar(a, b, eps):
    return 4 * a.shape[-1] * eps * np.abs(a).max() * np.abs(b).max()


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (16, 256, 64), (100, 130, 50)])
def test_plain_matches_interpret_mode_pallas(m, k, n):
    pytest.importorskip("jax")
    rng = np.random.default_rng(0)
    a, b = _rand(rng, m, k), _rand(rng, k, n)
    want = np.asarray(cgemm_pallas(jnp.asarray(a), jnp.asarray(b), bm=8, bn=128,
                                   bk=128, interpret=True))
    launches = kc.LAUNCHES
    got = kc.cgemm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert kc.LAUNCHES == launches          # the plain version does not count
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    exact = a.astype(np.complex128) @ b.astype(np.complex128)
    assert np.abs(got - exact).max() <= _bar(a, b, EPS32)


def test_bad_shapes():
    a = torch.zeros((4, 5), dtype=torch.complex64)
    b = torch.zeros((6, 4), dtype=torch.complex64)
    for fn in (kc.cgemm, kc.cgemm_plain):
        with pytest.raises(ValueError, match="bad shapes"):
            fn(a, b)
    pytest.importorskip("jax")
    with pytest.raises(ValueError, match="bad shapes"):
        cgemm_pallas(jnp.zeros((4, 5), jnp.complex64), jnp.zeros((6, 4), jnp.complex64),
                     interpret=True)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.0, 1.0), (0.5 - 2j, 1j)])
def test_update_matches_numpy(dtype, alpha, beta):
    """C ← β·C + α·A·B over a batch, on views into one buffer laid out as the
    blocked LU's trailing update is (C = X[:, e:, e:], A = X[:, e:, s:e],
    B = X[:, s:e, e:]); β = 0 must not read C, which holds NaN there."""
    rng = np.random.default_rng(3)
    X = _rand(rng, 3, 70, 70, dtype=dtype)
    s, e = 10, 25
    if beta == 0:
        X[:, e:, e:] = np.nan
    want = alpha * (X[:, e:, s:e].astype(np.complex128)
                    @ X[:, s:e, e:].astype(np.complex128))
    if beta != 0:
        want = want + beta * X[:, e:, e:]
    Xt = torch.from_numpy(X.copy())
    out = kc.cgemm_update(Xt[:, e:, e:], Xt[:, e:, s:e], Xt[:, s:e, e:], alpha, beta)
    assert out.data_ptr() == Xt[:, e:, e:].data_ptr()
    eps = EPS32 if dtype == np.complex64 else EPS64
    got = Xt.numpy()
    assert np.abs(got[:, e:, e:] - want).max() <= 4 * _bar(
        X[:, e:, s:e], X[:, s:e, e:], eps) * max(1.0, abs(alpha))
    np.testing.assert_array_equal(got[:, :e], X[:, :e])
    np.testing.assert_array_equal(got[:, e:, :e], X[:, e:, :e])


def _bad_updates():
    z = torch.zeros
    c64 = torch.complex64
    C, A, B = z((2, 4, 5), dtype=c64), z((2, 4, 3), dtype=c64), z((2, 3, 5), dtype=c64)
    return {
        "float32": ((C.real.contiguous(), A.real.contiguous(), B.real.contiguous()),
                    TypeError),
        "mixed dtypes": ((C, A.to(torch.complex128), B), TypeError),
        "ranks differ": ((C[0], A, B), ValueError),
        "inner dims": ((C, A, z((2, 4, 5), dtype=c64)), ValueError),
        "batch differs": ((C, A[:1], B), ValueError),
        "C column stride": ((z((2, 5, 4), dtype=c64).transpose(1, 2), A, B),
                            ValueError),
        "A column stride": ((C, z((2, 3, 4), dtype=c64).transpose(1, 2), B),
                            ValueError),
        "4-D": ((C[None], A[None], B[None]), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_updates()))
def test_update_rejects(case):
    args, exc = _bad_updates()[case]
    with pytest.raises(exc):
        kc.cgemm_update(*args)


def _card(rng_seed, *shape, dtype=torch.complex64):
    g = torch.Generator(device="cuda")
    g.manual_seed(rng_seed)
    rdt = dtype.to_real()
    return torch.complex(torch.randn(*shape, generator=g, dtype=rdt, device="cuda"),
                         torch.randn(*shape, generator=g, dtype=rdt, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 130, 50), (8, 128, 128),
                                   (65, 17, 129), (300, 1, 200)])
def test_kernel_matches_plain_on_card(dtype, m, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    a, b = _card(1, m, k, dtype=dtype), _card(2, k, n, dtype=dtype)
    launches = kc.LAUNCHES
    got = kc.cgemm(a, b)
    torch.cuda.synchronize()
    assert kc.LAUNCHES == launches + 1
    want = kc.cgemm_plain(a, b)
    eps = EPS32 if dtype == torch.complex64 else EPS64
    bar = 4 * k * eps * float(a.abs().max()) * float(b.abs().max())
    assert float((got - want).abs().max()) <= bar


@pytest.mark.cuda
def test_kernel_update_on_views_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    X = _card(3, 4, 300, 300)
    s, e = 128, 192
    Xp = X.clone()
    kc.cgemm_update(X[:, e:, e:], X[:, e:, s:e], X[:, s:e, e:], -1.0, 1.0)
    kc.cgemm_update_plain(Xp[:, e:, e:], Xp[:, e:, s:e], Xp[:, s:e, e:], -1.0, 1.0)
    torch.cuda.synchronize()
    bar = 4 * 4 * (e - s) * EPS32 * float(X.abs().max()) ** 2
    assert float((X - Xp).abs().max()) <= bar
    assert torch.equal(X[:, :e], Xp[:, :e])
