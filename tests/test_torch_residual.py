"""Kernel K1 (the true-FP64 residual) against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version; it is held to
``sliced_residual_fused`` run in interpret mode, as
tests/test_sliced_residual.py runs it, on the same numpy inputs: complex64
operands against the hi-only triple (``split_triple_c64``), complex128 operands
against the full triple (``split_triple``). Tolerance: 1e-15·‖A‖_F·‖x‖, the
bar the JAX tests hold the Pallas kernel to against the f64 oracle. The
kernel itself runs only on a CUDA card (the ``cuda`` test below)."""
import numpy as np
import pytest
import torch

from maus_tpu_torch.ops.kernels import residual

try:
    import jax.numpy as jnp

    from maus_tpu.ops.pallas.slice_residual import (sliced_residual_fused,
                                                    split_triple, split_triple_c64)
    from maus_tpu.ops.refine import SplitComplex
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jnp = None

torch.set_num_threads(1)


def _sc(z):
    z = np.asarray(z, np.complex128)
    return SplitComplex(jnp.asarray(z.real), jnp.asarray(z.imag))


def _operands(dtype, ascale, xscale, seed=4, m=256, n=256):
    rng = np.random.default_rng(seed)
    A = ((rng.standard_normal((m, n)) * np.exp(rng.uniform(-12, 12, (m, n))))
         + 1j * rng.standard_normal((m, n))) * ascale
    A = A.astype(dtype)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * xscale
    b = A.astype(np.complex128) @ x * (1 + 1e-13)
    return A, x, b


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("ascale,xscale", [(1.0, 1.0), (1e-3, 1e5), (1e7, 1e-6)])
def test_plain_matches_interpret_mode_pallas(dtype, ascale, xscale):
    pytest.importorskip("jax")
    A, x, b = _operands(dtype, ascale, xscale)
    if dtype == np.complex64:
        tri = split_triple_c64(jnp.asarray(A))
    else:
        tri = split_triple(_sc(A))
    rj = sliced_residual_fused(tri, _sc(x), _sc(b), tile_m=128, tile_k=128,
                               interpret=True)
    r_jax = np.asarray(rj.re) + 1j * np.asarray(rj.im)
    launches = residual.LAUNCHES
    r_port = residual.true_residual(torch.from_numpy(A), torch.from_numpy(x),
                                    torch.from_numpy(b)).numpy()
    assert residual.LAUNCHES == launches      # the plain version does not count
    A128 = A.astype(np.complex128)
    scale = np.linalg.norm(A128) * np.linalg.norm(x)
    assert np.max(np.abs(r_port - r_jax)) < 1e-15 * scale
    assert np.max(np.abs(r_port - (b - A128 @ x))) < 1e-15 * scale


def test_inf_in_x_gives_non_finite_rows():
    A, x, b = _operands(np.complex64, 1.0, 1.0, m=33, n=17)
    x[5] = np.inf
    r = residual.true_residual(torch.from_numpy(A), torch.from_numpy(x),
                               torch.from_numpy(b))
    assert not torch.isfinite(torch.view_as_real(r)).all(dim=-1).any()


def _bad_calls():
    A = torch.zeros((6, 4), dtype=torch.complex64)
    x = torch.zeros(4, dtype=torch.complex128)
    b = torch.zeros(6, dtype=torch.complex128)
    return {
        "A float32": ((A.real.contiguous(), x, b), TypeError),
        "A int": ((torch.zeros((6, 4), dtype=torch.int32), x, b), TypeError),
        "x complex64": ((A, x.to(torch.complex64), b), TypeError),
        "b float64": ((A, x, b.real.contiguous()), TypeError),
        "A 1-D": ((A.reshape(-1), x, b), ValueError),
        "x 2-D": ((A, x[:, None], b), ValueError),
        "x wrong length": ((A, torch.zeros(5, dtype=torch.complex128), b), ValueError),
        "b wrong length": ((A, x, torch.zeros(4, dtype=torch.complex128)), ValueError),
        "A transposed view": ((torch.zeros((4, 6), dtype=torch.complex64).T, x, b),
                              ValueError),
        "x strided": ((A, torch.zeros(8, dtype=torch.complex128)[::2], b),
                      ValueError),
        "empty": ((torch.zeros((0, 4), dtype=torch.complex64), x,
                   torch.zeros(0, dtype=torch.complex128)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    args, exc = _bad_calls()[case]
    with pytest.raises(exc):
        residual.true_residual(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(256, 256), (4097, 4097), (1000, 777), (1, 513),
                                   (3, 1)])
def test_kernel_matches_plain_on_card(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    m, n = shape
    A = torch.randn(m, n, generator=g, dtype=dtype, device="cuda")
    x = torch.randn(n, generator=g, dtype=torch.complex128, device="cuda")
    b = torch.randn(m, generator=g, dtype=torch.complex128, device="cuda")
    launches = residual.LAUNCHES
    r_k = residual.true_residual(A, x, b)
    torch.cuda.synchronize()
    assert residual.LAUNCHES == launches + 1
    r_p = residual.true_residual_plain(A, x, b)
    scale = float(torch.linalg.vector_norm(A.to(torch.complex128))) * \
        float(torch.linalg.vector_norm(x))
    assert float((r_k - r_p).abs().max()) <= 1e-15 * scale
