"""ops/regularize and ops/batched_solve of the port against the JAX package, on
the same numpy inputs. Solutions are compared, not factors (Q and R are unique
only up to a unitary diagonal).

Tolerances: complex128 solutions agree to 1e-12 relative (the operands here
have κ ≤ ~10², so two backward-stable solvers differ by ≲ κ·ε₆₄·N). complex64
solutions agree to 100·κ·ε₃₂ relative: two backward-stable complex64 solvers
each carry a forward error of O(κ·ε₃₂), and the factor 100 covers the
size-dependent constants at N ≤ 200."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from maus_tpu.ops import batched_solve as bj
from maus_tpu.ops import regularize as rj
from maus_tpu_torch.ops import batched_solve as bt
from maus_tpu_torch.ops import regularize as rt

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
NS = [64, 200]
DTYPES = [np.complex64, np.complex128]


def _system(n, seed=0, hpd=False):
    rng = np.random.default_rng(seed + n)
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = B @ B.conj().T / n + np.eye(n) if hpd else B + n * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b


def _tol(dtype, A):
    if dtype == np.complex128:
        return 1e-12
    return 100.0 * np.linalg.cond(A) * EPS32


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


def _j(z, dtype):
    return jnp.asarray(np.asarray(z, dtype))


def _t(z, dtype):
    return torch.from_numpy(np.asarray(z, dtype))


@pytest.mark.parametrize("attempt,stuck", [(0, 0), (3, 0), (1, 2)])
def test_psi_magnitude_bitwise(attempt, stuck):
    base = np.float32(0.37)
    aggr = np.float32(10.0)
    pj = rj.psi_magnitude(jnp.asarray(base) * 1e-18, jnp.asarray(aggr),
                          jnp.asarray(attempt, jnp.float32),
                          jnp.asarray(stuck, jnp.float32))
    pt = rt.psi_magnitude(torch.tensor(base) * 1e-18, torch.tensor(aggr),
                          torch.tensor(attempt, dtype=torch.float32),
                          torch.tensor(stuck, dtype=torch.float32))
    assert pt.dtype == torch.float32
    assert np.float32(pj) == np.float32(pt.item())


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_shift(n, dtype):
    A, _ = _system(n)
    psi = np.float32(3e-5)
    Hj = np.asarray(rj.apply_shift(_j(A, dtype), jnp.asarray(psi)))
    Ht = rt.apply_shift(_t(A, dtype), torch.tensor(psi)).numpy()
    assert Ht.dtype == Hj.dtype
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=4 * np.finfo(
        np.float32).eps * float(psi))
    np.testing.assert_array_equal(Ht - np.diag(np.diag(Ht)),
                                  Hj - np.diag(np.diag(Hj)))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_rinv", [None, True])
def test_shared_factor_qr_solutions(n, dtype, with_rinv):
    """The port's one QR form (reflectors and R⁻¹) solves as each of the JAX
    package's two forms does: its default on the CPU (``None``: an explicit
    Q and triangular solves) and an explicit Q with R⁻¹."""
    A, b = _system(n)
    psi = 1e-6
    xj = bj.solve_qr(bj.shared_factor_qr(_j(A, dtype), psi, with_rinv=with_rinv),
                     _j(b, dtype))
    fac = bt.shared_factor_qr(_t(A, dtype), psi)
    assert isinstance(fac, bt.QRReflectors)
    xt = bt.solve_qr(fac, _t(b, dtype)).numpy()
    assert _rel(xt, xj) < _tol(dtype, A)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_invert_triangular(n, dtype):
    A, _ = _system(n)
    R = np.triu(A)
    Xj = np.asarray(bj.invert_triangular(_j(R, dtype), block=16))
    Xt = bt.invert_triangular(_t(R, dtype), block=16).numpy()
    assert np.allclose(np.tril(Xt, -1), 0)
    assert _rel(Xt, Xj) < _tol(dtype, R)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_factor_hpd_solutions(n, dtype):
    A, b = _system(n, hpd=True)
    psi = 1e-6
    xj = bj.solve_chol(bj.shared_factor_hpd(_j(A, dtype), psi), _j(b, dtype))
    xt = bt.solve_chol(bt.shared_factor_hpd(_t(A, dtype), psi),
                       _t(b, dtype)).numpy()
    assert _rel(xt, xj) < _tol(dtype, A)


def test_chol_of_indefinite_is_nan_like_jax():
    A = np.diag([1.0, -2.0, 3.0]).astype(np.complex128)
    Lj = np.asarray(bj.factor_chol(_j(A, np.complex128)).L)
    Lt = bt.factor_chol(_t(A, np.complex128)).L.numpy()
    assert np.isnan(Lj).any() and np.isnan(Lt).all()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_factor_solutions(n, dtype):
    A, b = _system(n)
    psi = 1e-6
    xj = bj.solve_factored(bj.shared_factor(_j(A, dtype), psi), _j(b, dtype))
    xt = bt.solve_factored(bt.shared_factor(_t(A, dtype), psi),
                           _t(b, dtype)).numpy()
    assert _rel(xt, xj) < _tol(dtype, A)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_factors(dtype):
    """A (K, N, N) batch: the LU factors it whole; the port's QR takes one
    operand at a time and solves as the JAX package's batched QR does."""
    K, n = 3, 64
    As, bs = zip(*(_system(n, seed=s) for s in range(K)))
    A = np.stack(As)
    b = np.stack(bs)
    tol = max(_tol(dtype, a) for a in As)
    xj = np.asarray(bj.solve_factored(bj.factor(_j(A, dtype)), _j(b, dtype)))
    xt = bt.solve_factored(bt.factor(_t(A, dtype)), _t(b, dtype)).numpy()
    assert xt.shape == (K, n)
    assert _rel(xt, xj) < tol
    xj = np.asarray(bj.solve_qr(bj.factor_qr(_j(A, dtype)), _j(b, dtype)))
    xt = np.stack([bt.solve_qr(bt.factor_qr(_t(a, dtype)), _t(bb, dtype)).numpy()
                   for a, bb in zip(As, bs)])
    assert _rel(xt, xj) < tol
