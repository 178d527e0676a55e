"""The port's batched Lanczos (``ops/lanczos.py``) against the JAX package's
``lanczos_batched`` on the fixtures of tests/test_lanczos.py, from the same
start vectors, in complex128.

Tolerances: Ritz values within 1e-10 relative (the two packages run the same
recurrence; the rounding differs only in summation order); Ritz vectors to
1e-8 after aligning each one's phase (the eigenvectors of the real
tridiagonal T are fixed only up to sign by LAPACK); residuals within 1e-5
relative, since both round them to float32, or 1e-12 absolute where they
sit at the rounding floor (the full-subspace fixture, m = N, where both are
~1e-14 on an operand of norm ~10)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maus_tpu.ops.lanczos import lanczos_batched as lanczos_j
from maus_tpu.problems import generators as gen
from maus_tpu_torch.ops import lanczos as lanczos_t

torch.set_num_threads(1)


def _align(y, ref):
    """y times the unit phase that best matches it to ``ref``."""
    p = np.vdot(y, ref)
    return y * (p / abs(p)) if abs(p) > 0 else y


@pytest.mark.parametrize("n,K,k,m,seed,vseed", [(64, 4, 6, 40, 0, 1),
                                                 (32, 2, 4, 32, 2, 3)])
def test_lanczos_matches_jax(n, K, k, m, seed, vseed):
    A = gen.hermitian_matrix(n, seed=seed)
    rng = np.random.default_rng(vseed)
    V0 = rng.standard_normal((K, n)) + 1j * rng.standard_normal((K, n))
    rj = lanczos_j(jnp.asarray(A), jnp.asarray(V0), k=k, m=m)
    calls = lanczos_t.CALLS
    rt = lanczos_t.lanczos_batched(torch.from_numpy(A), torch.from_numpy(V0),
                                   k=k, m=m)
    assert lanczos_t.CALLS == calls + 1
    assert rt.eigenvalues.dtype == torch.float64
    assert rt.eigenvectors.shape == (K, k, n)
    assert rt.residuals.dtype == torch.float32
    th_j, th_t = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    np.testing.assert_allclose(th_t, th_j, rtol=1e-10, atol=1e-10 * np.abs(th_j).max())
    Y_j, Y_t = np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()
    for b in range(K):
        for i in range(k):
            assert abs(np.linalg.norm(Y_t[b, i]) - 1.0) < 1e-12
            np.testing.assert_allclose(_align(Y_t[b, i], Y_j[b, i]), Y_j[b, i],
                                       atol=1e-8)
    r_j, r_t = np.asarray(rj.residuals), rt.residuals.numpy()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-5, atol=1e-12)
    # the dominant pairs are found, as tests/test_lanczos.py holds the JAX
    # package: the extremal Ritz values against the dense spectrum
    w = np.linalg.eigvalsh(A)
    dominant = np.sort(w[np.argsort(-np.abs(w))[:k]])
    assert np.max(np.abs(np.sort(th_t, axis=1)[:, [0, -1]]
                         - dominant[[0, -1]])) < 1e-6


def test_lanczos_breakdown_gives_zero_basis_vectors():
    """A start vector inside a 3-dimensional invariant subspace of a
    unit-norm operand: the Krylov space is exhausted after three steps (the
    rounding left in w, ~1e-15, is under the 1e-12 cut), the later basis
    vectors are zero, and the three Ritz pairs of the subspace are exact."""
    n, m = 16, 8
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    w = np.arange(1.0, n + 1.0) / n
    A = (Q * w) @ Q.conj().T
    V0 = (Q[:, :3] @ np.array([1.0, 0.5, 0.25]))[None, :]
    rt = lanczos_t.lanczos_batched(torch.from_numpy(A), torch.from_numpy(V0),
                                   k=3, m=m)
    rj = lanczos_j(jnp.asarray(A), jnp.asarray(V0), k=3, m=m)
    np.testing.assert_allclose(np.sort(rt.eigenvalues.numpy()[0]), w[:3], atol=1e-12)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues),
                               atol=1e-12)
    assert float(rt.residuals.max()) < 1e-12
