"""ops/gmres of the port against the JAX package on the same Ψ-shifted,
Jacobi-preconditioned batched systems — the operator ``step_linear``'s
iterative branch builds.

Both must converge with the same restart counts; iterates agree to 10·κ·tol
relative (each meets tol on the preconditioned residual, so each is within
κ·tol of the exact solution)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from maus_tpu.ops import gmres as gj
from maus_tpu.ops import regularize as rj
from maus_tpu_torch.ops import gmres as gt
from maus_tpu_torch.ops import regularize as rt

torch.set_num_threads(1)


def _problem(n, K, dtype, seed=1):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        / np.sqrt(n) + 2.0 * np.eye(n)
    B = rng.standard_normal((K, n)) + 1j * rng.standard_normal((K, n))
    return A.astype(dtype), B.astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10), (np.complex64, 1e-5)])
@pytest.mark.parametrize("restart", [16, 32])
def test_gmres_matches_jax(dtype, tol, restart):
    n, K = 64, 3
    A, B = _problem(n, K, dtype)
    psi = np.float32(1e-3)
    dj = rj.shift_diagonal(n, jnp.asarray(psi), dtype)
    dt = rt.shift_diagonal(n, torch.tensor(psi), torch.from_numpy(A).dtype)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    pj = gj.jacobi_from_diag(jnp.diagonal(Aj) + dj)
    pt = gt.jacobi_from_diag(torch.diagonal(At) + dt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)

    rj_ = gj.gmres_batched(lambda X: X @ Aj.T + dj[None, :] * X, jnp.asarray(B),
                           precond_diag=jnp.broadcast_to(pj, (K, n)), tol=tol,
                           restart=restart, max_restarts=8)
    rt_ = gt.gmres_batched(lambda X: X @ At.T + dt[None, :] * X,
                           torch.from_numpy(B),
                           precond_diag=pt.expand(K, n), tol=tol,
                           restart=restart, max_restarts=8)
    assert np.asarray(rj_.converged).all() and rt_.converged.all()
    np.testing.assert_array_equal(rt_.iterations.numpy(), np.asarray(rj_.iterations))
    assert (rt_.rel_residual.numpy() <= tol).all()
    H = A.astype(np.complex128) + np.diag(np.asarray(dt.numpy(), np.complex128))
    kappa = np.linalg.cond(H)
    xj, xt = np.asarray(rj_.x), rt_.x.numpy()
    for k in range(K):
        assert np.linalg.norm(xt[k] - xj[k]) <= 10 * kappa * tol * np.linalg.norm(xj[k])
        r = np.linalg.norm(H @ xt[k] - B[k]) / np.linalg.norm(B[k])
        assert r <= 10 * kappa * tol


def test_gmres_keeps_converged_systems_untouched():
    n, K = 32, 2
    A, B = _problem(n, K, np.complex128, seed=3)
    At = torch.from_numpy(A)
    x0 = torch.from_numpy(np.linalg.solve(A, B.T).T.copy())
    res = gt.gmres_batched(lambda X: X @ At.T, torch.from_numpy(B), x0=x0,
                           tol=1e-8, restart=8)
    assert res.converged.all()
    np.testing.assert_array_equal(res.iterations.numpy(), [0, 0])
    np.testing.assert_array_equal(res.x.numpy(), x0.numpy())
