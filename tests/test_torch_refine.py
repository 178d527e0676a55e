"""ops/refine of the port against the JAX package, from the same complex64
starting point and the same factorization (the JAX package's factors, carried
over with ``fac_from_numpy``).

Both packages must certify rel ≤ tol with a true f64 residual, and their
iterates agree to 10·κ·tol relative: each is certified within tol in residual,
hence within κ·tol of the exact solution in forward error. The operand is
either the user's complex128 matrix (the JAX package's ``split_triple`` case)
or the complex64 working matrix itself (``refine_split_c64exact``, the hi-only
``split_triple_c64`` case)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from maus_tpu.ops import batched_solve as bj
from maus_tpu.ops import refine as fj
from maus_tpu.problems import generators as gen
from maus_tpu_torch.ops import refine as ft
from maus_tpu_torch.utils.convert import fac_from_numpy

torch.set_num_threads(1)

N = 96
TOL = 1e-10


def _sc(z):
    z = np.asarray(z, np.complex128)
    return fj.SplitComplex(jnp.asarray(z.real), jnp.asarray(z.imag))


def _setup(kappa, c64_exact, seed=3):
    A, b = gen.ill_conditioned_system(N, kappa, seed=seed)
    Ac = A.astype(np.complex64)
    if c64_exact:
        A = Ac.astype(np.complex128)
    fac = bj.factor_qr(jnp.asarray(Ac))
    x0 = np.array(bj.solve_qr(fac, jnp.asarray(b.astype(np.complex64))))
    return A, Ac, b, fac, x0


def _true_rel(A, x, b):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kappa", [1e2, 1e4])
@pytest.mark.parametrize("c64_exact", [False, True])
def test_refine_split_matches_jax(kappa, c64_exact):
    A, Ac, b, fac, x0 = _setup(kappa, c64_exact)
    if c64_exact:
        xs_j, rel_j = fj.refine_split_c64exact(jnp.asarray(Ac), fac, _sc(b),
                                               jnp.asarray(x0), steps=40, tol=TOL)
        A_t = torch.from_numpy(Ac)
    else:
        xs_j, rel_j = fj.refine_split(_sc(A), fac, _sc(b), jnp.asarray(x0),
                                      steps=40, tol=TOL)
        A_t = torch.from_numpy(A)
    x_j = np.asarray(xs_j.re) + 1j * np.asarray(xs_j.im)
    fac_t = fac_from_numpy(jax.tree.map(np.asarray, fac), torch.device("cpu"))
    x_t, rel_t = ft.refine_split(A_t, fac_t, torch.from_numpy(b),
                                 torch.from_numpy(x0), steps=40, tol=TOL)
    x_t = x_t.numpy()
    assert float(rel_j) <= TOL and rel_t <= TOL
    assert _true_rel(A, x_t, b) <= TOL * 1.01
    # the reported rel is the certified residual of the returned iterate, up
    # to the residual's own FP64 rounding (K1's bar, 1e-15·‖A‖_F·‖x‖)
    bar = 1e-15 * np.linalg.norm(A) * np.linalg.norm(x_t) / np.linalg.norm(b)
    assert abs(_true_rel(A, x_t, b) - rel_t) <= bar
    assert np.linalg.norm(x_t - x_j) <= 10 * kappa * TOL * np.linalg.norm(x_j)


@pytest.mark.parametrize("kappa", [1e2, 1e4])
def test_refine_gmres_matches_jax(kappa):
    A, Ac, b, fac, x0 = _setup(kappa, False, seed=4)
    xs_j, rel_j = fj.refine_gmres(_sc(A), fac, _sc(b), jnp.asarray(x0),
                                  steps=6, tol=TOL)
    x_j = np.asarray(xs_j.re) + 1j * np.asarray(xs_j.im)
    fac_t = fac_from_numpy(jax.tree.map(np.asarray, fac), torch.device("cpu"))
    x_t, rel_t = ft.refine_gmres(torch.from_numpy(A), fac_t, torch.from_numpy(b),
                                 torch.from_numpy(x0), steps=6, tol=TOL)
    x_t = x_t.numpy()
    assert float(rel_j) <= TOL and rel_t <= TOL
    assert _true_rel(A, x_t, b) <= TOL * 1.01
    assert np.linalg.norm(x_t - x_j) <= 10 * kappa * TOL * np.linalg.norm(x_j)


def test_refine_keeps_better_iterate_on_a_bad_preconditioner():
    """A NaN factorization makes every correction NaN: the keep-better guards
    must return the starting iterate and its certified residual."""
    A, Ac, b, fac, x0 = _setup(1e2, False)
    fac_t = fac_from_numpy(jax.tree.map(np.asarray, fac), torch.device("cpu"))
    fac_t.r = torch.full_like(fac_t.r, float("nan"))
    for fn in (ft.refine_split, ft.refine_gmres):
        x_t, rel_t = fn(torch.from_numpy(A), fac_t, torch.from_numpy(b),
                        torch.from_numpy(x0), steps=5, tol=TOL)
        np.testing.assert_array_equal(x_t.numpy(), x0.astype(np.complex128))
        assert rel_t == pytest.approx(_true_rel(A, x0.astype(np.complex128), b),
                                      rel=1e-12)


@pytest.mark.parametrize("fn", ["refine_split", "refine_gmres"])
def test_certification_rejects_a_worse_iterate(fn, monkeypatch):
    """Every certification after the first reports twice the starting
    residual (as when the carried working-dtype estimate lied): the guards
    must keep the starting iterate and its certified residual."""
    A, Ac, b, fac, x0 = _setup(1e2, False)
    fac_t = fac_from_numpy(jax.tree.map(np.asarray, fac), torch.device("cpu"))
    calls = []
    real = ft.true_residual

    def lying(A_, x_, b_):
        r = real(A_, x_, b_)
        calls.append(r)
        return r if len(calls) == 1 else 2.0 * calls[0]

    monkeypatch.setattr(ft, "true_residual", lying)
    x_t, rel_t = getattr(ft, fn)(torch.from_numpy(A), fac_t, torch.from_numpy(b),
                                 torch.from_numpy(x0), steps=5, tol=TOL)
    assert len(calls) >= 2
    np.testing.assert_array_equal(x_t.numpy(), x0.astype(np.complex128))
    assert rel_t == pytest.approx(_true_rel(A, x0.astype(np.complex128), b),
                                  rel=1e-12)
