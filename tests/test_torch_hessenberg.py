"""The port's Hessenberg reductions against the JAX package's, on the same A.

Both packages build the same Householder reflectors in the same order, so H
and Q agree entry by entry; in complex128 to 1e-10 relative to ‖A‖_F (the
reductions are backward stable, and the two differ only in the order of their
floating-point sums). Independently of the JAX package: Q is unitary,
Q H Qᴴ = A, and the entries below the subdiagonal are exactly 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maus_tpu.ops import hessenberg as hj
from maus_tpu_torch.ops import hessenberg as ht

torch.set_num_threads(1)

TOL = 1e-10


def _operand(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        / np.sqrt(n)


def _check_factorization(A, h, q):
    n = A.shape[0]
    scale = np.linalg.norm(A)
    assert np.all(np.tril(h, -2) == 0)
    assert np.linalg.norm(q.conj().T @ q - np.eye(n)) <= TOL * np.sqrt(n)
    assert np.linalg.norm(q @ h @ q.conj().T - A) <= TOL * scale


# (N, nb): N = 16 with nb = 4 runs three full panels and a one-column
# remainder; N = 200 with nb = 64 runs three panels and six remainder columns
@pytest.mark.parametrize("kind", ["plain", "blocked", "auto"])
@pytest.mark.parametrize("n,nb", [(2, 64), (16, 4), (200, 64)])
def test_reduction_matches_jax(kind, n, nb):
    A = _operand(n, seed=n)
    fn_j = {"plain": lambda a: hj.reduce_hessenberg(a),
            "blocked": lambda a: hj.reduce_hessenberg_blocked(a, nb=nb),
            "auto": lambda a: hj.reduce_hessenberg_auto(a, nb=nb)}[kind]
    fn_t = {"plain": lambda a: ht.reduce_hessenberg(a),
            "blocked": lambda a: ht.reduce_hessenberg_blocked(a, nb=nb),
            "auto": lambda a: ht.reduce_hessenberg_auto(a, nb=nb)}[kind]
    cj = fn_j(jnp.asarray(A))
    ct = fn_t(torch.from_numpy(A))
    h_j, q_j = np.asarray(cj.h), np.asarray(cj.q)
    h_t, q_t = ct.h.numpy(), ct.q.numpy()
    assert ct.h.is_contiguous() and h_t.dtype == np.complex128
    scale = np.linalg.norm(A)
    assert np.linalg.norm(h_t - h_j) <= TOL * scale
    assert np.linalg.norm(q_t - q_j) <= TOL * np.sqrt(n)
    _check_factorization(A, h_t, q_t)


def test_auto_picks_blocked_only_when_panels_pay():
    """The switch point is the JAX package's: N − 2 ≥ 2·nb."""
    for n, nb, blocked in ((129, 64, False), (130, 64, True), (10, 4, True),
                           (9, 4, False)):
        A = torch.from_numpy(_operand(n, seed=1))
        ref = (ht.reduce_hessenberg_blocked(A, nb=nb) if blocked
               else ht.reduce_hessenberg(A))
        got = ht.reduce_hessenberg_auto(A, nb=nb)
        assert torch.equal(got.h, ref.h) and torch.equal(got.q, ref.q)


def test_complex64_reduction_is_backward_stable():
    """The card's working dtype: the blocked reduction of a complex64 A at
    ε₃₂-level accuracy (1e-5 relative, about 100·ε₃₂·√N)."""
    A = _operand(160, seed=3).astype(np.complex64)
    c = ht.reduce_hessenberg_auto(torch.from_numpy(A), nb=32)
    assert c.h.dtype == torch.complex64
    h, q = c.h.numpy().astype(np.complex128), c.q.numpy().astype(np.complex128)
    assert np.all(np.tril(h, -2) == 0)
    assert np.linalg.norm(q @ h @ q.conj().T - A) <= 1e-5 * np.linalg.norm(A)
    assert np.linalg.norm(q.conj().T @ q - np.eye(160)) <= 1e-5 * np.sqrt(160)
