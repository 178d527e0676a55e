"""Batched Lanczos: the largest-magnitude Ritz pairs of a Hermitian operand
from one start vector per candidate.

Counterpart of ``maus_tpu/ops/lanczos.py`` (the reference's ARPACK ``eigsh``
call on the sparse-Hermitian branch). The JAX ``vmap`` over candidates is
the batch dimension here: each of the m steps is one (K, N)·(N, N) product
for every candidate at once, then a full reorthogonalization (classical
Gram–Schmidt, twice) against the basis vectors built so far, and the small
(K, m, m) tridiagonal eigenproblems are one batched ``torch.linalg.eigh``.

``CALLS`` counts calls of :func:`lanczos_batched`, so a run can show which
Hermitian branch it took.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

CALLS = 0


class LanczosResult(NamedTuple):
    eigenvalues: torch.Tensor    # (K, k) Ritz values, in A's real dtype
    eigenvectors: torch.Tensor   # (K, k, N) unit Ritz vectors
    residuals: torch.Tensor      # (K, k) float32 ‖A y − θ y‖ per Ritz pair


def lanczos_batched(A: torch.Tensor, V0: torch.Tensor, k: int = 6,
                    m: int = 24) -> LanczosResult:
    """Largest-magnitude ``k`` eigenpairs of Hermitian A for each start vector.

    A: (N, N) Hermitian; V0: (K, N) start vectors (each candidate's own
    vector); ``k`` Ritz pairs to return; ``m`` ≥ k the Krylov dimension.
    The residuals are rounded to float32 whatever A's dtype, as in the JAX
    package, whose convergence test reads them. The caller sets the matmul
    precision (``utils/precision.full_precision``).
    """
    global CALLS
    CALLS += 1
    K, n = V0.shape
    dtype = V0.dtype
    rdt = dtype.to_real()
    tiny = torch.finfo(rdt).tiny
    v0 = V0 / torch.clamp_min(torch.linalg.vector_norm(V0, dim=-1,
                                                       keepdim=True), tiny)
    V = torch.zeros((K, m, n), dtype=dtype, device=V0.device)
    V[:, 0] = v0
    alpha = torch.zeros((K, m), dtype=rdt, device=V0.device)
    beta = torch.zeros((K, m), dtype=rdt, device=V0.device)
    built = torch.arange(m, device=V0.device)
    for j in range(m):
        v = V[:, j]
        w = v @ A.T
        a = (v.conj() * w).sum(-1).real
        alpha[:, j] = a
        w = w - a.to(dtype)[:, None] * v
        # full reorthogonalization against the vectors built so far, twice
        mask = (built <= j).to(dtype)
        for _ in range(2):
            coeff = (V.conj() @ w[:, :, None])[..., 0]                # (K, m)
            w = w - ((coeff * mask)[:, None, :] @ V)[:, 0]
        nb = torch.linalg.vector_norm(w, dim=-1)
        beta[:, j] = nb
        if j + 1 < m:
            V[:, j + 1] = torch.where(
                (nb > 1e-12)[:, None],
                w / torch.clamp_min(nb, tiny).to(dtype)[:, None], 0)
    T = torch.diag_embed(alpha) + torch.diag_embed(beta[:, :-1], 1) + \
        torch.diag_embed(beta[:, :-1], -1)
    theta, S = torch.linalg.eigh(T)                                   # ascending
    # largest magnitude k (the reference's which='LM'); ties keep the
    # ascending order, as jnp.argsort does
    order = torch.argsort(-theta.abs(), dim=-1, stable=True)[:, :k]
    theta_k = torch.gather(theta, 1, order)
    S_k = torch.gather(S, 2, order[:, None, :].expand(K, m, k))
    Y = S_k.to(dtype).transpose(1, 2) @ V                             # (K, k, N)
    Y = Y / torch.clamp_min(torch.linalg.vector_norm(Y, dim=-1, keepdim=True),
                            1e-30)
    resid = torch.linalg.vector_norm(
        Y @ A.T - theta_k[:, :, None].to(dtype) * Y, dim=-1)
    return LanczosResult(eigenvalues=theta_k, eigenvectors=Y,
                         residuals=resid.to(torch.float32))
