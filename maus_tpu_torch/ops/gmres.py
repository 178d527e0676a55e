"""Batched restarted GMRES with Jacobi preconditioning.

Counterpart of ``maus_tpu/ops/gmres.py``: one Arnoldi iteration for all K
systems is a single batched contraction plus one batched matvec; the operator
is a closure (matrix-free); left Jacobi preconditioning by ``1/diag`` with
finiteness and magnitude guards; classical Gram-Schmidt applied twice over a
fixed-size masked basis. The restart loop is an eager Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class GMRESResult:
    x: torch.Tensor             # (K, N) solution iterates
    rel_residual: torch.Tensor  # (K,) preconditioned relative residual
    iterations: torch.Tensor    # (K,) int32 per-system inner iterations
    converged: torch.Tensor     # (K,) bool


def jacobi_from_diag(diag: torch.Tensor) -> torch.Tensor:
    """Safe inverse-diagonal preconditioner: entries that are non-finite or
    smaller than 1e-12 in magnitude fall back to 1."""
    mag = diag.abs()
    ok = torch.isfinite(mag) & (mag > 1e-12)
    one = torch.ones_like(diag)
    safe = torch.where(ok, diag, one)
    return torch.where(ok, 1.0 / safe, one)


def _cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Conjugated inner product along the last axis."""
    return torch.sum(a.conj() * b, dim=-1)


def gmres_batched(matvec: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor,
                  x0: Optional[torch.Tensor] = None,
                  *,
                  precond_diag: Optional[torch.Tensor] = None,
                  tol: float = 1e-8,
                  restart: int = 32,
                  max_restarts: int = 8) -> GMRESResult:
    """Solve ``A_k x_k = b_k`` for K systems at once.

    ``matvec`` maps (K, N) → (K, N); ``b`` is (K, N); ``precond_diag`` an
    optional (K, N) inverse diagonal (see :func:`jacobi_from_diag`); ``tol``
    the relative tolerance on the preconditioned residual; at most
    ``restart·max_restarts`` inner iterations.
    """
    K, N = b.shape
    dtype, device = b.dtype, b.device
    m = restart
    if x0 is None:
        x0 = b
    Minv = precond_diag if precond_diag is not None else torch.ones_like(b)

    def apply_M(r):
        return Minv * r

    def vnorm(z):
        return torch.linalg.vector_norm(z, dim=-1)

    bnorm = vnorm(apply_M(b))
    tiny = torch.finfo(bnorm.dtype).tiny
    bnorm = torch.clamp_min(bnorm, tiny)
    slots = torch.arange(m + 1, device=device)

    def arnoldi_cycle(x):
        r = apply_M(b - matvec(x))
        beta = vnorm(r)
        beta_safe = torch.clamp_min(beta, tiny)
        V = torch.zeros((K, m + 1, N), dtype=dtype, device=device)
        V[:, 0] = r / beta_safe[:, None]
        H = torch.zeros((K, m + 1, m), dtype=dtype, device=device)
        for j in range(m):
            w = apply_M(matvec(V[:, j]))
            slot_mask = (slots <= j)[None, :]
            for _ in range(2):
                h = _cdot(V, w[:, None, :])
                h = torch.where(slot_mask, h, torch.zeros_like(h))
                w = w - torch.einsum("ks,ksn->kn", h, V)
                H[:, :, j] += h
            hnorm = vnorm(w)
            H[:, j + 1, j] = hnorm.to(dtype)
            V[:, j + 1] = w / torch.clamp_min(hnorm, tiny)[:, None]

        # least squares y = argmin ‖β e1 − H̄ y‖ per system, H̄: (m+1, m)
        e1 = torch.zeros((K, m + 1), dtype=dtype, device=device)
        e1[:, 0] = beta.to(dtype)
        Q, R = torch.linalg.qr(H)                          # (K,m+1,m), (K,m,m)
        rhs = (Q.mH @ e1.unsqueeze(-1)).squeeze(-1)
        # guard singular R (lucky breakdown): Tikhonov-damp
        Rd = R + 1e-30 * torch.eye(m, dtype=dtype, device=device)
        y = torch.linalg.solve_triangular(Rd, rhs.unsqueeze(-1),
                                          upper=True).squeeze(-1)
        x_new = x + torch.einsum("km,kmn->kn", y, V[:, :m])
        rel = vnorm(apply_M(b - matvec(x_new))) / bnorm
        finite = torch.isfinite(torch.view_as_real(x_new) if x_new.is_complex()
                                else x_new)
        finite = finite.reshape(K, -1).all(dim=-1)
        x_new = torch.where(finite[:, None], x_new, x)
        rel = torch.where(finite, rel, torch.full_like(rel, float("inf")))
        return x_new, rel

    x = x0
    rel = vnorm(apply_M(b - matvec(x0))) / bnorm
    iters = torch.zeros((K,), dtype=torch.int32, device=device)
    it = 0
    while it < max_restarts and bool(torch.any(rel > tol)):
        x_new, rel_new = arnoldi_cycle(x)
        # systems that already met tol stay untouched and stop counting
        keep = rel <= tol
        x = torch.where(keep[:, None], x, x_new)
        rel = torch.where(keep, rel, rel_new)
        iters = torch.where(keep, iters, iters + m)
        it += 1
    return GMRESResult(x=x, rel_residual=rel, iterations=iters,
                       converged=rel <= tol)
