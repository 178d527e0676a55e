"""Ψ-regularized direct solves: the shared factorization of the linear path.

Counterpart of ``maus_tpu/ops/batched_solve.py``. QR, Cholesky and the
triangular solves are library calls (``torch.linalg``), as the JAX package
leaves them to XLA. LU factorizations go through the port's own batched LU
(``ops/kernels/lu.lu_factor``: kernels P3, P4 and K3 on the card), the one
the JAX package parked as swappable here; ``torch.linalg.lu_solve`` takes
its factors unchanged. Every candidate of a linear system solves the same
``(A + ΨD) x = b``, so one factorization per Ψ level is computed and reused
across iterations. The eig path's per-candidate shifted solves escalate Ψ
through :func:`psi_ladder`; :func:`batched_shifted_solve` is its LU form,
used when the shared Hessenberg reduction is switched off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .kernels.lu import lu_factor
from .regularize import apply_shift, psi_magnitude, shift_diagonal


def _solve_upper(R: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(R, y.unsqueeze(-1), upper=True).squeeze(-1)


def _solve_lower(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, y.unsqueeze(-1), upper=False).squeeze(-1)


# ---------------------------------------------------------------------------
# LU
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LUFactors:
    """LU bundle in ``torch.linalg.lu_factor`` layout (1-based pivots)."""

    lu: torch.Tensor
    piv: torch.Tensor


def factor(H: torch.Tensor) -> LUFactors:
    """LU-factorize a square matrix or a (K, N, N) batch."""
    lu, piv = lu_factor(H)
    return LUFactors(lu, piv)


def solve_factored(fac: LUFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve(s) against an existing LU factorization; ``b`` is (..., N)."""
    return torch.linalg.lu_solve(fac.lu, fac.piv, b.unsqueeze(-1)).squeeze(-1)


def shared_factor(A: torch.Tensor, psi) -> LUFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once by LU."""
    return factor(apply_shift(A, psi))


# ---------------------------------------------------------------------------
# Hermitian-positive-definite path: Cholesky
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CholFactors:
    L: torch.Tensor


def factor_chol(H: torch.Tensor) -> CholFactors:
    """Cholesky of an HPD (possibly batched) matrix. Like ``jnp.linalg.
    cholesky``, a matrix that is not positive definite yields a NaN factor
    instead of an error; the engine reads that as a failed solve."""
    L, info = torch.linalg.cholesky_ex(H)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return CholFactors(torch.where(bad, torch.full_like(L, float("nan")), L))


def solve_chol(fac: CholFactors, b: torch.Tensor) -> torch.Tensor:
    """Two triangular solves against the Cholesky factor."""
    y = _solve_lower(fac.L, b)
    return _solve_upper(fac.L.mH, y)


def shared_factor_hpd(A: torch.Tensor, psi) -> CholFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once by Cholesky (HPD linear path)."""
    return factor_chol(apply_shift(A, psi))


# ---------------------------------------------------------------------------
# QR: the default shared linear factorization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QRFactors:
    """Householder-QR bundle; ``rinv`` is an optional explicit R⁻¹, with
    which every solve is two matrix-vector products instead of a product and
    a triangular substitution. In iterative refinement the correction solve
    is a preconditioner, so the O(ε·κ) forward error of an explicit inverse
    leaves the contraction rate unchanged."""

    q: torch.Tensor
    r: torch.Tensor
    rinv: Optional[torch.Tensor] = None


def invert_triangular(R: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Explicit inverse of an upper-triangular R by blocked recursion:

        [R₁₁ R₁₂]⁻¹   [R₁₁⁻¹   −R₁₁⁻¹ R₁₂ R₂₂⁻¹]
        [ 0  R₂₂]   = [ 0            R₂₂⁻¹     ]

    The off-diagonal work is matrix products; only ``block``-sized diagonal
    tiles go to the triangular solver. The blocks are written into one
    preallocated output instead of concatenated, which keeps the peak memory
    at one extra N² buffer (the JAX version concatenates)."""
    out = torch.zeros_like(R)
    _invert_into(R, out, block)
    return out


def _invert_into(R: torch.Tensor, out: torch.Tensor, block: int) -> None:
    n = R.shape[0]
    if n <= block:
        eye = torch.eye(n, dtype=R.dtype, device=R.device)
        out.copy_(torch.linalg.solve_triangular(R, eye, upper=True))
        return
    h = ((n // 2 + block - 1) // block) * block
    h = min(h, n - 1)
    _invert_into(R[:h, :h], out[:h, :h], block)
    _invert_into(R[h:, h:], out[h:, h:], block)
    out[:h, h:] = -(out[:h, :h] @ (R[:h, h:] @ out[h:, h:]))


def _want_rinv(H: torch.Tensor) -> bool:
    """Build R⁻¹ with the shared factorization for a single CUDA operand of
    N ≥ 1024: there a solve becomes two matrix-vector products. No upper
    cap: R⁻¹ adds one N² buffer, 2.1 GB at 16384² in complex64, far inside
    an 80 GB card. On the CPU the triangular substitution is already
    bandwidth-bound, and the JAX package builds no R⁻¹ there either."""
    return H.ndim == 2 and H.shape[0] >= 1024 and H.is_cuda


def factor_qr(H: torch.Tensor, with_rinv: Optional[bool] = None) -> QRFactors:
    q, r = torch.linalg.qr(H)
    if H.ndim != 2:
        return QRFactors(q, r, None)
    if with_rinv is None:
        with_rinv = _want_rinv(H)
    return QRFactors(q, r, invert_triangular(r) if with_rinv else None)


def solve_qr(fac: QRFactors, b: torch.Tensor) -> torch.Tensor:
    """x = R⁻¹ Qᴴ b, for ``b`` of shape (..., N)."""
    y = (fac.q.mH @ b.unsqueeze(-1)).squeeze(-1)
    if fac.rinv is not None:
        return (fac.rinv @ y.unsqueeze(-1)).squeeze(-1)
    return _solve_upper(fac.r, y)


def shared_factor_qr(A: torch.Tensor, psi,
                     with_rinv: Optional[bool] = None) -> QRFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once by QR (default linear path)."""
    return factor_qr(apply_shift(A, psi), with_rinv=with_rinv)


def solve_any(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve against whichever factorization bundle ``fac`` is."""
    if isinstance(fac, CholFactors):
        return solve_chol(fac, b)
    if isinstance(fac, QRFactors):
        return solve_qr(fac, b)
    return solve_factored(fac, b)


# ---------------------------------------------------------------------------
# Ψ ladder: per-candidate escalation of the eig path's shifted solves
# ---------------------------------------------------------------------------

def _finite_rows(x: torch.Tensor) -> torch.Tensor:
    return (torch.isfinite(x.real) & torch.isfinite(x.imag)).all(dim=-1)


def psi_ladder(solve_at, K: int, max_attempts: int, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``solve_at(attempt_k: (K,) int32) -> (K, N)`` solves at per-candidate
    attempt levels. Candidates whose result is finite are frozen; the ladder
    re-solves while some candidate is non-finite and has attempts left.
    Rows still non-finite at the end come back zero (the candidate layer
    reads a zero update as a failed solve). Returns ``(W, attempts)``."""
    attempts = torch.zeros((K,), dtype=torch.int32, device=device)
    W = solve_at(attempts)
    ok = _finite_rows(W)
    while bool((~ok & (attempts < max_attempts)).any()):
        attempts = torch.where(ok, attempts, attempts + 1)
        W_try = solve_at(attempts)
        W = torch.where(ok[:, None], W, W_try)
        ok = ok | _finite_rows(W_try)
    W = torch.where(ok[:, None], W, torch.zeros_like(W))
    return W, attempts


def batched_shifted_solve(A: torch.Tensor, lams: torch.Tensor,
                          stuck: torch.Tensor, psi_base, aggression,
                          B: torch.Tensor, max_attempts: int = 4
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve ``(A − λ_k I + Ψ_k D) w_k = B_k`` by one LU per candidate, with
    Ψ_k growing with the candidate's stuck counter and ladder attempt.
    Returns ``(W, attempts)``."""
    K, N = B.shape

    def solve_at(attempt_k):
        psi = psi_magnitude(psi_base, aggression, attempt_k, stuck)
        d = shift_diagonal(N, psi[:, None], A.dtype) - lams[:, None].to(A.dtype)
        H = A.expand(K, N, N).clone()
        H.diagonal(dim1=-2, dim2=-1).add_(d)
        fac = factor(H)
        return torch.linalg.lu_solve(fac.lu, fac.piv, B.unsqueeze(-1)).squeeze(-1)

    return psi_ladder(solve_at, K, max_attempts, device=B.device)
