"""Ψ-regularization ladder — shift construction.

Counterpart of ``maus_tpu/ops/regularize.py``: solve ``(A + R) x = b`` with

    Ψ = psi_base · 10^(attempt/2) · 10^(stuck/3)
    R = Ψ·(I + 0.15·D_jitter),   D_jitter = diag(j/(N-1) for j in 0..N-1)

All Ψ arithmetic is float32, as in the reference.
"""
from __future__ import annotations

import torch


def pow10(t):
    """``10 ** t``, correctly rounded to ``t``'s dtype.

    The value is computed in float64 and rounded once: torch's float32
    ``pow`` differs from XLA's in the last bit for some half-decade
    exponents, and the Ψ rung (``solver/evolve._effective_psi``) is compared
    for exact equality to decide a refactorization.
    """
    if isinstance(t, torch.Tensor):
        return torch.pow(10.0, t.double()).to(t.dtype)
    return 10.0 ** t


def psi_magnitude(psi_base, aggression, attempt, stuck):
    """Ψ level with the strategy aggression factor folded in."""
    attempt = attempt.float() if isinstance(attempt, torch.Tensor) else float(attempt)
    stuck = stuck.float() if isinstance(stuck, torch.Tensor) else float(stuck)
    return psi_base * aggression * pow10(attempt / 2.0) * pow10(stuck / 3.0)


def shift_diagonal(n: int, psi, dtype, device=None) -> torch.Tensor:
    """Diagonal ``d`` of the regularization term, ``R = diag(d)``."""
    if isinstance(psi, torch.Tensor):
        device = psi.device
    jitter = torch.linspace(0.0, 0.15, n, dtype=torch.float32, device=device)
    d = psi * (1.0 + jitter)
    return d.to(dtype)


def apply_shift(A: torch.Tensor, psi) -> torch.Tensor:
    """``H = A + Ψ·(I + 0.15·jitter)`` as a new tensor (A is not modified)."""
    d = shift_diagonal(A.shape[-1], psi, A.dtype, device=A.device)
    H = A.clone()
    H.diagonal(dim1=-2, dim2=-1).add_(d)
    return H
