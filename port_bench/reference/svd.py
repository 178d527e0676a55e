"""Plain reference for an SVD answer: each returned triplet's two-sided
residual ‖A·v − σ·u‖ + ‖Aᴴ·u − σ·v‖, u and v scaled to unit length, in
complex128 against the operand as served (complex64 entries, widened
exactly), and how many of the operand's largest singular values distinct
triplets at tol account for.

The operand's singular values are known: the configuration's σ_k =
``sigma_ratio``^k for k < ``sigma_top`` (then a tail far below). A triplet
matches σ_k when |σ − σ_k| ≤ ``MATCH`` = 1e-6. Serving the operand in
complex64 moves each σ by at most the rounding's 2-norm (Weyl), ≲ 1e-8 at
4096×2048 with ‖A‖₂ = σ₀ = 1, and rephasing by unit-modulus diagonals moves
none; the nearest other singular value is ≥ 0.007 away (σ₁₅ = 0.8¹⁵ ≈ 0.035
against the tail's 0.01). So a sound triplet matches its σ_k with room on
both sides, and no triplet matches two. Two triplets are one when their v
are parallel to within an overlap |⟨v, w⟩|/(‖v‖‖w‖) above ``SAME_VECTOR``,
as in ``reference/eig.py``: right singular vectors of distinct singular
values are orthogonal.

Numbers judged (``judge``), an answer being ``(σ, U, V, claimed
residuals)``: ``svd_resid``, over the window, the largest residual of an
answer's ``target_solutions`` best triplets (infinite when it returned
fewer) and of every triplet the program claims at ``tol``; limit: ``tol``
(‖A‖₂ = 1, so it is also the relative residual). ``svd_short``, the most of
the ``target_solutions`` largest singular values that an answer's distinct
triplets at ``tol`` leave unmatched; limit 0.
"""
from __future__ import annotations

import math

import torch

C128 = torch.complex128
MATCH = 1e-6
SAME_VECTOR = 0.999


def known_sigma(config: dict, count: int) -> torch.Tensor:
    """The configuration's ``count`` largest singular values, float64."""
    ratio, top = float(config["sigma_ratio"]), int(config["sigma_top"])
    if count > top:
        raise ValueError(f"the configuration knows {top} separated singular values, "
                         f"not {count}")
    return ratio ** torch.arange(count, dtype=torch.float64)


def _unit(X: torch.Tensor) -> torch.Tensor:
    return X / torch.linalg.vector_norm(X, dim=1, keepdim=True)


def triplet_residuals(A: torch.Tensor, sig: torch.Tensor, U: torch.Tensor,
                      V: torch.Tensor) -> torch.Tensor:
    """(P,) residuals ‖A v_p − σ_p u_p‖ + ‖Aᴴ u_p − σ_p v_p‖ of the triplets
    (sig[p], U[p], V[p]) with u, v of unit length, on the host, float64."""
    A64 = A.to(C128)
    Ud = _unit(U.to(device=A.device, dtype=C128))
    Vd = _unit(V.to(device=A.device, dtype=C128))
    s = sig.to(device=A.device, dtype=torch.float64)[:, None]
    r1 = Vd @ A64.T - s * Ud                       # rows: (A v_p)ᵀ − σ_p u_pᵀ
    r2 = Ud @ A64.conj() - s * Vd                  # rows: (Aᴴ u_p)ᵀ − σ_p v_pᵀ
    return (torch.linalg.vector_norm(r1, dim=1)
            + torch.linalg.vector_norm(r2, dim=1)).cpu()


def distinct_at_tol(res: torch.Tensor, V: torch.Tensor, tol: float) -> list:
    """Indices of the triplets at ``tol`` that are distinct, best first: a
    triplet counts when its v is not parallel to one counted before it."""
    W = _unit(V.to(C128))
    kept = []
    for p in sorted(range(len(res)), key=lambda q: float(res[q])):
        if not float(res[p]) <= tol:
            break
        if all(abs(complex(torch.vdot(W[k], W[p]))) <= SAME_VECTOR for k in kept):
            kept.append(p)
    return kept


def unmatched(known: torch.Tensor, sig: torch.Tensor) -> int:
    """How many of ``known`` no σ of ``sig`` lies within ``MATCH`` of."""
    if len(sig) == 0:
        return len(known)
    gap = (known[:, None] - sig.to(torch.float64)[None, :]).abs()
    return int((~(gap <= MATCH).any(dim=1)).sum())


def _nan_high(x: float) -> float:
    return math.inf if math.isnan(x) else x


def judge(config: dict, records: list, rebuilt) -> dict:
    tol, target = float(config["tol"]), int(config["target_solutions"])
    known = known_sigma(config, target)
    worst, short = 0.0, 0
    for r in records:
        if r["answer"] is None:
            worst, short = math.inf, max(short, target)
            continue
        sig, U, V, claimed = r["answer"]
        A, _ = rebuilt(r)
        res = triplet_residuals(A, sig, U, V)
        del A
        ranked = sorted(_nan_high(float(x)) for x in res)
        worst = max(worst, ranked[target - 1] if len(ranked) >= target else math.inf,
                    *(_nan_high(float(x)) for x, c in zip(res, claimed) if c <= tol))
        kept = distinct_at_tol(res, V, tol)
        short = max(short, unmatched(known, sig[kept]))
    return {"svd_resid": (worst, tol), "svd_short": (short, 0)}
