"""Plain reference for an eig answer: each returned pair's residual
‖A·v − λ·v‖/‖v‖ in complex128 against the operand as served (complex64
entries, widened exactly), and how many distinct pairs are at tol.

Two pairs are one when their vectors are parallel to within an overlap
|⟨v, w⟩|/(‖v‖‖w‖) above ``SAME_VECTOR``: eigenvectors of distinct
eigenvalues are linearly independent, and of a Hermitian operand orthogonal.
The program itself keeps two pairs apart above an overlap of 0.99875 only
when their eigenvalues differ, so a sound answer never meets this bound.

Numbers judged (``judge``), an answer being ``(λ, V, claimed residuals)``:
``eig_resid``, over the window, the largest residual of an answer's
``target_solutions`` best pairs (infinite when it returned fewer) and of
every pair the program claims at ``tol``; limit: ``tol``. ``eig_short``, the
most distinct pairs at ``tol`` that an answer lacks of its target; limit 0.
"""
from __future__ import annotations

import math

import torch

C128 = torch.complex128
SAME_VECTOR = 0.999


def pair_residuals(A: torch.Tensor, lams: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(P,) residuals of the pairs (lams[p], V[p]) on the host, float64."""
    A64 = A.to(C128)
    Vd = V.to(device=A.device, dtype=C128)
    lam = lams.to(device=A.device, dtype=C128)
    R = Vd @ A64.T - lam[:, None] * Vd            # rows: (A v_p)ᵀ − λ_p v_pᵀ
    return (torch.linalg.vector_norm(R, dim=1)
            / torch.linalg.vector_norm(Vd, dim=1)).cpu().to(torch.float64)


def distinct_at_tol(res: torch.Tensor, V: torch.Tensor, tol: float) -> list:
    """Indices of the pairs at ``tol`` that are distinct, best first: a pair
    counts when its vector is not parallel to one counted before it."""
    U = V.to(C128)
    U = U / torch.linalg.vector_norm(U, dim=1, keepdim=True)
    kept = []
    for p in sorted(range(len(res)), key=lambda q: float(res[q])):
        if not float(res[p]) <= tol:
            break
        if all(abs(complex(torch.vdot(U[k], U[p]))) <= SAME_VECTOR for k in kept):
            kept.append(p)
    return kept


def _nan_high(x: float) -> float:
    return math.inf if math.isnan(x) else x


def judge(config: dict, records: list, rebuilt) -> dict:
    tol, target = float(config["tol"]), int(config["target_solutions"])
    worst, short = 0.0, 0
    for r in records:
        if r["answer"] is None:
            worst, short = math.inf, max(short, target)
            continue
        lams, V, claimed = r["answer"]
        A, _ = rebuilt(r)
        res = pair_residuals(A, lams, V)
        del A
        ranked = sorted(_nan_high(float(x)) for x in res)
        worst = max(worst, ranked[target - 1] if len(ranked) >= target else math.inf,
                    *(_nan_high(float(x)) for x, c in zip(res, claimed) if c <= tol))
        short = max(short, target - len(distinct_at_tol(res, V, tol)))
    return {"eig_resid": (worst, tol), "eig_short": (max(short, 0), 0)}
