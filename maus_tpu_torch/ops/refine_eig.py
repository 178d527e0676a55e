"""Mixed-precision finisher for eigenpairs.

Counterpart of ``maus_tpu/ops/refine_eig.py::refine_eigenpairs``. The evolve
loop accepts eigenpairs at the working dtype's floor (≈ √N·ε₃₂·‖A‖ in
complex64); this finisher takes them to FP64-limited residuals by Newton
iteration on F(v, λ) = (Av − λv, vᴴv − 1):

    [A − λI   −v] [δv]   [−r]
    [  vᴴ      0] [δλ] = [ 0]

solved by bordered elimination against one working-dtype LU per candidate of
H_k = A − λ_k I + ψ_k I (δv = δλ·H⁻¹v − H⁻¹r). The iterates, Rayleigh
quotients and residuals are native ``torch.complex128`` against the original
operand; the JAX package's split-f64 planes and sliced matvecs exist because
the TPU has no complex128. Its ``_percand_shifted_solver`` picks between a
vmapped LU, a mapped LU and a mapped QR to stay under XLA:TPU's scoped-VMEM
cap; here every chunk is one batched ``torch.linalg.lu_factor``.
``refine_svd_triplets`` arrives with the SVD slice.
"""
from __future__ import annotations

import math

import torch

C128 = torch.complex128


def _norm(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(X, dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a, b⟩ = Σ conj(a)·b along the last axis."""
    return torch.sum(a.conj() * b, dim=-1)


def _div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x / y with |y|² floored at 1e-30, as the JAX package's ``_sdiv``."""
    return x * y.conj() / torch.clamp_min(y.abs() ** 2, 1e-30)


def _unit_rows(X: torch.Tensor) -> torch.Tensor:
    return X / torch.clamp_min(_norm(X), 1e-30)[:, None]


def _finite_rows(X: torch.Tensor) -> torch.Tensor:
    return (torch.isfinite(X.real) & torch.isfinite(X.imag)).all(dim=-1)


def _bordered_newton(smv, solve, V: torch.Tensor, lam_init: torch.Tensor,
                     steps: int, cdtype):
    """``steps`` bordered-Newton iterations, returning each candidate's BEST
    observed state by FP64 residual. The iterate advances through a finite
    but worse step (rejecting it would make any one-step rise absorbing at a
    fixed factorization); only a non-finite step keeps the old iterate.
    Returns ``(V, lam, resid)``."""
    K = V.shape[0]

    def rayleigh_resid(V):
        W = smv(V)
        lam = _div(_dot(V, W), _dot(V, V))
        r = W - lam[:, None] * V
        return lam, r, _norm(r)

    bV, blam = V, lam_init
    brn = torch.full((K,), math.inf, dtype=torch.float64, device=V.device)
    for _ in range(steps):
        lam_new, r, rn = rayleigh_resid(V)
        cur_better = torch.isfinite(rn) & (rn < brn)
        bV = torch.where(cur_better[:, None], V, bV)
        blam = torch.where(cur_better, lam_new, blam)
        brn = torch.where(cur_better, rn, brn)
        Vc = V.to(cdtype)
        u1 = solve(Vc)                            # H⁻¹ v
        u2 = solve(r.to(cdtype))                  # H⁻¹ r
        num = _dot(Vc, u2)
        den = _dot(Vc, u1)
        den = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
        dv = (num / den)[:, None] * u1 - u2       # δλ H⁻¹v − H⁻¹r
        V_new = _unit_rows(V + dv.to(C128))
        V = torch.where(_finite_rows(V_new)[:, None], V_new, V)
    lam_f, _, rn_f = rayleigh_resid(V)
    fin_better = torch.isfinite(rn_f) & (rn_f < brn)
    return (torch.where(fin_better[:, None], V, bV),
            torch.where(fin_better, lam_f, blam),
            torch.where(fin_better, rn_f, brn))


def refine_eigenpairs(A64: torch.Tensor, lam0: torch.Tensor, V0: torch.Tensor,
                      steps: int = 4, psi_rel: float = 3e-6, rounds: int = 2
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine K eigenpair candidates to FP64-limited residuals.

    A64: (N, N) complex128 original operand; lam0: (K,) and V0: (K, N) in
    the working dtype. ``steps`` Newton steps per round; ψ = psi_rel·‖A‖_F/√N
    regularizes the first round's factorization. Each round refactors at the
    previous round's Rayleigh quotients (RQI), and ψ shrinks to
    min(ψ, 1e-4·residual) per candidate: ψ perturbs the Newton Jacobian,
    which stalls pseudospectrally ill-conditioned pairs of non-normal
    operands at O(ψ·non-normality).

    Returns ``(lam (K,) complex128, V (K, N) complex128, resid (K,) float64)``
    with ‖v‖ = 1 and resid = ‖Av − λv‖ against A64.
    """
    cdtype = V0.dtype
    K, N = V0.shape
    anorm = torch.linalg.vector_norm(A64) / math.sqrt(N)
    psi = (psi_rel * anorm).to(torch.float32)

    def smv(X):                                   # rows A·x_k in FP64
        return X @ A64.T

    Ac = A64.to(cdtype)

    def one_round(lam_shift, V, lam_init, psi_k):
        """Factor H_k = A − (λ_k − ψ_k) I, run two masked inverse-iteration
        sweeps on crude starts (residual > 1.2e-4·‖A‖_F/√N, which a Newton
        step from ~0.1 off the eigenvector would not fix), then Newton."""
        H = Ac.expand(K, N, N).clone()
        H.diagonal(dim1=-2, dim2=-1).sub_(
            (lam_shift - psi_k.to(cdtype))[:, None])
        lu, piv = torch.linalg.lu_factor(H)
        del H

        def solve(B):
            return torch.linalg.lu_solve(lu, piv, B.unsqueeze(-1)).squeeze(-1)

        W0 = smv(V)
        lam_e = _div(_dot(V, W0), _dot(V, V))
        crude = _norm(W0 - lam_e[:, None] * V) > 1.2e-4 * anorm
        for _ in range(2):
            U = _unit_rows(solve(V.to(cdtype)).to(C128))
            V = torch.where(crude[:, None], U, V)
        return _bordered_newton(smv, solve, V, lam_init, steps, cdtype)

    V = _unit_rows(V0.to(C128))
    lam_init = lam0.to(C128)
    lam_shift = lam0
    psi_k = psi.expand(K).clone()
    for _ in range(rounds):
        V, lam, resid = one_round(lam_shift, V, lam_init, psi_k)
        # Rayleigh-quotient refactoring for the next round (rounded through
        # complex64, as the JAX package does)
        lam_shift = lam.to(torch.complex64).to(cdtype)
        lam_init = lam
        r32 = resid.to(torch.float32)
        psi_k = torch.where(torch.isfinite(r32), torch.minimum(psi, 1e-4 * r32),
                            psi)
    return lam, V, resid
