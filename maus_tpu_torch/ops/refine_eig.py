"""Mixed-precision finishers for eigenpairs and singular triplets.

Counterpart of ``maus_tpu/ops/refine_eig.py``. The evolve loop accepts
eigenpairs and triplets at the working dtype's floor (≈ √N·ε₃₂·‖A‖ in
complex64); these finishers take them to FP64-limited residuals.

Eigenpairs: Newton iteration on F(v, λ) = (Av − λv, vᴴv − 1):

    [A − λI   −v] [δv]   [−r]
    [  vᴴ      0] [δλ] = [ 0]

solved by bordered elimination against one working-dtype LU per candidate of
H_k = A − λ_k I + ψ_k I (δv = δλ·H⁻¹v − H⁻¹r).

Singular triplets: the same Newton step on the augmented Hermitian operator
[[0, A], [Aᴴ, 0]] with eigenpair (σ, [u; v]), block-eliminated so that the
only factorization is the N×N Gram system G_k = AᴴA − σ_k²I + ψI.

The iterates, Rayleigh quotients and residuals are native
``torch.complex128`` against the original operand; the JAX package's
split-f64 planes and sliced matvecs exist because the TPU has no complex128.
Its ``_percand_shifted_solver`` picks between a vmapped LU, a mapped LU and
a mapped QR to stay under XLA:TPU's scoped-VMEM cap; here every chunk is one
batched factorization by the port's LU (``ops/kernels/lu.lu_factor``:
kernels P3, P4 and K3 on the card), and every solve against it one launch
of kernel LS (``ops/kernels/lu_solve``), which reads each factor once: a
Newton step's two right-hand sides, H⁻¹v and H⁻¹r, go in one call.
"""
from __future__ import annotations

import math

import torch

from ..utils.metrics import span
from .kernels.lu import lu_factor
from .kernels.lu_solve import lu_perm, lu_solve

C128 = torch.complex128


def _percand_shifted_solver(M: torch.Tensor, diag: torch.Tensor):
    """Factor H_k = M + diag(d_k) for every row d_k of ``diag`` (K, N) (or
    a (K, 1) column, one shift per candidate) in one batched LU, and return
    ``solve(B) -> X`` against the K factorizations, for B of shape (K, N)
    or (K, N, 2) (two columns in one read of the factors). The pivots become
    a permutation once, here; each solve is one ``maus.refine_eig.solve``
    span."""
    K, N = diag.shape[0], M.shape[-1]
    H = M.expand(K, N, N).clone()
    H.diagonal(dim1=-2, dim2=-1).add_(diag)
    lu, piv = lu_factor(H)
    del H
    perm = lu_perm(lu, piv)

    def solve(B):
        with span("maus.refine_eig.solve"):
            return lu_solve(lu, perm, B)
    return solve


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
        U = solve(torch.stack([Vc, r.to(cdtype)], -1))
        u1, u2 = U[..., 0], U[..., 1]             # H⁻¹ v, H⁻¹ r
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
        solve = _percand_shifted_solver(
            Ac, -(lam_shift - psi_k.to(cdtype))[:, None])
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


def refine_svd_triplets(A64: torch.Tensor, sig0: torch.Tensor, U0: torch.Tensor,
                        V0: torch.Tensor, steps: int = 4, psi_rel: float = 3e-6
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Refine K singular-triplet candidates to FP64-limited residuals.

    A64: (M, N) complex128 original operand; sig0: (K,), U0: (K, M) and
    V0: (K, N) in the working dtype. The Gram G = AᴴA is formed in the
    working dtype (a plain matrix product, as in the JAX package) and
    G_k = G − σ_k²I + ψI with ψ = psi_rel·‖A‖_F/√min(M, N) is factored once
    per candidate. Crude starts (residual > 1.2e-4·‖A‖_F/√min(M, N)) first
    take two inverse-iteration sweeps on G_k, u re-derived as Av/‖Av‖; then
    ``steps`` Newton steps, each kept only where it lowers the residual.
    Triplets with σ < 1e-6·‖A‖_F/√min(M, N) (null vectors) pass through
    untouched.

    Returns ``(sigma (K,) float64, U (K, M) complex128, V (K, N) complex128,
    resid (K,) float64)`` with ‖u‖ = ‖v‖ = 1 and resid = ‖Av − σu‖ + ‖Aᴴu −
    σv‖ of the returned state, against A64.
    """
    cdtype = V0.dtype
    rdt = cdtype.to_real()
    N = V0.shape[1]
    anorm = torch.linalg.vector_norm(A64) / math.sqrt(min(A64.shape))
    psi = (psi_rel * anorm).to(torch.float32)

    def smv(X):                                   # rows A·x_k in FP64
        return X @ A64.T

    def smva(X):                                  # rows Aᴴ·x_k in FP64
        return X @ A64.conj()

    Ac = A64.to(cdtype)
    G = Ac.mH @ Ac                                # (N, N) working-dtype Gram
    sig_f = sig0.real.to(torch.float32)
    small = sig_f < 1e-6 * torch.clamp_min(anorm.to(torch.float32), 1e-30)
    sig_w = sig_f.to(rdt)
    solve = _percand_shifted_solver(
        G, (-(sig_w * sig_w) + psi.to(rdt)).to(cdtype)[:, None])

    U = _unit_rows(U0.to(C128))
    V = _unit_rows(V0.to(C128))
    sig = sig0.real.to(torch.float64)

    def resid_of(sig, U, V, Av=None):
        if Av is None:
            Av = smv(V)
        r1 = Av - sig[:, None] * U
        r2 = smva(U) - sig[:, None] * V
        return r1, r2, _norm(r1) + _norm(r2)

    # crude-start pre-polish: inverse iteration on the shifted Gram pulls v
    # toward the right singular vector nearest σ; u = Av/‖Av‖
    _, _, rn0 = resid_of(sig, U, V)
    crude = (rn0 > 1.2e-4 * anorm) & ~small
    for _ in range(2):
        Vc = _unit_rows(solve(V.to(cdtype)).to(C128))
        Uc = _unit_rows(smv(Vc))
        V = torch.where(crude[:, None], Vc, V)
        U = torch.where(crude[:, None], Uc, U)

    _, _, resid = resid_of(sig, U, V)
    for _ in range(steps):
        Av = smv(V)
        sig_new = _dot(U, Av).real
        r1, r2, rn = resid_of(sig_new, U, V, Av=Av)
        # Newton with δσ folded into the Rayleigh update:
        # (AᴴA − σ²) δv = −(σ r2 + Aᴴ r1), δu = (A δv + r1)/σ
        rhs = -(sig_new[:, None] * r2 + smva(r1))
        dv = solve(rhs.to(cdtype)).to(C128)
        sig_safe = torch.where(small, torch.ones_like(sig_new), sig_new)[:, None]
        du = (smv(dv) + r1) / sig_safe
        V_new = _unit_rows(V + dv)
        U_new = _unit_rows(U + du)
        Av2 = smv(V_new)
        sig2 = _dot(U_new, Av2).real
        _, _, rn2 = resid_of(sig2, U_new, V_new, Av=Av2)
        keep_new = (rn2 < rn) & ~small
        U = torch.where(keep_new[:, None], U_new, U)
        V = torch.where(keep_new[:, None], V_new, V)
        sig = torch.where(keep_new, sig2, torch.where(small, sig, sig_new))
        # the residual of the returned state: rn2 where the step is kept,
        # rn (at sig_new) where it is not, the entry residual for null σ
        resid = torch.where(small, resid, torch.where(keep_new, rn2, rn))
    return sig, U, V, resid
