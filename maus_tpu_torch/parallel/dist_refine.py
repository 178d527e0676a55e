"""Distributed FP64 finishers for eigenpairs and singular triplets.

Counterpart of ``maus_tpu/parallel/dist_refine.py``. The single-device
finishers (``ops/refine_eig.py``) factor a full N×N operator per candidate,
memory an operand that only fits sharded does not have. Here:

* **Eigenpairs** (:func:`dist_refine_eigenpairs`) — the same bordered
  Newton step (δv = δλ·H⁻¹v − H⁻¹r), its two correction solves through the
  column-sharded Hessenberg form the mesh engine already built
  (``dist_hessenberg.dist_solve_shifted``, both in one sweep), the shift
  refactored at the Rayleigh quotient every step while the residual is
  above the complex64 cloud, ψ tied to the residual.
* **Singular triplets** (:func:`dist_refine_svd`) — the augmented-operator
  Newton step of ``refine_svd_triplets``, the Gram system (AᴴA − σ² + ψ)
  dv = rhs solved by projected, Jacobi-preconditioned GMRES (``ops/gmres``)
  whose matvec is two sharded products, with Eisenstat–Walker forcing.

Iterates and residuals are native complex128 against the column-sharded
complex128 copy of the user's operand (:func:`stage_spectral`); the JAX
package's split-f64 planes exist for the TPU. Not carried over: the
column-sharded bf16 slice ladder (``dist_slice_operand``,
``dist_sliced_residual``), a TPU workaround.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.gmres import gmres_batched, jacobi_from_diag
from ..ops.refine_eig import _div, _dot, _finite_rows, _norm, _unit_rows
from . import comm
from .dist_hessenberg import DistHess, dist_solve_shifted
from .dist_qr import _compute_dtype, _finite, _shard
from .mesh import Mesh, column_range
from .placement import matvec_adj, matvec_rows

C128 = torch.complex128
_EPS32 = float(np.finfo(np.float32).eps)


def stage_spectral(mesh: Mesh, A, dtype=None):
    """This rank's (M, N/m) shard of an eig/SVD operand: ``(A_loc, A64_loc)``,
    the working-dtype copy (the caller's ``dtype``, else complex128 on the
    CPU and complex64 on the card) and the complex128 copy of the user's
    data that the finishers certify against."""
    lo, hi = column_range(A.shape[-1], mesh)
    part, _ = _shard(A, lo, hi, mesh.device)
    if not _finite(part):
        raise ValueError("matrix contains non-finite entries")
    return part.to(_compute_dtype(mesh.device, dtype)).contiguous(), \
        part.to(C128).contiguous()


def _sum_sq(mesh: Mesh, X_loc: torch.Tensor) -> torch.Tensor:
    return comm.all_reduce((X_loc.abs() ** 2).sum(), mesh)


def dist_refine_eigenpairs(mesh: Mesh, hess: DistHess, A64_loc: torch.Tensor,
                           lam0: torch.Tensor, V0: torch.Tensor,
                           steps: int = 5, psi_rel: float = 3e-6):
    """Refine K eigenpair candidates (``lam0`` (K,), ``V0`` (K, N) in the
    working dtype) to FP64-limited residuals against the sharded A. Returns
    ``(lam (K,) complex128, V (K, N) complex128, resid (K,) float64)``, each
    candidate's best state by residual ‖Av − λv‖, ‖v‖ = 1."""
    cdtype = V0.dtype
    K, N = V0.shape
    anorm = float(torch.sqrt(_sum_sq(mesh, A64_loc) / N))
    psi = torch.tensor(psi_rel * anorm, dtype=torch.float32, device=V0.device)

    def rayleigh_resid(V):
        W = matvec_rows(mesh, A64_loc, V)
        lam = _div(_dot(V, W), _dot(V, V))
        r = W - lam[:, None] * V
        return lam, r, _norm(r)

    V = _unit_rows(V0.to(C128))
    lam_sh, psi_k = lam0, psi.expand(K).clone()
    bV, blam = V, lam0.to(C128)
    brn = torch.full((K,), math.inf, dtype=torch.float64, device=V0.device)
    for _ in range(steps):
        lam_new, r, rn = rayleigh_resid(V)
        cur_better = torch.isfinite(rn) & (rn < brn)
        bV = torch.where(cur_better[:, None], V, bV)
        blam = torch.where(cur_better, lam_new, blam)
        brn = torch.where(cur_better, rn, brn)
        Vc = V.to(cdtype)
        U = dist_solve_shifted(mesh, hess, lam_sh.repeat(2),
                               torch.cat([Vc, r.to(cdtype)]), psi_k.repeat(2))
        u1, u2 = U[:K], U[K:]                     # H⁻¹ v, H⁻¹ r
        den = _dot(Vc, u1)
        den = torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
        dv = (_dot(Vc, u2) / den)[:, None] * u1 - u2
        V_new = _unit_rows(V + dv.to(C128))
        ok = _finite_rows(V_new)
        V = torch.where(ok[:, None], V_new, V)
        # refactor the shift at the Rayleigh quotient while the residual is
        # above the complex64 rounding cloud, then freeze it
        refactor = ok & (rn > 100.0 * _EPS32 * anorm)
        lam_sh = torch.where(refactor, lam_new.to(torch.complex64).to(cdtype),
                             lam_sh)
        r32 = rn.to(torch.float32)
        psi_new = torch.where(torch.isfinite(r32), torch.minimum(psi, 1e-4 * r32),
                              psi)
        psi_k = torch.where(refactor, psi_new, psi_k)
    lam_f, _, rn_f = rayleigh_resid(V)
    fin = torch.isfinite(rn_f) & (rn_f < brn)
    return (torch.where(fin, lam_f, blam), torch.where(fin[:, None], V, bV),
            torch.where(fin, rn_f, brn))


def dist_refine_svd(mesh: Mesh, A_loc: torch.Tensor, A64_loc: torch.Tensor,
                    sig0: torch.Tensor, U0: torch.Tensor, V0: torch.Tensor,
                    steps: int = 5, psi_rel: float = 3e-6,
                    inner_restart: int = 24):
    """Refine K singular-triplet candidates to FP64-limited residuals with
    no N×N factorization. ``A_loc`` is the working-dtype shard (the GMRES
    operator's), ``A64_loc`` the complex128 one. Triplets with σ below
    1e-6·‖A‖_F/√min(M, N) pass through. Returns ``(sigma (K,) float64,
    U (K, M), V (K, N) complex128, resid (K,) float64)``, resid =
    ‖Av − σu‖ + ‖Aᴴu − σv‖ of the returned state."""
    cdtype = V0.dtype
    M = A64_loc.shape[0]
    K, N = V0.shape
    lo, _ = column_range(N, mesh)
    anorm = float(torch.sqrt(_sum_sq(mesh, A64_loc) / min(M, N)))
    psi = torch.tensor(psi_rel * anorm * anorm, dtype=torch.float32,
                       device=V0.device)

    def smv(X):
        return matvec_rows(mesh, A64_loc, X)

    def smva(X):
        return matvec_adj(mesh, A64_loc, X)

    small = sig0.real.to(torch.float32) < 1e-6 * max(anorm, 1e-30)
    # the Gram operator's Jacobi diagonal: A's squared column norms
    coldiag = comm.gather((A64_loc.abs() ** 2).sum(dim=0), lo, N, mesh
                          ).to(torch.float32)
    U = _unit_rows(U0.to(C128))
    V = _unit_rows(V0.to(C128))
    sig = sig0.real.to(torch.float64)

    def resid_of(sig, U, V, Av=None):
        if Av is None:
            Av = smv(V)
        r1 = Av - sig[:, None] * U
        r2 = smva(U) - sig[:, None] * V
        return r1, r2, _norm(r1) + _norm(r2)

    def gram_solve(rhs, sig_new, Vc, eta):
        """Projected inexact solve of (AᴴA − σ² + ψ) t = rhs, t ⊥ v, to the
        per-candidate forcing tolerance ``eta``."""
        shift = sig_new.to(torch.float32) ** 2

        def cproj(X):
            return X - torch.sum(Vc.conj() * X, dim=-1, keepdim=True) * Vc

        def matvec(Z):
            Zp = cproj(Z)
            G = matvec_adj(mesh, A_loc, matvec_rows(mesh, A_loc, Zp))
            return cproj(G - (shift - psi)[:, None].to(G.real.dtype) * Zp)

        diag = (coldiag[None, :] - shift[:, None] + psi).to(cdtype)
        res = gmres_batched(matvec, cproj(rhs), x0=torch.zeros_like(rhs),
                            precond_diag=jacobi_from_diag(diag), tol=eta,
                            restart=inner_restart, max_restarts=2)
        return cproj(res.x)

    _, _, resid = resid_of(sig, U, V)
    eta = torch.full((K,), 1e-2, dtype=torch.float32, device=V0.device)
    for _ in range(steps):
        Av = smv(V)
        sig_new = _dot(U, Av).real
        r1, r2, rn = resid_of(sig_new, U, V, Av=Av)
        rhs = -(sig_new[:, None] * r2 + smva(r1))
        dv = gram_solve(rhs.to(cdtype), sig_new, V.to(cdtype), eta).to(C128)
        sig_safe = torch.where(small, torch.ones_like(sig_new), sig_new)[:, None]
        du = (smv(dv) + r1) / sig_safe
        V_new = _unit_rows(V + dv)
        U_new = _unit_rows(U + du)
        Av2 = smv(V_new)
        sig2 = _dot(U_new, Av2).real
        _, _, rn2 = resid_of(sig2, U_new, V_new, Av=Av2)
        better = (rn2 < rn) & ~small
        U = torch.where(better[:, None], U_new, U)
        V = torch.where(better[:, None], V_new, V)
        sig = torch.where(better, sig2, torch.where(small, sig, sig_new))
        step_resid = torch.where(better, rn2, rn)
        resid = torch.where(small, resid, step_resid)
        # Eisenstat–Walker choice 2 for the next step's inner tolerance
        ratio = (step_resid / torch.clamp_min(rn, 1e-30)).to(torch.float32)
        eta_raw = 0.9 * ratio * ratio
        guard = 0.9 * eta * eta
        eta = torch.clamp(torch.where(guard > 0.1, torch.maximum(eta_raw, guard),
                                      eta_raw), 1e-4, 0.5)
    return sig, U, V, resid
