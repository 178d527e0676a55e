"""Distributed SVD of a column-sharded operand: block subspace iteration.

Counterpart of ``maus_tpu/parallel/dist_svd.py``. The round of
``candidate.step_svd``'s block mode, with A (M, N) column-sharded:

* Y = A Vᵀ — local partial products, one all_reduce of (M, k);
* thin QR of Y on every rank (k ≪ N);
* Z = Quᴴ A — column-local;
* thin QR of the tall sharded Zᴴ (N, k) by CholeskyQR2: two (k, k) Gram
  all_reduces and local triangular solves;
* the k×k Ritz SVD on every rank.

The two-sided residual ‖Av − σu‖ + ‖Aᴴu − σv‖ takes one (k, M) and one
(k,) all_reduce; the stop floor one max and one sum over the ranks.
:func:`svd_distributed` is the bare loop, kept for testing the round in
isolation; the production mesh SVD is ``maus_tpu_torch.svd(A, mesh=...)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import comm
from .dist_hessenberg import _cnormal
from .dist_qr import stage_columns
from .mesh import MODEL_AXIS, Mesh, column_range


def _svd_iterate(mesh: Mesh, A_loc: torch.Tensor, seed: int, k: int,
                 iterations: int):
    """Block subspace iteration on the column-sharded A (``A_loc`` (M,
    N/m)); returns ``(sigma (k,), U (M, k), V (k, N), resid (k,))`` on every
    rank, Ritz triplets in descending σ. ``iterations`` is a bound: the loop
    stops at the dtype floor or after six rounds without a 3% gain."""
    mrows, c = A_loc.shape
    n = c * mesh.size(MODEL_AXIS)
    lo, hi = column_range(n, mesh)
    dtype, dev = A_loc.dtype, A_loc.device
    rdt = A_loc.real.dtype
    gen = torch.Generator().manual_seed(seed)
    V0 = _cnormal(gen, (k, n), dtype, dev)
    V0 = V0 / torch.linalg.vector_norm(V0, dim=-1, keepdim=True)

    def chol_qr(t_loc, jitter):
        """One CholeskyQR pass on the tall sharded T (N, k), local (C, k):
        (Q_loc, R upper (k, k))."""
        G = comm.all_reduce(t_loc.mH @ t_loc, mesh)
        tr = float(torch.diagonal(G).real.sum())
        G = G + (jitter * max(tr, 1.0) / k) * torch.eye(k, dtype=dtype, device=dev)
        L = torch.linalg.cholesky(G)
        q_loc = torch.linalg.solve_triangular(L, t_loc.mH, upper=False)  # (k, C)
        return q_loc.mH, L.mH

    def two_sided_resid(v_loc, U, sigma):
        Av = comm.all_reduce((A_loc @ v_loc.T).T, mesh)           # (k, M)
        r1 = torch.linalg.vector_norm(Av - sigma[:, None] * U.T, dim=-1)
        Ahu_loc = (A_loc.mH @ U).T                                 # (k, C)
        r2sq = comm.all_reduce(torch.sum(
            (Ahu_loc - sigma[:, None] * v_loc).abs() ** 2, dim=-1), mesh)
        return r1 + torch.sqrt(r2sq)

    def round_once(v_loc):
        Y = comm.all_reduce(A_loc @ v_loc.T, mesh)                 # (M, k)
        Qu, _ = torch.linalg.qr(Y)
        z_loc = Qu.mH @ A_loc                                      # (k, C)
        eps2 = torch.finfo(rdt).eps ** 2
        q1, r1 = chol_qr(z_loc.mH, eps2 * 100.0)
        q2, r2 = chol_qr(q1, 0.0)
        Us, S, Vsh = torch.linalg.svd((r2 @ r1).mH)
        return (q2 @ Vsh.mH).T, Qu @ Us, S.to(rdt)

    # the floor from a scaled Frobenius norm (the plain sum of squares
    # overflows the float32 range for entries ~1e19)
    sc = max(float(comm.all_reduce(A_loc.abs().max().to(rdt).reshape(1), mesh,
                                   op="max")[0]), 1e-30)
    fro2s = float(comm.all_reduce(((A_loc.abs() / sc) ** 2).sum().reshape(1),
                                  mesh)[0])
    eps = torch.finfo(rdt).eps
    floor = 5.0 * eps * math.sqrt(max(mrows, n)) * \
        max(sc * math.sqrt(fro2s / min(mrows, n)), 1e-30)
    v_loc = V0[:, lo:hi]
    U = torch.zeros((mrows, k), dtype=dtype, device=dev)
    sigma = torch.zeros((k,), dtype=rdt, device=dev)
    resid = torch.full((k,), math.inf, dtype=rdt, device=dev)
    it, best_max, stall = 0, math.inf, 0
    while it < iterations and float(resid.max()) > floor and stall < 6:
        v_loc, U, sigma = round_once(v_loc)
        resid = two_sided_resid(v_loc, U, sigma)
        mx = float(resid.max())
        stall = 0 if mx < 0.97 * best_max else stall + 1
        best_max = min(mx, best_max)
        it += 1
    return sigma, U, comm.gather(v_loc, lo, n, mesh), resid


def svd_distributed(mesh: Mesh, A, num_candidates: int = 8,
                    iterations: int = 30, seed: int = 0):
    """The bare block subspace iteration over the column-sharded A
    (no population engine, no finisher). Returns numpy ``(sigma, U, V,
    resids)``: k Ritz values (descending), left vectors (M, k), right
    vectors (k, N) and two-sided residuals."""
    mrows, n = A.shape[-2], A.shape[-1]
    A_loc, _ = stage_columns(mesh, A)
    k = min(num_candidates, mrows, n)
    sigma, U, V, resid = _svd_iterate(mesh, A_loc, seed, k, iterations)
    return (sigma.cpu().numpy().astype(np.float64),
            U.cpu().numpy().astype(np.complex128),
            V.cpu().numpy().astype(np.complex128),
            resid.cpu().numpy().astype(np.float64))
