"""Distributed Hessenberg reduction, shifted solves and a plain eig iteration
on a column-sharded operand.

Counterpart of ``maus_tpu/parallel/dist_hessenberg.py``. A, H, Q and the
per-candidate triangular factors of a solve stay in (…, N, N/m) column
shards; only vectors of length N or K cross between ranks.

* :func:`dist_hessenberg` — A = Q H Qᴴ by the single-device Householder
  chain (same reflector, same signs), one column a step: the left update
  H ← H − 2v(vᴴH) is column-local; the right update needs Hv and the
  accumulation of Q needs Qv, and one all_reduce of 3N values a step carries
  both and, from its owner, the next column to reflect (the JAX function
  spends three psums of N a step on the same bytes). Only rows and columns
  past j, where v is nonzero, are touched.
* :func:`dist_hess_solve` — (H − λ_k I + ψ_k I) w_k = b_k by the JAX
  function's Givens QR sweep over local (K, N/m) row slices, with the
  rotations sent a column block at a time (m broadcasts of 2·K·N/m values)
  rather than a column at a time, and a blocked back substitution (m
  all_reduces of K·N/m values and a local triangular solve a block). Plain
  torch ops, as the JAX function is plain XLA: kernel K2 does not apply,
  because H is column-sharded.
* :func:`dist_solve_shifted` — the same for A itself through Q.
* :func:`eig_distributed` — the JAX package's plain shifted inverse
  iteration over these pieces, kept for testing them in isolation; the
  production mesh eig is ``maus_tpu_torch.eig(A, mesh=...)``.

Both stay latency-bound: the reduction takes N − 1 collectives and N Python
steps, a solve 2m + 1 collectives and about 2N Python steps on its critical
path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import numpy as np
import torch

from . import comm
from .dist_qr import stage_columns
from .mesh import MODEL_AXIS, Mesh, column_range
from .placement import matvec_adj, matvec_rows


@dataclasses.dataclass
class DistHess:
    """This rank's column shards of H and Q (A = Q H Qᴴ), each (N, N/m)."""

    h: torch.Tensor
    q: torch.Tensor
    sharded: ClassVar[bool] = True


def _local_cols(mesh: Mesh, n: int, device) -> tuple[int, int, torch.Tensor]:
    lo, hi = column_range(n, mesh)
    return lo, hi, torch.arange(lo, hi, device=device)


def dist_hessenberg(mesh: Mesh, A_loc: torch.Tensor) -> DistHess:
    """Reduce the column-sharded square A (``A_loc`` = this rank's (N, N/m)
    columns) to upper-Hessenberg form, with exact zeros below the
    subdiagonal."""
    n, c = A_loc.shape
    m = mesh.size(MODEL_AXIS)
    if n != c * m:
        raise ValueError(f"dist_hessenberg needs a square operand, got local "
                         f"{tuple(A_loc.shape)} on a model axis of {m}")
    me = mesh.index(MODEL_AXIS)
    lo, hi, gcols = _local_cols(mesh, n, A_loc.device)
    rdt = A_loc.real.dtype
    tiny = torch.tensor(1e-30, dtype=rdt, device=A_loc.device)
    H = A_loc.clone()
    Q = torch.zeros_like(A_loc)
    Q[gcols, torch.arange(c, device=A_loc.device)] = 1
    steps = max(n - 2, 0)
    if steps:
        col = comm.broadcast(H[:, 0] if me == 0 else H.new_empty(n), 0, mesh)
    for j in range(steps):
        x = col[j + 1:]                               # the reflected tail
        normx = torch.linalg.vector_norm(x)
        pivot = x[0]
        absp = pivot.abs()
        sign = torch.where(absp > 0, pivot / torch.maximum(absp, tiny),
                           torch.ones_like(pivot))
        v = x.clone()
        v[0] = v[0] + sign * normx.to(v.dtype)        # x − β e₁, β = −sign·‖x‖
        vn = torch.linalg.vector_norm(v)
        ok = (vn > tiny) & (normx > tiny)
        v = torch.where(ok, v / torch.maximum(vn, tiny), torch.zeros_like(v))
        # left: H ← H − 2 v (vᴴ H), rows past j only (column-local)
        H[j + 1:] -= 2.0 * torch.outer(v, v.conj() @ H[j + 1:])
        # right: H ← H − 2 (H v) vᴴ and Q ← Q (I − 2 v vᴴ), columns past j.
        # One all_reduce carries H v, Q v and, from its owner, the next
        # column before this right update; every rank finishes that column
        # itself, as the owner does.
        a = min(max(j + 1 - lo, 0), c)
        vs = v[lo + a - (j + 1):hi - (j + 1)]
        nxt = j + 1 < steps
        parts = [H[:, a:] @ vs, Q[:, a:] @ vs]
        if nxt:
            parts.append(H[:, j + 1 - lo] if me == (j + 1) // c
                         else H.new_zeros(n))
        red = comm.all_reduce(torch.cat(parts), mesh)
        u, qv = red[:n], red[n:2 * n]
        H[:, a:] -= 2.0 * torch.outer(u, vs.conj())
        Q[:, a:] -= 2.0 * torch.outer(qv, vs.conj())
        if nxt:
            col = red[2 * n:] - 2.0 * (u * v[0].conj())
    rows = torch.arange(n, device=A_loc.device)
    H[rows[:, None] > gcols[None, :] + 1] = 0
    return DistHess(h=H, q=Q)


def _givens(a: torch.Tensor, bb: torch.Tensor, tiny: torch.Tensor):
    """(c, s) of the rotation that zeroes ``bb`` under the pivots ``a``
    (K,), as the JAX sweep builds it."""
    r = torch.sqrt(torch.clamp_min(a.abs() ** 2 + bb.abs() ** 2, 1e-30))
    nontriv = bb.abs() > 0
    absa = a.abs()
    signa = torch.where(absa > 0, a / torch.maximum(absa, tiny),
                        torch.ones_like(a))
    cg = torch.where(nontriv, (absa / r).to(a.dtype), torch.ones_like(a))
    sg = torch.where(nontriv, signa * bb.conj() / r.to(a.dtype),
                     torch.zeros_like(a))
    return cg, sg


def dist_hess_solve(mesh: Mesh, H_loc: torch.Tensor, lams: torch.Tensor,
                    B: torch.Tensor,
                    psi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``(H − λ_k I + ψ_k I) w_k = b_k`` with H column-sharded
    (``H_loc`` (N, N/m)); B (K, N) and the result are the same on every
    rank. The triangular factors stay sharded ((K, N, N/m) a rank).

    The sweep's rotations are the JAX function's, applied in its order; they
    travel a block at a time: the owner of a column block computes the
    rotations of its columns from its own slice (the earlier blocks'
    rotations already applied there), broadcasts them (2·K values a column),
    and the ranks to its right apply them to theirs (the ranks to its left
    hold only zeros from then on). The back substitution runs a block at a
    time too: the ranks right of a block sum their part of its right-hand
    side in one all_reduce, and the owner solves the block's triangle."""
    K, n = B.shape
    c = H_loc.shape[1]
    m = mesh.size(MODEL_AXIS)
    me = mesh.index(MODEL_AXIS)
    lo, hi, gcols = _local_cols(mesh, n, B.device)
    dtype = B.dtype
    tiny = torch.tensor(1e-30, dtype=B.real.dtype, device=B.device)
    shift = -lams.to(dtype)
    if psi is not None:
        shift = shift + psi.to(dtype)
    H_loc = H_loc.to(dtype)
    R = torch.zeros((K, n, c), dtype=dtype, device=B.device)

    def fresh(j):
        """Row j of H − λI + ψ on this rank's columns, for every candidate."""
        return H_loc[j].expand(K, c) + shift[:, None] * (gcols == j).to(dtype)

    def rotate(j, cg, sg, cur):
        """Rotation j on (working row j, row j + 1): store R's row j and
        return the new working row."""
        f = fresh(j + 1)
        R[:, j] = cg[:, None] * cur + sg[:, None] * f
        return -sg.conj()[:, None] * cur + cg.conj()[:, None] * f

    cur = fresh(0)
    ycur = B[:, 0]
    y = torch.empty_like(B)
    for r in range(m):
        j0, j1 = r * c, min((r + 1) * c, n - 1)      # rotations of block r
        if j1 <= j0:
            break
        if me == r:
            rot = B.new_empty((2, K, j1 - j0))
            for j in range(j0, j1):
                rot[0, :, j - j0], rot[1, :, j - j0] = _givens(
                    cur[:, j - lo], H_loc[j + 1, j - lo], tiny)
                cur = rotate(j, rot[0, :, j - j0], rot[1, :, j - j0], cur)
        rot = comm.broadcast(rot if me == r else B.new_empty((2, K, j1 - j0)),
                             r, mesh)
        for j in range(j0, j1):
            cg, sg = rot[0, :, j - j0], rot[1, :, j - j0]
            if me > r:
                cur = rotate(j, cg, sg, cur)
            yfresh = B[:, j + 1]
            y[:, j] = cg * ycur + sg * yfresh
            ycur = -sg.conj() * ycur + cg.conj() * yfresh
    R[:, n - 1] = cur
    y[:, n - 1] = ycur
    x = torch.zeros((K, c), dtype=dtype, device=B.device)
    for r in reversed(range(m)):
        rows = slice(r * c, (r + 1) * c)
        part = (R[:, rows] @ x[..., None])[..., 0] if me > r \
            else x.new_zeros((K, c))
        rhs = y[:, rows] - comm.all_reduce(part, mesh)
        if me == r:
            x = torch.linalg.solve_triangular(R[:, rows], rhs[..., None],
                                              upper=True)[..., 0]
    return comm.gather(x, lo, n, mesh)


def dist_solve_shifted(mesh: Mesh, hess: DistHess, lams: torch.Tensor,
                       B: torch.Tensor,
                       psi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(A − λ_k I + ψ_k I)⁻¹ b_k against the column-sharded Hessenberg form:
    rows Q·(H − λI + ψ)⁻¹·Qᴴb (the mesh counterpart of
    ``ops.hessenberg.solve_shifted_via_hessenberg``)."""
    Bh = matvec_adj(mesh, hess.q, B.to(hess.q.dtype))
    W = dist_hess_solve(mesh, hess.h, lams, Bh, psi)
    return matvec_rows(mesh, hess.q, W)


def spectrum_moments(mesh: Mesh, H_loc: torch.Tensor):
    """(λ center, λ scale, ψ₀) from the sharded H (similar to A, so tr and
    ‖·‖_F are A's): one all_reduce of the partial trace and ‖·‖²."""
    n = H_loc.shape[0]
    lo, hi = column_range(n, mesh)
    rdt = H_loc.real.dtype
    part = torch.stack([torch.diagonal(H_loc[lo:hi]).sum(),
                        (H_loc.abs() ** 2).sum().to(H_loc.dtype)])
    tr, fro2 = comm.all_reduce(part, mesh)
    fro2 = fro2.real
    lam_center = tr / n
    lam_scale = torch.sqrt(torch.clamp_min(
        fro2 / n - lam_center.abs() ** 2, 1e-12)).to(rdt)
    eps = torch.finfo(rdt).eps
    psi0 = torch.sqrt(fro2 / n).to(rdt) * eps * eps * 1e6
    return lam_center, lam_scale, psi0


def _cnormal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    rdt = dtype.to_real()
    re = torch.randn(shape, generator=gen, dtype=rdt)
    im = torch.randn(shape, generator=gen, dtype=rdt)
    return torch.complex(re, im).to(device)


def _eig_iterate(mesh: Mesh, hess: DistHess, seed: int, k: int,
                 iterations: int, lam_center, lam_scale, psi0):
    """Shifted inverse iteration with Rayleigh-quotient updates against the
    sharded H, K candidates batched; ``iterations`` is a bound: the loop
    stops once the worst residual reaches the dtype floor or stalls six
    times."""
    n = hess.h.shape[0]
    dtype, dev = hess.h.dtype, hess.h.device
    rdt = hess.h.real.dtype
    gen = torch.Generator().manual_seed(seed)
    V = _cnormal(gen, (k, n), dtype, dev)
    V = V / torch.linalg.vector_norm(V, dim=-1, keepdim=True)
    lam = (_cnormal(gen, (k,), dtype, dev) * lam_scale).to(dtype) + lam_center
    psi_v = torch.full((k,), 1.0, dtype=rdt, device=dev) * psi0
    eps = torch.finfo(rdt).eps
    scale = float((lam_center.abs() + lam_scale).real)
    floor = 5.0 * eps * math.sqrt(n) * max(scale, 1e-30)
    resid = torch.full((k,), math.inf, dtype=rdt, device=dev)
    it, best_max, stall = 0, math.inf, 0
    while it < iterations and float(resid.max()) > floor and stall < 6:
        W = dist_hess_solve(mesh, hess.h, lam, V, psi=psi_v)
        Wn = W / torch.clamp_min(torch.linalg.vector_norm(W, dim=-1, keepdim=True),
                                 torch.finfo(rdt).tiny)
        good = (torch.isfinite(Wn.real) & torch.isfinite(Wn.imag)).all(
            dim=-1, keepdim=True)
        V = torch.where(good, Wn, V)
        HV = matvec_rows(mesh, hess.h, V)
        lam = torch.sum(V.conj() * HV, dim=-1)
        resid = torch.linalg.vector_norm(HV - lam[:, None] * V, dim=-1)
        mx = float(resid.max())
        stall = 0 if mx < 0.97 * best_max else stall + 1
        best_max = min(mx, best_max)
        it += 1
    return V, lam, resid


def eig_distributed(mesh: Mesh, A, num_candidates: int = 16,
                    iterations: int = 30, seed: int = 0):
    """The plain shifted inverse iteration over the sharded pieces
    (no population engine, no finisher), for testing them in isolation.
    Returns numpy ``(lams, vecs, resids)``: eigenvalue estimates, the
    eigenvectors of A as rows, and ‖Av − λv‖ against the sharded A."""
    A_loc, _ = stage_columns(mesh, A)
    hess = dist_hessenberg(mesh, A_loc)
    lam_center, lam_scale, psi0 = spectrum_moments(mesh, hess.h)
    V, lam, _ = _eig_iterate(mesh, hess, seed, num_candidates, iterations,
                             lam_center, lam_scale, psi0)
    X = matvec_rows(mesh, hess.q, V)
    X = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    res = torch.linalg.vector_norm(matvec_rows(mesh, A_loc, X)
                                   - lam[:, None] * X, dim=-1)
    return (lam.cpu().numpy().astype(np.complex128),
            X.cpu().numpy().astype(np.complex128),
            res.cpu().numpy().astype(np.float64))
