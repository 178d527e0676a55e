"""Distributed QR factorization and solve of a column-sharded operand.

Counterpart of ``maus_tpu/parallel/dist_qr.py``. Every rank holds its
columns ``A[:, lo:hi]`` and the factors Q and R in (N, N/m) column shards,
and nothing larger.

* :func:`dist_qr` — panel CGS2 blocked QR: per b-wide panel the owner
  broadcasts it (N·b values), it is projected twice against every Q column
  computed so far (local GEMMs against each rank's Q shard, one all_reduce
  a round; not-yet-computed columns are zero and add nothing), the
  projection coefficients are gathered, and every rank runs the same local
  Householder QR of the deflated N×b panel. O(N²) bytes a factorization.
* :func:`dist_qr_solve` — y = Qᴴb (local products, one gather), then a
  blocked back substitution whose R panels are broadcast by their owners.
* :func:`refine_distributed` — iterative refinement of a working-dtype
  solution against the user's full-precision system, every correction
  solve through the sharded factors. The certifying residual runs kernel K1
  on each rank's (N, N/m) shard, ``r = b_part − A[:, lo:hi]·x[lo:hi]`` with
  ``b_part`` = b on the model axis's first rank and 0 elsewhere, and one
  complex128 all_reduce of the (N,) partials sums them; this replaces the
  JAX package's GSPMD split-f64 GEMVs.
* :func:`stage_A` / :func:`stage_b` / :func:`stage_operands` — put this
  rank's shard of the user's data on its device: the working-dtype copy and
  the copy refinement certifies against (the user's complex128 data, or the
  working copy itself when that is exact), so refinement certifies the
  user's system, not its complex64 rounding.

Not carried over: the column-sharded bf16 slice ladder and its dispatch
(``use_dist_sliced``, ``dist_slice_operand``/``dist_sliced_residual``) and
the ``utils/xfer`` host-crossing shims, which exist for the TPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

from ..ops.kernels.residual import true_residual
from . import comm
from .mesh import MODEL_AXIS, Mesh, column_range

C128 = torch.complex128


@dataclasses.dataclass
class DistQR:
    """This rank's column shards of Q and R, each (N, N/m)."""

    q: torch.Tensor
    r: torch.Tensor
    sharded: ClassVar[bool] = True


def _owner(j: int, block: int, c: int) -> tuple[int, int]:
    """(model index owning global panel j, its first local column)."""
    return (j * block) // c, (j * block) % c


def dist_qr(mesh: Mesh, A_loc: torch.Tensor, block: int = 128) -> DistQR:
    """Factor the column-sharded square A = Q R (``A_loc`` = this rank's
    (N, N/m) columns). Requires N/m divisible by ``block``, so panels align
    with column ownership."""
    n, c = A_loc.shape
    m = mesh.size(MODEL_AXIS)
    if n != c * m:
        raise ValueError(f"dist_qr needs a square operand, got local "
                         f"{tuple(A_loc.shape)} on a model axis of {m}")
    if c % block != 0:
        raise ValueError(f"N={n} must be divisible by model·block ({m}·{block})")
    me = mesh.index(MODEL_AXIS)
    lo, _ = column_range(n, mesh)
    q = torch.zeros_like(A_loc)
    r = torch.zeros_like(A_loc)
    for j in range(n // block):
        owner, loc = _owner(j, block, c)
        mine = me == owner
        B = comm.broadcast(A_loc[:, loc:loc + block] if mine else
                           A_loc.new_empty((n, block)), owner, mesh)
        # CGS2 against every Q column computed so far (zeros elsewhere)
        c1 = q.mH @ B                                         # (C, b)
        B = B - comm.all_reduce(q @ c1, mesh)
        c2 = q.mH @ B
        B = B - comm.all_reduce(q @ c2, mesh)
        coef = comm.gather(c1 + c2, lo, n, mesh, dim=0)       # (N, b)
        Qp, Rp = torch.linalg.qr(B)                           # (N, b), (b, b)
        if mine:
            rcol = coef.clone()
            rcol[j * block:] = 0
            rcol[j * block:(j + 1) * block] = Rp
            q[:, loc:loc + block] = Qp
            r[:, loc:loc + block] = rcol
    return DistQR(q=q, r=r)


def dist_qr_solve(mesh: Mesh, fac: DistQR, b: torch.Tensor,
                  block: int = 128) -> torch.Tensor:
    """x = R⁻¹ Qᴴ b against the column-sharded factors; b (N,) and x are
    the same on every rank."""
    n, c = fac.q.shape
    me = mesh.index(MODEL_AXIS)
    lo, _ = column_range(n, mesh)
    b = b.to(fac.q.dtype)
    y = comm.gather(fac.q.mH @ b, lo, n, mesh)                # (N,)
    x = torch.zeros_like(y)
    for j in reversed(range(n // block)):
        owner, loc = _owner(j, block, c)
        rp = comm.broadcast(fac.r[:, loc:loc + block] if me == owner else
                            fac.r.new_empty((n, block)), owner, mesh)
        s = slice(j * block, (j + 1) * block)
        xj = torch.linalg.solve_triangular(rp[s], y[s, None], upper=True)[:, 0]
        x[s] = xj
        # eliminate panel j's contribution from the rows above it
        y[:j * block] -= rp[:j * block] @ xj
    return x


def _compute_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """The working dtype: the caller's, else complex128 on the CPU and
    complex64 on the card (the port's single-device rule)."""
    if dtype is not None:
        return dtype
    return C128 if torch.device(device).type == "cpu" else torch.complex64


def _shard(A, lo: int, hi: int, device: torch.device):
    """Columns ``[lo, hi)`` of the user's operand on ``device``, and whether
    the input's dtype is exact in complex64. A host array or a tensor on
    another device is sliced before it moves, so no device receives more
    than the shard."""
    if isinstance(A, torch.Tensor):
        if A.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape {tuple(A.shape)}")
        exact = A.dtype in (torch.float32, torch.complex64)
        part = A[:, lo:hi].to(device)
        if not part.is_complex():
            part = part.to(torch.complex64 if exact else C128)
        return part.contiguous(), exact
    if hasattr(A, "toarray"):
        A = A.toarray()
    A = np.asarray(A) if not isinstance(A, np.ndarray) else A
    if A.ndim != 2:
        raise ValueError(f"expected a 2-D operand, got shape {A.shape}")
    exact = A.dtype in (np.dtype(np.float32), np.dtype(np.complex64))
    part = np.ascontiguousarray(A[:, lo:hi]).astype(
        np.complex64 if exact else np.complex128)
    return torch.from_numpy(part).to(device), exact


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all())


def stage_columns(mesh: Mesh, A, dtype=None):
    """This rank's (M, N/m) shard of a user operand on its device:
    ``(A_loc, A_true_loc)`` with ``A_loc`` in the working dtype and
    ``A_true_loc`` the copy refinement certifies against (the working copy
    itself when the input is exact in it, else the input's complex128)."""
    n = A.shape[-1]
    lo, hi = column_range(n, mesh)
    cdtype = _compute_dtype(mesh.device, dtype)
    part, exact = _shard(A, lo, hi, mesh.device)
    if not _finite(part):
        raise ValueError("matrix contains non-finite entries")
    A_loc = part.to(cdtype).contiguous()
    A_true = A_loc if (exact or cdtype == C128) else part.to(C128).contiguous()
    return A_loc, A_true


def stage_A(mesh: Mesh, A, dtype=None):
    """Stage a square linear operand: ``(A_loc, A_true_loc)``, both
    (N, N/m) on this rank's device."""
    if A.shape[0] != A.shape[-1]:
        raise ValueError(f"SOLVE_LINEAR_SYSTEM requires a square matrix, got "
                         f"{tuple(A.shape)}")
    return stage_columns(mesh, A, dtype)


def stage_b(mesh: Mesh, b, n: int, dtype=None):
    """Stage the right-hand side on every rank: ``(b_work, b_true)``, the
    working-dtype copy and the complex128 one refinement certifies
    against."""
    if isinstance(b, torch.Tensor):
        b_true = b.to(device=mesh.device, dtype=C128)
    else:
        b_true = torch.from_numpy(np.asarray(b).astype(np.complex128)).to(mesh.device)
    if tuple(b_true.shape) != (n,):
        raise ValueError(f"b_vector shape {tuple(b_true.shape)} does not match "
                         f"matrix ({n},)")
    if not _finite(b_true):
        raise ValueError("b_vector contains non-finite entries")
    return b_true.to(_compute_dtype(mesh.device, dtype)).contiguous(), \
        b_true.contiguous()


def stage_operands(mesh: Mesh, A, b, dtype=None):
    """:func:`stage_A` and :func:`stage_b`: ``(A_loc, b_work, A_true_loc,
    b_true)``."""
    A_loc, A_true = stage_A(mesh, A, dtype)
    b_work, b_true = stage_b(mesh, b, A.shape[0], dtype)
    return A_loc, b_work, A_true, b_true


def dist_residual(mesh: Mesh, A_true_loc: torch.Tensor, x: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x in FP64 on every rank: kernel K1 on this rank's shard
    against its slice of x (b counted once, on the first rank of the model
    axis), then one complex128 all_reduce of the (N,) partials."""
    lo, hi = column_range(x.shape[0], mesh)
    b_part = b if mesh.index(MODEL_AXIS) == 0 else torch.zeros_like(b)
    return comm.all_reduce(
        true_residual(A_true_loc, x[lo:hi].contiguous(), b_part), mesh)


def refine_distributed(mesh: Mesh, fac: DistQR, A_true_loc: torch.Tensor,
                       b: torch.Tensor, x0: torch.Tensor, block: int,
                       steps: int, tol: float) -> tuple[torch.Tensor, float]:
    """Iterative refinement of ``x0`` toward the user's ``A x = b`` (``b``
    complex128), every correction solve through the sharded factors. Stops
    at ``steps``, at ``tol``, or when a step gains less than 10%; keeps the
    best iterate. Returns ``(x complex128 (N,), rel)``, rel the certified
    ‖b − A x‖/‖b‖ (the same on every rank)."""
    b = b.to(C128)
    bnorm = max(float(torch.linalg.vector_norm(b)), 1e-30)
    x = x0.to(C128)
    r = dist_residual(mesh, A_true_loc, x, b)
    rel, prev, it = float(torch.linalg.vector_norm(r)) / bnorm, math.inf, 0
    while it < steps and rel > tol and rel <= 0.9 * prev:
        d = dist_qr_solve(mesh, fac, r.to(fac.q.dtype), block=block)
        x2 = x + d.to(C128)
        r2 = dist_residual(mesh, A_true_loc, x2, b)
        rel2 = float(torch.linalg.vector_norm(r2)) / bnorm
        if rel2 < rel:
            x, r = x2, r2
        prev, rel = rel, min(rel2, rel) if not math.isnan(rel2) else rel2
        it += 1
    return x, rel


def panel_block(c: int) -> int:
    """The largest panel width of 128, 64, … 1 that divides a rank's column
    count (the JAX mesh path's rule)."""
    return max(b for b in (128, 64, 32, 16, 8, 4, 2, 1) if c % b == 0)


def solve_distributed(mesh: Mesh, A, b, tol: float = 1e-8,
                      block: int = 128, refine_steps: int = 30):
    """Solve Ax = b with A column-sharded over the model axis: factor,
    solve, refine. Returns ``(x complex128 (N,), rel)``."""
    A_loc, b_work, A_true, b_true = stage_operands(mesh, A, b)
    fac = dist_qr(mesh, A_loc, block=block)
    x0 = dist_qr_solve(mesh, fac, b_work, block=block)
    return refine_distributed(mesh, fac, A_true, b_true, x0, block,
                              refine_steps, tol)
