"""Kernel LS: batched solves against the packed LU factors of :func:`lu.lu_factor`.

The CUDA source is ``maus_tpu_torch/csrc/lu_solve.cu`` (design and bounds in
its header). It replaces no TPU kernel: the JAX package solves with
``jax.scipy.linalg.lu_solve``. :func:`lu_perm` turns the 1-based sequential
interchanges ``piv`` of ``lu_factor`` into the permutation ``perm`` with
(P·B)[r] = B[perm[r]], once per factorization; :func:`lu_solve` then solves
L·U·X = P·B for K matrices and B of shape (K, N) or (K, N, 2), forward and
back substitution in one launch that streams each factor once, in the
row-major layout P4 leaves. With two columns each loaded element serves both.

The plain versions (:func:`lu_perm_plain`, :func:`lu_solve_plain`) follow the
same blocked algorithm in torch operations: row blocks of ``NB``, each less
the product of its strip with the blocks solved before it, then its diagonal
block. The wrappers take them only for CPU tensors; on a CUDA tensor they
launch or raise. ``LAUNCHES`` counts solve launches, ``PERM_LAUNCHES``
permutation launches. A zero on U's diagonal gives that matrix a non-finite
solution and leaves the others' as they are.
"""
from __future__ import annotations

import torch

from .lu import _check_batch, _ptr, _raise_on, _stream

LAUNCHES = 0
PERM_LAUNCHES = 0

# Rows of a task and columns of a strip block: the kernel's 8 warps hold 8
# rows each, its lanes two columns each.
NB = 64


def _check_factors(lu: torch.Tensor) -> None:
    _check_batch(lu)
    if lu.ndim != 3 or not lu.is_contiguous():
        raise ValueError(f"lu must be a contiguous (K, N, N) batch, got "
                         f"{tuple(lu.shape)} with strides {lu.stride()}")


def _check_index(lu: torch.Tensor, idx: torch.Tensor, name: str) -> None:
    K, N, _ = lu.shape
    if idx.dtype != torch.int32 or tuple(idx.shape) != (K, N) or \
            not idx.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 ({K}, {N}), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != lu.device:
        raise ValueError(f"lu and {name} must share a device: {lu.device}, "
                         f"{idx.device}")


def _check_rhs(lu: torch.Tensor, B: torch.Tensor) -> None:
    K, N, _ = lu.shape
    if B.dtype != lu.dtype:
        raise TypeError(f"B must be {lu.dtype} as lu is, got {B.dtype}")
    if not (tuple(B.shape) == (K, N) or (B.ndim == 3 and tuple(B.shape[:2]) == (K, N)
                                         and B.shape[2] in (1, 2))):
        raise ValueError(f"B must be ({K}, {N}) or ({K}, {N}, 1 or 2), got "
                         f"{tuple(B.shape)}")
    if B.device != lu.device:
        raise ValueError(f"lu and B must share a device: {lu.device}, {B.device}")


def lu_perm_plain(piv: torch.Tensor) -> torch.Tensor:
    """The permutation of the (K, N) 1-based sequential interchanges ``piv``:
    (K, N) int32 with (P·B)[r] = B[perm[r]]."""
    K, N = piv.shape
    perm = torch.arange(N, dtype=torch.int32, device=piv.device).repeat(K, 1)
    bidx = torch.arange(K, device=piv.device)
    p = piv.long() - 1
    for r in range(N):
        held = perm[:, r].clone()
        perm[:, r] = perm[bidx, p[:, r]]
        perm[bidx, p[:, r]] = held
    return perm


def lu_solve_plain(lu: torch.Tensor, perm: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with L·U·X = P·B, blocked as the kernel is: the forward solve by row
    blocks of ``NB`` from the top, the back substitution from the bottom, each
    block less its strip's product with the solved blocks, then its
    triangular diagonal block. B: (K, N) or (K, N, R); X has B's shape. Each
    column is solved alone, so its arithmetic does not depend on R, as in the
    kernel."""
    if B.ndim == 3:
        return torch.stack([lu_solve_plain(lu, perm, B[..., c])
                            for c in range(B.shape[2])], -1)
    K, N, _ = lu.shape
    y = torch.gather(B, 1, perm.long())[..., None]
    for s in range(0, N, NB):
        e = min(s + NB, N)
        rhs = y[:, s:e] - lu[:, s:e, :s] @ y[:, :s] if s else y[:, s:e]
        y[:, s:e] = torch.linalg.solve_triangular(lu[:, s:e, s:e], rhs, upper=False,
                                                  unitriangular=True)
    x = torch.empty_like(y)
    for s in reversed(range(0, N, NB)):
        e = min(s + NB, N)
        rhs = y[:, s:e] - lu[:, s:e, e:] @ x[:, e:] if e < N else y[:, s:e]
        x[:, s:e] = torch.linalg.solve_triangular(lu[:, s:e, s:e], rhs, upper=True)
    return x[..., 0]


def lu_perm(lu: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """The (K, N) int32 permutation of ``lu_factor``'s pivots ``piv`` for
    the (K, N, N) factors ``lu``: the kernel on a CUDA tensor,
    :func:`lu_perm_plain` on a CPU tensor."""
    global PERM_LAUNCHES
    _check_factors(lu)
    _check_index(lu, piv, "piv")
    if lu.device.type == "cpu":
        return lu_perm_plain(piv)
    if lu.device.type != "cuda":
        raise ValueError(f"no lu_perm for device {lu.device}")
    from .build import library

    K, N, _ = lu.shape
    perm = torch.empty((K, N), dtype=torch.int32, device=lu.device)
    with torch.cuda.device(lu.device):
        err = library().maus_lu_perm(_ptr(piv), _ptr(perm), K, N, _stream(lu))
    _raise_on(err, "lu_perm kernel launch")
    PERM_LAUNCHES += 1
    return perm


def lu_solve(lu: torch.Tensor, perm: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with L·U·X = P·B against the (K, N, N) factors ``lu`` and the
    permutation ``perm`` of :func:`lu_perm`, for B of shape (K, N) or
    (K, N, R), R ≤ 2, in ``lu``'s dtype and any layout; X has B's shape,
    contiguous. One launch of the kernel on a CUDA tensor,
    :func:`lu_solve_plain` on a CPU tensor. A column's solution is the same
    to the bit whether it is solved alone or beside another."""
    global LAUNCHES
    _check_factors(lu)
    _check_index(lu, perm, "perm")
    _check_rhs(lu, B)
    if lu.device.type == "cpu":
        return lu_solve_plain(lu, perm, B)
    if lu.device.type != "cuda":
        raise ValueError(f"no lu_solve for device {lu.device}")
    from .build import library

    K, N, _ = lu.shape
    R = 1 if B.ndim == 2 else B.shape[2]
    if 2 * K * -(-N // NB) >= 2 ** 31:
        raise ValueError(f"{tuple(lu.shape)} exceeds the solve kernel's grid")
    B = B.contiguous()
    X = torch.empty_like(B)
    Y = torch.empty_like(B)
    sync = torch.zeros(1 + 2 * K, dtype=torch.int32, device=lu.device)
    with torch.cuda.device(lu.device):
        err = library().maus_lu_solve(_ptr(lu), _ptr(perm), _ptr(B), _ptr(Y), _ptr(X),
                                      _ptr(sync), int(lu.dtype == torch.complex128),
                                      K, N, R, _stream(lu))
    _raise_on(err, "lu_solve kernel launch")
    LAUNCHES += 1
    return X
