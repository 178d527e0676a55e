"""Kernels P3 and P4: batched LU with partial pivoting, unblocked and blocked.

Replace ``benchmarks/parked/pallas_lu.py::lu_factor_batched`` (P3) and
``benchmarks/parked/pallas_lu_blocked.py::lu_factor_batched_blocked`` (P4).
The CUDA source is ``maus_tpu_torch/csrc/lu.cu`` (design and bound in its
header). :func:`lu_panel` factors the columns [s, e) of a batch in place — with
[s, e) = [0, N) it is the whole unblocked LU, P3's counterpart.
:func:`lu_factor` is the blocked right-looking LU, P4's counterpart: per
panel of ``NB`` columns (the last one ragged) the panel factorization, the
panel's row interchanges on the other columns, the unit-lower solve for U₁₂
and the trailing update A₂₂ −= L₂₁·U₁₂ by kernel K3
(:func:`~maus_tpu_torch.ops.kernels.cgemm.cgemm_update`). The result is
``(lu, piv)`` exactly as ``torch.linalg.lu_factor`` gives it (packed LU,
int32 1-based pivots), so ``torch.linalg.lu_solve`` consumes it unchanged.

The pivot of a column is the row of largest |a|² (the first on ties), as in
the JAX kernels; LAPACK, behind ``torch.linalg.lu_factor`` and
``jax.scipy.linalg.lu_factor``, ranks by |Re| + |Im| and may pick another
row. A zero pivot leaves zero multipliers and a zero on U's diagonal, so a
solve against the factors comes back non-finite.

The wrappers launch the kernels for CUDA tensors and take the plain versions
(:func:`lu_panel_plain`, :func:`lu_factor_plain`, the same algorithm in torch
operations) only for tensors on the CPU; on a CUDA tensor they launch or
raise. ``PANEL_LAUNCHES`` counts panel-kernel launches, ``LAUNCHES`` the
blocked factorizations run on the card (each launches the panel, swap and
solve kernels and K3 per panel).
"""
from __future__ import annotations

import torch

from . import cgemm as cgemm_mod

LAUNCHES = 0
PANEL_LAUNCHES = 0

# Panel width of the blocked LU: the panel's column steps are a latency-bound
# chain whatever its width, while each trailing update reads and writes the
# whole trailing matrix, so wider panels mean fewer of those passes. The
# kernel's triangular solve holds the panel's L₁₁ in shared memory, up to 64.
NB = 64


def _cdiv_real(z: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """z / den for a real den, component by component (a complex division
    would round differently from the kernels)."""
    return torch.complex(z.real / den, z.imag / den)


def lu_panel_plain(lu: torch.Tensor, piv: torch.Tensor, s: int, e: int) -> None:
    """Factor columns [s, e) of rows [s, N) of the (K, N, N) batch ``lu`` in
    place, pivots into ``piv[:, s:e]`` (1-based); row swaps touch the panel's
    columns only."""
    K, N, _ = lu.shape
    bidx = torch.arange(K, device=lu.device)
    for k in range(s, e):
        col = lu[:, k:, k]
        p = torch.argmax(col.real ** 2 + col.imag ** 2, dim=1) + k
        piv[:, k] = (p + 1).to(torch.int32)
        row_k = lu[:, k, s:e].clone()
        lu[:, k, s:e] = lu[bidx, p, s:e]
        lu[bidx, p, s:e] = row_k
        d = lu[:, k, k]
        den = d.real ** 2 + d.imag ** 2
        den = torch.where(den > 0, den, torch.ones_like(den))
        lmul = _cdiv_real(lu[:, k + 1:, k] * d.conj()[:, None], den[:, None])
        lu[:, k + 1:, k] = lmul
        if k + 1 < e:
            lu[:, k + 1:, k + 1:e] -= lmul[:, :, None] * lu[:, k, None, k + 1:e]


def _swap_outside_plain(lu: torch.Tensor, piv: torch.Tensor, s: int, e: int) -> None:
    """Apply the interchanges ``piv[:, s:e]`` to the columns outside [s, e)."""
    K, N, _ = lu.shape
    bidx = torch.arange(K, device=lu.device)
    for cols in (slice(0, s), slice(e, N)):
        if cols.start >= cols.stop:
            continue
        for k in range(s, e):
            p = piv[:, k].long() - 1
            row_k = lu[:, k, cols].clone()
            lu[:, k, cols] = lu[bidx, p, cols]
            lu[bidx, p, cols] = row_k


def lu_factor_plain(H: torch.Tensor, nb: int = NB):
    """The blocked LU of :func:`lu_factor` in torch operations, for a
    (K, N, N) or (N, N) complex tensor, with panels of ``nb`` columns
    (``nb`` ≥ N: the unblocked LU); returns ``(lu, piv)``."""
    squeeze = H.ndim == 2
    lu = (H.unsqueeze(0) if squeeze else H).clone(
        memory_format=torch.contiguous_format)
    K, N, _ = lu.shape
    piv = torch.empty((K, N), dtype=torch.int32, device=lu.device)
    for s in range(0, N, nb):
        e = min(s + nb, N)
        lu_panel_plain(lu, piv, s, e)
        _swap_outside_plain(lu, piv, s, e)
        if e < N:
            lu[:, s:e, e:] = torch.linalg.solve_triangular(
                lu[:, s:e, s:e], lu[:, s:e, e:], upper=False, unitriangular=True)
            cgemm_mod.cgemm_update_plain(lu[:, e:, e:], lu[:, e:, s:e],
                                         lu[:, s:e, e:], -1.0, 1.0)
    return (lu[0], piv[0]) if squeeze else (lu, piv)


def _check_batch(lu: torch.Tensor) -> None:
    if lu.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"expected complex64 or complex128, got {lu.dtype}")
    if lu.ndim not in (2, 3) or lu.shape[-1] != lu.shape[-2]:
        raise ValueError(f"expected (K, N, N) or (N, N), got {tuple(lu.shape)}")
    if lu.numel() == 0:
        raise ValueError(f"empty batch {tuple(lu.shape)}")
    if lu.shape[-1] >= 2 ** 31 or (lu.ndim == 3 and lu.shape[0] >= 2 ** 31):
        raise ValueError(f"{tuple(lu.shape)} exceeds the kernels' int range")


def _check_panel_args(lu: torch.Tensor, piv: torch.Tensor, s: int, e: int) -> None:
    _check_batch(lu)
    if lu.ndim != 3 or not lu.is_contiguous():
        raise ValueError(f"lu must be a contiguous (K, N, N) batch, got "
                         f"{tuple(lu.shape)} with strides {lu.stride()}")
    K, N, _ = lu.shape
    if piv.dtype != torch.int32 or tuple(piv.shape) != (K, N) or \
            not piv.is_contiguous():
        raise ValueError(f"piv must be a contiguous int32 ({K}, {N}), got "
                         f"{piv.dtype} {tuple(piv.shape)}")
    if piv.device != lu.device:
        raise ValueError(f"lu and piv must share a device: {lu.device}, "
                         f"{piv.device}")
    if not 0 <= s < e <= N:
        raise ValueError(f"bad panel [{s}, {e}) of N = {N}")


def _launch(fn, *args) -> None:
    import ctypes

    lu = args[0]
    stream = torch.cuda.current_stream(lu.device).cuda_stream
    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    with torch.cuda.device(lu.device):
        err = fn(*ptrs, int(lu.dtype == torch.complex128), lu.shape[0],
                 lu.shape[1], *ints, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")


def lu_panel(lu: torch.Tensor, piv: torch.Tensor, s: int, e: int) -> None:
    """Factor columns [s, e) of rows [s, N) of the contiguous (K, N, N)
    complex batch ``lu`` in place, with partial pivoting; the pivots go to
    ``piv[:, s:e]`` (int32, 1-based) and the row swaps touch the panel's
    columns only. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    global PANEL_LAUNCHES
    _check_panel_args(lu, piv, s, e)
    if lu.device.type == "cpu":
        return lu_panel_plain(lu, piv, s, e)
    if lu.device.type != "cuda":
        raise ValueError(f"no lu_panel for device {lu.device}")
    from .build import library

    _launch(library().maus_lu_panel, lu, piv, s, e)
    PANEL_LAUNCHES += 1
    return None


def lu_factor(H: torch.Tensor):
    """LU with partial pivoting of a (K, N, N) or (N, N) complex64 or
    complex128 tensor (any K, N ≥ 1; H is not modified). Returns
    ``(lu, piv)`` in ``torch.linalg.lu_factor``'s layout: the kernels on a
    CUDA tensor, :func:`lu_factor_plain` on a CPU tensor."""
    global LAUNCHES
    _check_batch(H)
    if H.device.type == "cpu":
        return lu_factor_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"no lu_factor for device {H.device}")
    from .build import library

    lib = library()
    squeeze = H.ndim == 2
    lu = (H.unsqueeze(0) if squeeze else H).clone(
        memory_format=torch.contiguous_format)
    K, N, _ = lu.shape
    if K > 65535:
        raise ValueError(f"batch {K} exceeds the swap and solve kernels' grid "
                         f"(K <= 65535)")
    piv = torch.empty((K, N), dtype=torch.int32, device=lu.device)
    for s in range(0, N, NB):
        e = min(s + NB, N)
        lu_panel(lu, piv, s, e)
        if e - s < N:
            _launch(lib.maus_lu_swap, lu, piv, s, e)
        if e < N:
            _launch(lib.maus_lu_trsm, lu, s, e)
            cgemm_mod.cgemm_update(lu[:, e:, e:], lu[:, e:, s:e], lu[:, s:e, e:],
                                   -1.0, 1.0)
    LAUNCHES += 1
    return (lu[0], piv[0]) if squeeze else (lu, piv)
