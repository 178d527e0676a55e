"""Kernel K2: the batched shifted upper-Hessenberg solve.

Replaces ``maus_tpu/ops/pallas/hess_solve.py::hess_solve_batched_pallas``. The
CUDA source is ``maus_tpu_torch/csrc/hess_solve.cu`` (design and bound in its
header). :func:`hess_solve` launches it for CUDA tensors and takes the plain
version :func:`hess_solve_plain` only for tensors on the CPU; on a CUDA tensor
it launches the kernel or raises, and never falls back.

``LAUNCHES`` counts kernel launches (the plain version does not count), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

LAUNCHES = 0

# Past this many bytes per row the carried row leaves shared memory for a
# global scratch row (the kernel's shared-memory budget, well under the 227 KB
# a block may use).
_SHARED_ROW_BYTES = 160 * 1024


def _givens(a: torch.Tensor, b: torch.Tensor):
    """(c, s) of the complex Givens rotation zeroing ``b`` under ``a``:
    c = |a|/r, s = sign(a)·conj(b)/r, identity where b = 0."""
    absa, absb = a.abs(), b.abs()
    r = torch.sqrt(torch.clamp_min(absa ** 2 + absb ** 2, 1e-30))
    signa = torch.where(absa > 0, a / torch.clamp_min(absa, 1e-30),
                        torch.ones_like(a))
    nontrivial = absb > 0
    c = torch.where(nontrivial, absa / r, torch.ones_like(absa))
    s = torch.where(nontrivial, signa * b.conj() / r.to(a.dtype),
                    torch.zeros_like(a))
    return c.to(a.dtype), s


def hess_solve_plain(H: torch.Tensor, shifts: torch.Tensor,
                     B: torch.Tensor) -> torch.Tensor:
    """(H + s_k I) w_k = b_k by the same rotations as the kernel: the
    counterpart of ``maus_tpu/ops/hessenberg.py::_hess_solve_scan``, a Python
    loop over the rows of a (K, N, N) working copy updated in place."""
    K, N = B.shape
    Rw = H.expand(K, N, N).clone()
    Rw.diagonal(dim1=-2, dim2=-1).add_(shifts[:, None])
    y = B.clone()
    for j in range(N - 1):
        r0, r1 = Rw[:, j].clone(), Rw[:, j + 1].clone()
        c, s = _givens(r0[:, j], r1[:, j])
        c, s = c[:, None], s[:, None]
        Rw[:, j] = c * r0 + s * r1
        Rw[:, j + 1] = -s.conj() * r0 + c * r1
        y0, y1 = y[:, j].clone(), y[:, j + 1].clone()
        y[:, j] = c[:, 0] * y0 + s[:, 0] * y1
        y[:, j + 1] = -s[:, 0].conj() * y0 + c[:, 0] * y1
    x = torch.zeros_like(B)
    inf = torch.full((K,), complex(float("inf"), 0.0), dtype=B.dtype,
                     device=B.device)
    for j in range(N - 1, -1, -1):
        rjj = Rw[:, j, j]
        dot = (Rw[:, j, j + 1:] * x[:, j + 1:]).sum(-1)
        safe = rjj.abs() > 0
        x[:, j] = torch.where(safe, (y[:, j] - dot) /
                              torch.where(safe, rjj, torch.ones_like(rjj)), inf)
    return x


def _check(H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor) -> None:
    if B.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"B must be complex64 or complex128, got {B.dtype}")
    if H.dtype != B.dtype or shifts.dtype != B.dtype:
        raise TypeError(f"H, shifts and B must share a dtype: {H.dtype}, "
                        f"{shifts.dtype}, {B.dtype}")
    if B.ndim != 2 or H.ndim != 2 or shifts.ndim != 1:
        raise ValueError(f"expected H (N, N), shifts (K,), B (K, N); got "
                         f"{tuple(H.shape)}, {tuple(shifts.shape)}, "
                         f"{tuple(B.shape)}")
    K, N = B.shape
    if tuple(H.shape) != (N, N) or shifts.shape[0] != K:
        raise ValueError(f"shape mismatch: H {tuple(H.shape)}, shifts "
                         f"{tuple(shifts.shape)}, B {tuple(B.shape)}")
    if K == 0 or N == 0:
        raise ValueError(f"empty batch {tuple(B.shape)}")
    if not (H.is_contiguous() and shifts.is_contiguous() and B.is_contiguous()):
        raise ValueError("H, shifts and B must be contiguous")
    if not (H.device == shifts.device == B.device):
        raise ValueError(f"H, shifts and B must share a device: {H.device}, "
                         f"{shifts.device}, {B.device}")


def hess_solve(H: torch.Tensor, shifts: torch.Tensor,
               B: torch.Tensor) -> torch.Tensor:
    """Solve (H + shifts[k]·I) w_k = B[k] for every k.

    H: (N, N) upper Hessenberg (entries below the subdiagonal are ignored);
    shifts: (K,), pass −λ + ψ; B: (K, N); one dtype, complex64 or
    complex128, contiguous. Returns W: (K, N); a row whose triangular factor
    has an exact-zero diagonal comes back non-finite.
    """
    global LAUNCHES
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return hess_solve_plain(H, shifts, B)
    if B.device.type != "cuda":
        raise ValueError(f"no hess_solve for device {B.device}")
    import ctypes

    from .build import library

    if any(t.data_ptr() % B.element_size() for t in (H, shifts, B)):
        raise ValueError("misaligned operand storage")
    K, N = B.shape
    if K >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"batch {tuple(B.shape)} exceeds the kernel's int range")
    lib = library()
    with torch.cuda.device(B.device):
        W = torch.empty_like(B)
        R = torch.empty(K * (N * (N + 1) // 2), dtype=B.dtype, device=B.device)
        cur = None
        if N * B.element_size() > _SHARED_ROW_BYTES:
            cur = torch.empty((K, N), dtype=B.dtype, device=B.device)
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.maus_hess_solve(
            ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(shifts.data_ptr()),
            ctypes.c_void_p(B.data_ptr()), ctypes.c_void_p(W.data_ptr()),
            ctypes.c_void_p(R.data_ptr()),
            ctypes.c_void_p(None if cur is None else cur.data_ptr()),
            int(B.dtype == torch.complex128), K, N, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"hess_solve kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return W
