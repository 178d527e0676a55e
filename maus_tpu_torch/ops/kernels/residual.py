"""Kernel K1: the true-FP64 residual ``r = b − A·x``.

Replaces ``maus_tpu/ops/pallas/slice_residual.py::sliced_residual_fused``. The
CUDA source is ``maus_tpu_torch/csrc/true_residual.cu`` (design and bound in
its header). :func:`true_residual` launches it for CUDA tensors and takes the
plain version :func:`true_residual_plain` only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises, and never falls back.

``LAUNCHES`` counts kernel launches (the plain version does not count), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

LAUNCHES = 0


def true_residual_plain(A: torch.Tensor, x: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """``b − A.to(complex128) @ x``: the kernel's plain PyTorch version."""
    return b - A.to(torch.complex128) @ x


def _check(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> None:
    if A.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"A must be complex64 or complex128, got {A.dtype}")
    if x.dtype != torch.complex128 or b.dtype != torch.complex128:
        raise TypeError(f"x and b must be complex128, got {x.dtype}, {b.dtype}")
    if A.ndim != 2 or x.ndim != 1 or b.ndim != 1:
        raise ValueError(f"expected A (M, N), x (N,), b (M,); got "
                         f"{tuple(A.shape)}, {tuple(x.shape)}, {tuple(b.shape)}")
    m, n = A.shape
    if x.shape[0] != n or b.shape[0] != m:
        raise ValueError(f"shape mismatch: A {tuple(A.shape)}, x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    if m == 0 or n == 0:
        raise ValueError(f"empty operand {tuple(A.shape)}")
    if not (A.is_contiguous() and x.is_contiguous() and b.is_contiguous()):
        raise ValueError("A, x and b must be contiguous")
    if not (A.device == x.device == b.device):
        raise ValueError(f"A, x and b must share a device: {A.device}, "
                         f"{x.device}, {b.device}")


def true_residual(A: torch.Tensor, x: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """r = b − A·x with A widened exactly to FP64 and FP64 accumulation.

    A: (M, N) complex64 or complex128, contiguous; x: (N,) and b: (M,)
    complex128. Returns r: (M,) complex128.
    """
    global LAUNCHES
    _check(A, x, b)
    if A.device.type == "cpu":
        return true_residual_plain(A, x, b)
    if A.device.type != "cuda":
        raise ValueError(f"no true_residual for device {A.device}")
    import ctypes

    from .build import library

    if A.data_ptr() % (8 if A.dtype == torch.complex64 else 16) or \
            x.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("misaligned operand storage")
    m, n = A.shape
    if max(m, n) >= 2 ** 31:
        raise ValueError(f"operand {tuple(A.shape)} exceeds the kernel's int range")
    lib = library()
    with torch.cuda.device(A.device):
        r = torch.empty_like(b)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.maus_true_residual(
            ctypes.c_void_p(A.data_ptr()), int(A.dtype == torch.complex128),
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(r.data_ptr()), m, n, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"true_residual kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return r
