"""Kernel K3: the complex GEMM, C = β·C + α·A·B, batched.

Replaces ``maus_tpu/ops/pallas/cgemm.py::cgemm``. The CUDA source is
``maus_tpu_torch/csrc/cgemm.cu`` (design, bound and the 4-FMA choice in its
header). In the port it is the trailing update of the blocked LU
(``ops/kernels/lu.py``). :func:`cgemm` and :func:`cgemm_update` launch it for
CUDA tensors and take the plain versions only for tensors on the CPU; on a
CUDA tensor they launch the kernel or raise, and never fall back.

``LAUNCHES`` counts kernel launches (the plain versions do not count).
"""
from __future__ import annotations

import torch

LAUNCHES = 0


def _planes_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b from four real matrix products on the split planes (the kernel's
    4-FMA scheme): Re = ArBr − AiBi, Im = ArBi + AiBr."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in (torch.complex64, torch.complex128) or b.dtype != a.dtype:
        raise TypeError(f"a and b must share a complex64 or complex128 dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a and b must share a device: {a.device}, {b.device}")


def cgemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (M, K) and (K, N) complex operands, by the real planes."""
    _check_pair(a, b)
    return _planes_product(a, b)


def cgemm_update_plain(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       alpha=1.0, beta=0.0) -> torch.Tensor:
    """C ← β·C + α·A·B in place (batched over leading dims); β = 0 never
    reads C. Returns C."""
    prod = _planes_product(A, B) * alpha
    if beta == 0:
        C.copy_(prod)
    else:
        C.copy_(C * beta + prod)
    return C


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A 2-D operand as a batch of one."""
    return t.unsqueeze(0) if t.ndim == 2 else t


def _check_update(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> None:
    if not (C.ndim == A.ndim == B.ndim and C.ndim in (2, 3)):
        raise ValueError(f"expected 2-D or 3-D operands of one rank, got "
                         f"{tuple(C.shape)}, {tuple(A.shape)}, {tuple(B.shape)}")
    if C.dtype not in (torch.complex64, torch.complex128) or \
            A.dtype != C.dtype or B.dtype != C.dtype:
        raise TypeError(f"C, A and B must share a complex64 or complex128 "
                        f"dtype, got {C.dtype}, {A.dtype}, {B.dtype}")
    if not (C.device == A.device == B.device):
        raise ValueError(f"C, A and B must share a device: {C.device}, "
                         f"{A.device}, {B.device}")
    c, a, b = _rows(C), _rows(A), _rows(B)
    if not (a.shape[0] == b.shape[0] == c.shape[0] and a.shape[1] == c.shape[1]
            and b.shape[2] == c.shape[2] and a.shape[2] == b.shape[1]):
        raise ValueError(f"bad shapes C {tuple(C.shape)} = A {tuple(A.shape)} "
                         f"@ B {tuple(B.shape)}")
    for name, t in (("C", c), ("A", a), ("B", b)):
        if t.shape[2] > 1 and t.stride(2) != 1 or \
                t.shape[1] > 1 and t.stride(1) < t.shape[2]:
            raise ValueError(f"{name} must have unit column stride and "
                             f"non-overlapping rows, got strides {t.stride()}")


def cgemm_update(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 alpha=1.0, beta=0.0) -> torch.Tensor:
    """C[b] ← β·C[b] + α·A[b]·B[b] in place, for (batch, M, K) A, (batch, K, N)
    B and (batch, M, N) C (or the same without the batch dim), one dtype,
    complex64 or complex128. Rows need unit column stride; row and batch
    strides are free, so C, A and B may be views into one buffer as long as
    C does not overlap A or B. β = 0 never reads C. Returns C."""
    global LAUNCHES
    _check_update(C, A, B)
    if C.device.type == "cpu":
        return cgemm_update_plain(C, A, B, alpha, beta)
    if C.device.type != "cuda":
        raise ValueError(f"no cgemm for device {C.device}")
    c, a, b = _rows(C), _rows(A), _rows(B)
    batch, M, N = c.shape
    K = a.shape[2]
    if c.numel() == 0:
        return C
    if max(batch, M, N, K) >= 2 ** 31 or batch > 65535 or M > 65535 * 64:
        raise ValueError(f"shape {tuple(c.shape)} x {K} exceeds the kernel's "
                         f"int range or its grid (batch <= 65535, M <= "
                         f"65535·64)")
    import ctypes

    from .build import library

    lib = library()
    alpha, beta = complex(alpha), complex(beta)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = lib.maus_cgemm(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(c.data_ptr()), int(C.dtype == torch.complex128),
            batch, M, N, K, a.stride(1), b.stride(1), c.stride(1), a.stride(0),
            b.stride(0), c.stride(0), alpha.real, alpha.imag, beta.real,
            beta.imag, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cgemm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return C


def cgemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for an (M, K) and a (K, N) complex64 or complex128 operand:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check_pair(a, b)
    if a.device.type == "cpu":
        return cgemm_plain(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return cgemm_update(out, a.contiguous(), b.contiguous())
