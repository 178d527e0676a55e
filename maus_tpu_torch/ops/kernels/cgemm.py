"""Kernel K3: the complex GEMM, C = β·C + α·A·B, batched.

Replaces ``maus_tpu/ops/pallas/cgemm.py::cgemm``. complex64 runs on the
tensor cores with split-TF32 products (``maus_tpu_torch/csrc/cgemm_tc.cu``:
design, bound and error argument in its header); complex128 runs PR 3's
CUDA-core body (``csrc/cgemm.cu``). Both go through the C entry
``maus_cgemm``, which the blocked LU (``ops/kernels/lu.py``) calls from C
for its trailing updates. :func:`cgemm` and :func:`cgemm_update` launch the
kernel for CUDA tensors and take the plain versions only for tensors on the
CPU; on a CUDA tensor they launch the kernel or raise, and never fall back.

PR 3's CUDA-core body for complex64 stays as the A/B yardstick
(:func:`cgemm_simt`, :func:`cgemm_update_simt`), on no solver path.

``LAUNCHES`` counts K3's launches (the LU's included, counted by
``lu._count_factor``), ``LAUNCHES_SIMT`` the yardstick's; the plain versions
do not count.
"""
from __future__ import annotations

import torch

LAUNCHES = 0
LAUNCHES_SIMT = 0

def tf32_split(x: torch.Tensor):
    """(big, small) of a float32 tensor, bit for bit as
    ``cvt.rna.tf32.f32`` rounds (and as the kernel's integer rounding does
    for every non-NaN x): big = x rounded to the nearest tf32 value, ties
    away from zero, its low 13 bits zero; small the same rounding of
    x − big (exact in float32). NaN stays NaN; ±inf and ±0 keep their sign
    (an infinite x has a NaN small half); subnormals round like normals.
    Magnitudes within half a tf32 ulp of the float32 maximum round to inf."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {x.dtype}")
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    sign = bits & -2 ** 31
    mag = bits & 0x7FFFFFFF
    rounded = (mag + 0x1000) & -0x2000
    out = (sign | rounded).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def cgemm_tf32x3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (M, K) and (K, N) complex64 operands, by the kernel's
    split-TF32 scheme in float32: Re = [Ar | Ai]·[Br ; −Bi] and Im =
    [Ar | Ai]·[Bi ; Br], each as small·big + big·small + big·big with the
    operands split by :func:`tf32_split`, summed over all of K in float32
    (the kernel sums each 16-deep k-slice apart, then adds it). For tests
    of the scheme's accuracy; the plain versions below stay the
    reference."""
    _check_pair(a, b)
    if a.dtype != torch.complex64:
        raise TypeError(f"cgemm_tf32x3_plain takes complex64, got {a.dtype}")
    ap = torch.cat([a.real, a.imag], dim=-1)
    a_big, a_small = tf32_split(ap)

    def product(bp):
        b_big, b_small = tf32_split(bp)
        acc = a_small @ b_big
        acc = acc + a_big @ b_small
        return acc + a_big @ b_big

    re = product(torch.cat([b.real, -b.imag], dim=0))
    im = product(torch.cat([b.imag, b.real], dim=0))
    return torch.complex(re, im)


def _planes_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b from four real matrix products on the split planes (the CUDA-core
    body's 4-FMA scheme): Re = ArBr − AiBi, Im = ArBi + AiBr."""
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


def _launch(C, A, B, alpha, beta, simt: bool) -> bool:
    """Launch K3 (complex64 on the tensor cores, complex128 on the CUDA-core
    body) or, with ``simt``, the CUDA-core body for either type, on CUDA
    tensors; run the plain version on CPU tensors. Returns whether a kernel
    was launched."""
    _check_update(C, A, B)
    if C.device.type == "cpu":
        cgemm_update_plain(C, A, B, alpha, beta)
        return False
    if C.device.type != "cuda":
        raise ValueError(f"no cgemm for device {C.device}")
    c, a, b = _rows(C), _rows(A), _rows(B)
    batch, M, N = c.shape
    K = a.shape[2]
    if c.numel() == 0:
        return False
    if max(batch, M, N, K) >= 2 ** 31 or batch > 65535:
        raise ValueError(f"shape {tuple(c.shape)} x {K} exceeds the kernel's int "
                         f"range or its grid (batch <= 65535)")
    import ctypes

    from .build import library

    lib = library()
    alpha, beta = complex(alpha), complex(beta)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (a, b, c)]
    dims = (batch, M, N, K, a.stride(1), b.stride(1), c.stride(1), a.stride(0),
            b.stride(0), c.stride(0), alpha.real, alpha.imag, beta.real, beta.imag)
    with torch.cuda.device(C.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(C.device).cuda_stream)
        is_c128 = int(C.dtype == torch.complex128)
        if (simt or is_c128) and M > 65535 * 64:
            raise ValueError(f"M = {M} exceeds the CUDA-core body's grid "
                             f"(M <= 65535·64)")
        entry = lib.maus_cgemm_simt if simt else lib.maus_cgemm
        err = entry(*ptrs, is_c128, *dims, stream)
    if err != 0:
        raise RuntimeError(f"cgemm kernel launch failed: CUDA error {err}")
    return True


def cgemm_update(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 alpha=1.0, beta=0.0) -> torch.Tensor:
    """C[b] ← β·C[b] + α·A[b]·B[b] in place, for (batch, M, K) A, (batch, K, N)
    B and (batch, M, N) C (or the same without the batch dim), one dtype,
    complex64 or complex128. Rows need unit column stride; row and batch
    strides are free, so C, A and B may be views into one buffer as long as
    C does not overlap A or B. β = 0 never reads C. Returns C."""
    global LAUNCHES
    if _launch(C, A, B, alpha, beta, False):
        LAUNCHES += 1
    return C


def cgemm_update_simt(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      alpha=1.0, beta=0.0) -> torch.Tensor:
    """:func:`cgemm_update` on PR 3's CUDA-core body for either type (the
    A/B yardstick of the tensor-core kernel; on no solver path)."""
    global LAUNCHES_SIMT
    if _launch(C, A, B, alpha, beta, True):
        LAUNCHES_SIMT += 1
    return C


def _product(a, b, update):
    _check_pair(a, b)
    if a.device.type == "cpu":
        return cgemm_plain(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return update(out, a.contiguous(), b.contiguous())


def cgemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for an (M, K) and a (K, N) complex64 or complex128 operand:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return _product(a, b, cgemm_update)


def cgemm_simt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`cgemm` on PR 3's CUDA-core body (the A/B yardstick)."""
    return _product(a, b, cgemm_update_simt)
