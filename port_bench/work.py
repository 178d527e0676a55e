"""The least time the card could take for a kernel call's work.

Frozen copies, so that a change to the program cannot move the yardstick:
the peaks, ``bound_ms``, ``k1_work`` and ``k2_work`` are copied from
``maus_tpu_torch/benchmarks/common.py``; ``p4_work`` writes down the count
that ``PERF.md``'s kernel table gives for P4 (8/3·K·N³ real operations,
each a split-TF32 product of three tensor-core passes). A bound is the
larger of the work's bytes (each input read once, each output written once)
over the HBM rate and its operations over the peak of the unit that does
them.
"""
from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# split-TF32 products (K3, and P4 through it) take three tensor-core passes
# for each product they deliver
TF32X3_FLOPS = TF32_FLOPS / 3


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bound_ms(nbytes, flops, peak_flops):
    """The larger of the work's bytes over the HBM rate and its operations
    over ``peak_flops``, in ms; and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(m: int, n: int, a_dtype: torch.dtype):
    """K1, r = b − A·x in FP64 (A in its own dtype, x and b complex128):
    A read once, x and b read once, r written once; 8 operations a complex
    multiply-add of A's entries."""
    return m * n * itemsize(a_dtype) + (n + 2 * m) * 16, 8 * m * n


def k2_work(K: int, N: int):
    """K2, (H + s_k I) w_k = b_k for K shifts of one upper-Hessenberg N×N H
    (complex64): H's upper Hessenberg part, the shifts and B read once, W
    written once; ~14·N² operations a candidate (10·N² in the sweep, 4·N² in
    the back substitution)."""
    return (N * (N + 1) // 2 + N - 1 + K + 2 * K * N) * 8, 14 * K * N ** 2


def p4_work(K: int, N: int, dtype: torch.dtype):
    """P4, the blocked LU with partial pivoting of K complex N×N matrices:
    the matrices read once, the packed factors and the int32 pivots written
    once; 8/3·N³ real operations a matrix (N³/3 complex multiply-adds)."""
    return 2 * K * N * N * itemsize(dtype) + 4 * K * N, 8 * K * N ** 3 / 3


def p4_peak(dtype: torch.dtype) -> float:
    """The unit of P4's trailing updates: split-TF32 tensor-core products for
    complex64, FP64 CUDA cores for complex128."""
    return TF32X3_FLOPS if dtype == torch.complex64 else FP64_FLOPS
