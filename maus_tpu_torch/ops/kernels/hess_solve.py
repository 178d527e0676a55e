"""Kernel K2, the batched shifted upper-Hessenberg solve, and its two
variants P1 and P2.

K2 replaces ``maus_tpu/ops/pallas/hess_solve.py::hess_solve_batched_pallas``
(CUDA source ``maus_tpu_torch/csrc/hess_solve.cu``); it carries every shifted
solve of the eig path. P1 and P2 compute the same function with a blocked
back substitution: P1 replaces ``benchmarks/hess_v2_probe.py::hess_solve_v2``
(``csrc/hess_solve_v2.cu``), P2 ``benchmarks/hess_v3_probe.py::hess_solve_v3``
(``csrc/hess_solve_v3.cu``, with a divide-free rotation, R in column tiles
and reciprocal diagonals). Like their TPU counterparts, which only the JAX
package's A/B probes call, P1 and P2 are on no solver path; designs and
bounds are in the sources' headers.

:func:`hess_solve`, :func:`hess_solve_v2` and :func:`hess_solve_v3` launch
their kernel for CUDA tensors and take their plain version only for tensors
on the CPU; on a CUDA tensor they launch the kernel or raise, and never fall
back. ``LAUNCHES``, ``LAUNCHES_V2`` and ``LAUNCHES_V3`` count kernel launches
(the plain versions do not count), so a run can show which kernel it went
through.
"""
from __future__ import annotations

import torch

LAUNCHES = 0
LAUNCHES_V2 = 0
LAUNCHES_V3 = 0

# Past this many bytes per row the carried row leaves shared memory for a
# global scratch row (K2's shared-memory budget, well under the 227 KB a
# block may use). P1 and P2 also stage a BLOCK × (BLOCK + 1) tile, so their
# budget for the row is smaller.
_SHARED_ROW_BYTES = 160 * 1024
_SHARED_ROW_BYTES_BLOCKED = 128 * 1024

# The back-substitution block width of P1 and P2 (kBS in
# csrc/hess_blocked.cuh; the kernels refuse any other).
BLOCK = 64

# P2's floor on |a|² and |a|² + |b|² (tiny<R>() in csrc/hess_blocked.cuh)
_TINY = {torch.complex64: 1e-37, torch.complex128: 1e-300}


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


def _givens_rsqrt(a: torch.Tensor, b: torch.Tensor):
    """P2's divide-free form of the same rotation: with
    u = rsqrt(|a|²)·rsqrt(|a|² + |b|²), c = |a|²·u and s = a·conj(b)·u;
    s = conj(b)/r where |a|² ≤ tiny; identity where b = 0."""
    tiny = _TINY[a.dtype]
    a2 = a.real * a.real + a.imag * a.imag
    b2 = b.real * b.real + b.imag * b.imag
    inv_r = torch.rsqrt(torch.clamp_min(a2 + b2, tiny))
    u = torch.rsqrt(torch.clamp_min(a2, tiny)) * inv_r
    nontrivial = b2 > 0
    c = torch.where(nontrivial, a2 * u, torch.ones_like(a2))
    s = torch.where(a2 <= tiny, b.conj() * inv_r.to(a.dtype),
                    a * b.conj() * u.to(a.dtype))
    s = torch.where(nontrivial, s, torch.zeros_like(a))
    return c.to(a.dtype), s


def _sweep(H, shifts, B, rotation):
    """The forward Givens sweep of every kernel here, on a (K, N, N) working
    copy of H + s_k I updated in place: the counterpart of
    ``maus_tpu/ops/hessenberg.py::_hess_solve_scan``'s first half. Returns
    (R, y): the triangular factors (upper parts; below them, rotated
    leftovers that no back substitution reads) and the rotated rhs."""
    K, N = B.shape
    Rw = H.expand(K, N, N).clone()
    Rw.diagonal(dim1=-2, dim2=-1).add_(shifts[:, None])
    y = B.clone()
    for j in range(N - 1):
        r0, r1 = Rw[:, j].clone(), Rw[:, j + 1].clone()
        c, s = rotation(r0[:, j], r1[:, j])
        c, s = c[:, None], s[:, None]
        Rw[:, j] = c * r0 + s * r1
        Rw[:, j + 1] = -s.conj() * r0 + c * r1
        y0, y1 = y[:, j].clone(), y[:, j + 1].clone()
        y[:, j] = c[:, 0] * y0 + s[:, 0] * y1
        y[:, j + 1] = -s[:, 0].conj() * y0 + c[:, 0] * y1
    return Rw, y


def _inf_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full(t.shape, complex(float("inf"), 0.0), dtype=t.dtype,
                      device=t.device)


def hess_solve_plain(H: torch.Tensor, shifts: torch.Tensor,
                     B: torch.Tensor) -> torch.Tensor:
    """(H + s_k I) w_k = b_k by the same rotations as K2: the counterpart of
    ``_hess_solve_scan``, a column-by-column back substitution."""
    Rw, y = _sweep(H, shifts, B, _givens)
    K, N = B.shape
    x = torch.zeros_like(B)
    inf = _inf_like(B[:, 0])
    for j in range(N - 1, -1, -1):
        rjj = Rw[:, j, j]
        dot = (Rw[:, j, j + 1:] * x[:, j + 1:]).sum(-1)
        safe = rjj.abs() > 0
        x[:, j] = torch.where(safe, (y[:, j] - dot) /
                              torch.where(safe, rjj, torch.ones_like(rjj)), inf)
    return x


def _back_blocked(Rw: torch.Tensor, y: torch.Tensor,
                  reciprocal: bool) -> torch.Tensor:
    """The blocked back substitution of P1 (``reciprocal=False``) and P2, in
    the kernels' order: blocks of BLOCK columns from the last; per block the
    dot of the rows with the solved columns to its right (phase A), then the
    block's column-oriented recurrence (phase B): x_jj, then
    rhs_t −= R[t, jj]·x_jj. P1 divides and updates only the rows above jj;
    P2 multiplies by the diagonals' reciprocals, taken once per block, and
    updates every row of the block (the rows at and below jj are solved)."""
    K, N = y.shape
    x = torch.zeros_like(y)
    for c0 in range(((N - 1) // BLOCK) * BLOCK, -1, -BLOCK):
        c1 = min(N, c0 + BLOCK)
        rhs = y[:, c0:c1] - (Rw[:, c0:c1, c1:] @ x[:, c1:, None])[..., 0]
        T = Rw[:, c0:c1, c0:c1]
        d = T.diagonal(dim1=-2, dim2=-1)
        if reciprocal:
            den = d.real * d.real + d.imag * d.imag
            good = den > 0
            inv = torch.where(good, 1.0 / torch.where(good, den, torch.ones_like(den)),
                              torch.zeros_like(den))
            rc = torch.complex(d.real * inv, -d.imag * inv)
            bad = torch.where(good, torch.zeros_like(den),
                              torch.full_like(den, float("inf")))
            bad = torch.complex(bad, bad)
        for jj in range(c1 - c0 - 1, -1, -1):
            if reciprocal:
                xj = rhs[:, jj] * rc[:, jj] + bad[:, jj]
                rhs = rhs - T[:, :, jj] * xj[:, None]
            else:
                dj = d[:, jj]
                safe = dj != 0
                xj = torch.where(safe, rhs[:, jj] / torch.where(
                    safe, dj, torch.ones_like(dj)), _inf_like(dj))
                rhs[:, :jj] -= T[:, :jj, jj] * xj[:, None]
            x[:, c0 + jj] = xj
    return x


def hess_solve_v2_plain(H: torch.Tensor, shifts: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """P1's function in its order of operations: K2's sweep, then the
    blocked back substitution with divides."""
    Rw, y = _sweep(H, shifts, B, _givens)
    return _back_blocked(Rw, y, reciprocal=False)


def hess_solve_v3_plain(H: torch.Tensor, shifts: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """P2's function in its order of operations: the divide-free rsqrt
    sweep, then the blocked back substitution with reciprocal diagonals."""
    Rw, y = _sweep(H, shifts, B, _givens_rsqrt)
    return _back_blocked(Rw, y, reciprocal=True)


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


def _launch(name: str, H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor,
            r_elems: int, row_budget: int, *extra) -> torch.Tensor:
    """Launch kernel ``name`` of the library with a scratch of ``r_elems``
    elements per candidate for R, and a global carried row when a row of B
    exceeds ``row_budget`` bytes; ``extra`` int arguments go before the
    stream. Raises on a failed launch."""
    if B.device.type != "cuda":
        raise ValueError(f"no {name} for device {B.device}")
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
        R = torch.empty(K * r_elems, dtype=B.dtype, device=B.device)
        cur = None
        if N * B.element_size() > row_budget:
            cur = torch.empty((K, N), dtype=B.dtype, device=B.device)
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = getattr(lib, name)(
            ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(shifts.data_ptr()),
            ctypes.c_void_p(B.data_ptr()), ctypes.c_void_p(W.data_ptr()),
            ctypes.c_void_p(R.data_ptr()),
            ctypes.c_void_p(None if cur is None else cur.data_ptr()),
            int(B.dtype == torch.complex128), K, N, *extra,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return W


def hess_solve(H: torch.Tensor, shifts: torch.Tensor,
               B: torch.Tensor) -> torch.Tensor:
    """Solve (H + shifts[k]·I) w_k = B[k] for every k (kernel K2).

    H: (N, N) upper Hessenberg (entries below the subdiagonal are ignored);
    shifts: (K,), pass −λ + ψ; B: (K, N); one dtype, complex64 or
    complex128, contiguous. Returns W: (K, N); a row whose triangular factor
    has an exact-zero diagonal comes back non-finite.
    """
    global LAUNCHES
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return hess_solve_plain(H, shifts, B)
    N = B.shape[1]
    W = _launch("maus_hess_solve", H, shifts, B, N * (N + 1) // 2,
                _SHARED_ROW_BYTES)
    LAUNCHES += 1
    return W


def _tiled_elems(N: int) -> int:
    """Elements of one candidate's R in P2's column tiles."""
    nb = -(-N // BLOCK)
    return (nb - 1) * nb // 2 * BLOCK * BLOCK + N * BLOCK


def hess_solve_v2(H: torch.Tensor, shifts: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """:func:`hess_solve`'s function through P1 (blocked back substitution);
    same arguments and contract."""
    global LAUNCHES_V2
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return hess_solve_v2_plain(H, shifts, B)
    N = B.shape[1]
    W = _launch("maus_hess_solve_v2", H, shifts, B, N * (N + 1) // 2,
                _SHARED_ROW_BYTES_BLOCKED, BLOCK)
    LAUNCHES_V2 += 1
    return W


def hess_solve_v3(H: torch.Tensor, shifts: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """:func:`hess_solve`'s function through P2 (divide-free sweep, tiled R,
    blocked back substitution with reciprocal diagonals); same arguments and
    contract."""
    global LAUNCHES_V3
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return hess_solve_v3_plain(H, shifts, B)
    W = _launch("maus_hess_solve_v3", H, shifts, B, _tiled_elems(B.shape[1]),
                _SHARED_ROW_BYTES_BLOCKED, BLOCK)
    LAUNCHES_V3 += 1
    return W
