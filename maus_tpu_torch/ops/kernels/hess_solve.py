"""Kernel K2, the batched shifted upper-Hessenberg solve, and its variants.

K2 replaces ``maus_tpu/ops/pallas/hess_solve.py::hess_solve_batched_pallas``
and carries every shifted solve of the eig path. Its kernel is the bottom-up
RQ sweep fused with the back substitution (CUDA source
``maus_tpu_torch/csrc/hess_solve_rq.cu``): one column of the working matrix
and one column of partial sums are carried per candidate, no triangular
factor is stored, and the call's scratch is O(K·N). Its plain version is
:func:`hess_solve_rq_plain`, the same algorithm in torch.

The first CUDA form of K2, a top-down Givens QR sweep with the triangular
factor packed in an O(K·N²) scratch and a separate back substitution
(``csrc/hess_solve.cu``, the TPU kernel's own order), stays as
:func:`hess_solve_qr` with its plain version :func:`hess_solve_plain`. P1 and
P2 compute the same function as that QR form with a blocked back
substitution: P1 replaces ``benchmarks/hess_v2_probe.py::hess_solve_v2``,
P2 ``benchmarks/hess_v3_probe.py::hess_solve_v3`` (a divide-free rotation, R
in column tiles and reciprocal diagonals). Their kernels (``csrc/
hess_stream.cuh``, entries ``csrc/hess_stream_v2.cu`` and ``_v3.cu``) are a
sweep that streams R out with the carried row in registers, and a back
substitution on a thread-block cluster per candidate; the launch is planned
by :func:`blocked_plan`. The row-loop body of both (``csrc/hess_blocked.cuh``)
stays as :func:`hess_solve_v2_rowloop` and :func:`hess_solve_v3_rowloop`,
the yardstick of the redesign. :func:`blocked_sweep` and
:func:`blocked_back` run the redesign's two kernels apart, for timing. Like
their TPU counterparts, which only the JAX package's A/B probes call, the
QR form, P1 and P2 are on no solver path; designs and bounds are in the
sources' headers.

Every wrapper here launches its kernel for CUDA tensors and takes its plain
version only for tensors on the CPU; on a CUDA tensor it launches the kernel
or raises, and never falls back. ``LAUNCHES`` (K2), ``LAUNCHES_QR``,
``LAUNCHES_V2``, ``LAUNCHES_V3``, ``LAUNCHES_V2_ROWLOOP``,
``LAUNCHES_V3_ROWLOOP``, ``LAUNCHES_SWEEP`` and ``LAUNCHES_BACK`` count
kernel launches, one per wrapper call (the plain versions do not count), so
a run can show which kernel it went through.
"""
from __future__ import annotations

import functools

import torch

LAUNCHES = 0
LAUNCHES_QR = 0
LAUNCHES_V2 = 0
LAUNCHES_V3 = 0
LAUNCHES_V2_ROWLOOP = 0
LAUNCHES_V3_ROWLOOP = 0
LAUNCHES_SWEEP = 0
LAUNCHES_BACK = 0

# Past this many bytes per row the carried row of the QR form leaves shared
# memory for a global scratch row (its shared-memory budget, well under the
# 227 KB a block may use). the row-loop body of P1 and P2 also stages a
# BLOCK × (BLOCK + 1) tile, so its budget for the row is smaller.
_SHARED_ROW_BYTES = 160 * 1024
_SHARED_ROW_BYTES_BLOCKED = 128 * 1024

# The back-substitution block width of P1 and P2 (kBS in
# csrc/hess_common.cuh; the row-loop body refuses any other).
BLOCK = 64

# The launch of P1's and P2's sweep (csrc/hess_stream.cuh): column threads a
# block (beside them, one pivot warp), and columns a thread whose carried
# entries live in registers (the kernel refuses any other); columns past
# threads × cols keep theirs in shared memory when they fit, else in a
# global scratch of the call. The back
# substitution runs a cluster of 1 to BLOCKED_MAX_CLUSTER CTAs a candidate.
BLOCKED_THREADS = 480
BLOCKED_COLS = {torch.complex64: 9, torch.complex128: 5}
BLOCKED_MAX_CLUSTER = 8
# the H100's streaming multiprocessors, which the default cluster size
# shares out among the candidates
_SMS = 132

# The RQ kernel's launch shapes: threads a block, and for each its rows a
# thread in registers (the rows_per_thread template of
# csrc/hess_solve_rq.cu; the kernel refuses any other pair). Rows past
# threads × rows ("the register fit") keep their state in shared memory if
# it fits beside the block scan's 2·threads elements, else in a global
# scratch of the call.
RQ_ROWS = {(torch.complex64, 256): 16, (torch.complex64, 512): 8,
           (torch.complex64, 1024): 4, (torch.complex128, 256): 8,
           (torch.complex128, 512): 4}
RQ_THREADS = 512
# dynamic shared memory a block may use on Hopper (227 KB), less the
# kernel's static shared memory (the pivot slot and queue, < 2 KB) and the
# 1 KB the card reserves per block
_SMEM_LIMIT = 232448 - 4096

# The floor on |a|² and |a|² + |b|² of P2's rotation and of K2's pivot
# (tiny<R>() in csrc/hess_blocked.cuh and csrc/hess_solve_rq.cu)
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
    """(H + s_k I) w_k = b_k by the top-down QR sweep of
    :func:`hess_solve_qr`: the counterpart of ``_hess_solve_scan``, the
    same rotations in the same order, then a column-by-column back
    substitution."""
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


def _pivot(a: torch.Tensor, acc: torch.Tensor, h: torch.Tensor,
           b: torch.Tensor):
    """A step of the RQ sweep, divide-free as the kernel computes it: the
    rotation (c, s) zeroing h under the carried entry a (c = |a|/r,
    s = sign(a)·conj(h)/r, identity where h = 0) from ia = rsqrt(|a|²) and
    ir = rsqrt(|a|² + |h|²), and z = (b − acc)/R[k, k] =
    (b − acc)·conj(sign(a))·ir; inf where |a|² + |h|² = 0."""
    tiny = _TINY[a.dtype]
    a2 = a.real * a.real + a.imag * a.imag
    h2 = h.real * h.real + h.imag * h.imag
    r2 = a2 + h2
    ir = torch.rsqrt(torch.clamp_min(r2, tiny))
    ia = torch.rsqrt(torch.clamp_min(a2, tiny))
    sg = torch.where(a2 > tiny, a * ia, torch.ones_like(a))
    c = torch.where(h2 > 0, a2 * ia * ir, torch.ones_like(a2)).to(a.dtype)
    s = sg * h.conj() * ir
    z = torch.where(r2 > 0, (b - acc) * sg.conj() * ir, _inf_like(a))
    return c, s, z


def hess_solve_rq_plain(H: torch.Tensor, shifts: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """(H + s_k I) w_k = b_k by K2's bottom-up RQ sweep, in the kernel's
    order of operations, with O(K·N) state.

    With M = H + s_k I, column rotations G_k on columns (k−1, k) for k = N−1
    down to 1 zero M's subdiagonal from the bottom: M·G_{N−1}⋯G_1 = R. The
    carried column ``car`` starts as M's last column; at step k the
    rotation (c, s) of car[k] and M[k, k−1] makes R's column k final
    (c·car + s·fresh, fresh = M's column k−1), which solves R z = b for z_k
    at once (:func:`_pivot`) and adds R[:k, k]·z_k to the partial sums
    ``acc``; the rest of the pair becomes the next carried column. Then
    w = G_{N−1}⋯G_1 z."""
    K, N = B.shape
    Ht = H.T
    car = Ht[N - 1].expand(K, N).clone()
    car[:, N - 1] += shifts
    acc = torch.zeros_like(B)
    z = torch.empty_like(B)
    cs = torch.ones_like(B)
    ss = torch.zeros_like(B)
    for k in range(N - 1, 0, -1):
        fresh = Ht[k - 1, :k + 1].expand(K, k + 1).clone()
        fresh[:, k - 1] += shifts
        c, s, z[:, k] = _pivot(car[:, k], acc[:, k], fresh[:, k], B[:, k])
        cs[:, k], ss[:, k] = c, s
        c, s = c[:, None], s[:, None]
        o, f = car[:, :k], fresh[:, :k]
        acc[:, :k] += (c * o + s * f) * z[:, k, None]
        car[:, :k] = -s.conj() * o + c * f
    z[:, 0] = _pivot(car[:, 0], acc[:, 0], torch.zeros_like(car[:, 0]),
                     B[:, 0])[2]
    w = torch.empty_like(B)
    t = z[:, 0]
    for k in range(1, N):
        c, s, zk = cs[:, k], ss[:, k], z[:, k]
        w[:, k - 1] = c * t + s * zk
        t = -s.conj() * t + c * zk
    w[:, N - 1] = t
    return w


def rq_plan(N: int, dtype: torch.dtype, threads: int | None = None) -> dict:
    """The RQ kernel's launch for a row length N: threads a block, rows a
    thread in registers, and the home of the rows past the register fit
    ("registers" when there are none, else "shared" or "global"), with the
    dynamic shared memory that takes."""
    threads = RQ_THREADS if threads is None else threads
    if (dtype, threads) not in RQ_ROWS:
        have = sorted(t for d, t in RQ_ROWS if d == dtype)
        raise ValueError(f"no RQ kernel for {dtype} at {threads} threads "
                         f"(have {have})")
    rows = RQ_ROWS[(dtype, threads)]
    esz = 8 if dtype == torch.complex64 else 16
    spill = max(0, N - threads * rows)
    smem = 2 * threads * esz
    if spill == 0:
        home = "registers"
    elif smem + 2 * spill * esz <= _SMEM_LIMIT:
        home, smem = "shared", smem + 2 * spill * esz
    else:
        home = "global"
    return dict(threads=threads, rows=rows, home=home, spill_rows=spill,
                smem=smem)


def blocked_plan(K: int, N: int, dtype: torch.dtype, cluster: int | None = None,
                 active=None) -> dict:
    """The launch of P1's and P2's kernels for K candidates of order N: the
    sweep's threads, columns a thread in registers, and the home of the
    carried row's columns past that fit ("registers" when there are none,
    else "shared" or "global") with the dynamic shared memory it takes; and
    the back substitution's cluster size and its shared memory a CTA.

    The cluster size, unless given: at least 2 past two blocks of columns
    (CTA 0 runs the blocks' recurrences, the others the far dot products),
    at most one CTA a block and BLOCKED_MAX_CLUSTER; with ``active`` (C -> the clusters of C CTAs the
    card runs at once, :func:`back_occupancy`) the largest whose K clusters
    all run in one wave, else the one of fewest waves; without it the SMs
    shared out among the candidates. Pure: the wrappers pass the card's
    occupancy."""
    if dtype not in BLOCKED_COLS:
        raise ValueError(f"no P1/P2 kernel for {dtype}")
    if K < 1 or N < 1:
        raise ValueError(f"empty batch ({K}, {N})")
    cols = BLOCKED_COLS[dtype]
    esz = 8 if dtype == torch.complex64 else 16
    spill = max(0, N - BLOCKED_THREADS * cols)
    smem = 0
    if spill == 0:
        home = "registers"
    elif spill * esz <= _SMEM_LIMIT:
        home, smem = "shared", spill * esz
    else:
        home = "global"
    _check_cluster(cluster)
    nb = -(-N // BLOCK)
    # past two blocks a target has a far sum, which a worker CTA computes
    least = 1 if nb <= 2 else 2
    if cluster is None:
        top = max(least, min(BLOCKED_MAX_CLUSTER, nb))
        if active is None:
            cluster = max(least, min(top, _SMS // K))
        else:
            waves = {C: -(-K // max(1, active(C))) for C in range(least, top + 1)}
            cluster = min(waves, key=lambda C: (waves[C], -C))
    elif cluster < least:
        raise ValueError(f"cluster {cluster} at N = {N}: past {2 * BLOCK} columns "
                         f"the back substitution needs a worker CTA (cluster >= 2)")
    # two diagonal tiles and the tile above, padded (back_smem_bytes in
    # csrc/hess_stream.cuh), the far sums of two targets, rhs, x_b, near, y
    back_smem = (3 * BLOCK * (BLOCK + 1) + 6 * BLOCK) * esz
    return dict(threads=BLOCKED_THREADS, cols=cols, home=home,
                spill_cols=spill, smem=smem, cluster=cluster,
                back_smem=back_smem)


def r_elems(N: int, tiled: bool) -> int:
    """Elements of one candidate's R: rows packed (P1) or column tiles of
    BLOCK (P2), as ``r_elems`` in csrc/hess_common.cuh."""
    if not tiled:
        return N * (N + 1) // 2
    nb = -(-N // BLOCK)
    return (nb - 1) * nb // 2 * BLOCK * BLOCK + N * BLOCK


def _r_layout(N: int, tiled: bool, device):
    """(rows, cols, flat): the upper triangle's indices and their places in
    a candidate's R (``r_index`` in csrc/hess_common.cuh)."""
    rows, cols = torch.triu_indices(N, N, device=device)
    if tiled:
        t = cols // BLOCK
        flat = t * (t + 1) // 2 * BLOCK * BLOCK + rows * BLOCK + cols % BLOCK
    else:
        flat = rows * N - rows * (rows - 1) // 2 + cols - rows
    return rows, cols, flat


def blocked_sweep_plain(H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor,
                        tiled: bool):
    """The sweep of P1 (``tiled=False``) or P2 alone: (R, y), R flat in the
    kernel's layout (zeros where the layout has room and R has no entry)."""
    K, N = B.shape
    Rw, y = _sweep(H, shifts, B, _givens_rsqrt if tiled else _givens)
    rows, cols, flat = _r_layout(N, tiled, B.device)
    R = torch.zeros((K, r_elems(N, tiled)), dtype=B.dtype, device=B.device)
    R[:, flat] = Rw[:, rows, cols]
    return R.reshape(-1), y


def blocked_back_plain(R: torch.Tensor, Y: torch.Tensor,
                       tiled: bool) -> torch.Tensor:
    """The back substitution of P1 (``tiled=False``) or P2 alone, from R in
    the kernel's layout and the rotated right-hand sides Y."""
    K, N = Y.shape
    rows, cols, flat = _r_layout(N, tiled, Y.device)
    Rw = torch.zeros((K, N, N), dtype=Y.dtype, device=Y.device)
    Rw[:, rows, cols] = R.reshape(K, -1)[:, flat]
    return _back_blocked(Rw, Y, reciprocal=tiled)


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
    """P1's function in its order of operations: the top-down Givens sweep,
    then the blocked back substitution with divides. The kernel's phase A
    sums the dot products in another order (split over a cluster's CTAs,
    the block just solved apart): rounding-level differences."""
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


def hess_solve(H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor,
               threads: int | None = None) -> torch.Tensor:
    """Solve (H + shifts[k]·I) w_k = B[k] for every k (kernel K2, the
    bottom-up RQ sweep fused with the back substitution).

    H: (N, N) upper Hessenberg (entries below the subdiagonal are ignored);
    shifts: (K,), pass −λ + ψ; B: (K, N); one dtype, complex64 or
    complex128, contiguous. Returns W: (K, N); a row whose triangular factor
    has an exact-zero diagonal comes back non-finite. ``threads`` picks
    another block size of :data:`RQ_ROWS` (default :data:`RQ_THREADS`).
    """
    global LAUNCHES
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return hess_solve_rq_plain(H, shifts, B)
    if B.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {B.device}")
    import ctypes

    from .build import library

    if any(t.data_ptr() % B.element_size() for t in (H, shifts, B)):
        raise ValueError("misaligned operand storage")
    K, N = B.shape
    if K >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"batch {tuple(B.shape)} exceeds the kernel's int range")
    plan = rq_plan(N, B.dtype, threads)
    lib = library()
    with torch.cuda.device(B.device):
        # H's columns as rows, so that a step reads its column coalesced
        Ht = H.T.contiguous()
        W = torch.empty_like(B)
        # per candidate: the rotations' s and the solution z of R z = b,
        # and the rotations' c
        SZ = torch.empty((K, 2, N), dtype=B.dtype, device=B.device)
        C = torch.empty((K, N), dtype=B.real.dtype, device=B.device)
        spill = None
        if plan["home"] == "global":
            spill = torch.empty((K, plan["spill_rows"], 2), dtype=B.dtype,
                                device=B.device)
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.maus_hess_solve_rq(
            ctypes.c_void_p(Ht.data_ptr()), ctypes.c_void_p(shifts.data_ptr()),
            ctypes.c_void_p(B.data_ptr()), ctypes.c_void_p(W.data_ptr()),
            ctypes.c_void_p(SZ.data_ptr()), ctypes.c_void_p(C.data_ptr()),
            ctypes.c_void_p(None if spill is None else spill.data_ptr()),
            int(B.dtype == torch.complex128), K, N, plan["threads"],
            plan["rows"], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"maus_hess_solve_rq kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return W


def hess_solve_qr(H: torch.Tensor, shifts: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """:func:`hess_solve`'s function through K2's first CUDA form: the
    top-down Givens QR sweep in the TPU kernel's order, the triangular
    factor packed in an O(K·N²) scratch, then the back substitution. On no
    solver path; same arguments and contract."""
    global LAUNCHES_QR
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return hess_solve_plain(H, shifts, B)
    N = B.shape[1]
    W = _launch("maus_hess_solve", H, shifts, B, N * (N + 1) // 2,
                _SHARED_ROW_BYTES)
    LAUNCHES_QR += 1
    return W


def _check_cluster(cluster: int | None) -> None:
    if cluster is not None and not 1 <= cluster <= BLOCKED_MAX_CLUSTER:
        raise ValueError(f"cluster {cluster} outside 1..{BLOCKED_MAX_CLUSTER}")


def _blocked(tiled: bool, mode: int, H, shifts, B, R=None,
             cluster: int | None = None):
    """One C call of the redesigned P1 (``tiled=False``) or P2: mode 1 the
    sweep (returns (W = y, R)), mode 2 the back substitution of B = Y with
    the given R (returns (x, R)), mode 3 both (returns (w, R)). Raises on a
    failed launch."""
    name = "maus_hess_solve_v3" if tiled else "maus_hess_solve_v2"
    if B.device.type != "cuda":
        raise ValueError(f"no {name} for device {B.device}")
    import ctypes

    from .build import library

    ops = [t for t in (H, shifts, B, R) if t is not None]
    if any(t.data_ptr() % B.element_size() for t in ops):
        raise ValueError("misaligned operand storage")
    K, N = B.shape
    if K >= 2 ** 31 or r_elems(N, tiled) >= 2 ** 32:
        raise ValueError(f"batch {tuple(B.shape)} exceeds the kernels' range "
                         f"(K < 2^31, a candidate's R under 2^32 elements)")
    plan = card_plan(K, N, B.dtype, tiled, cluster, B.device)
    lib = library()

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(B.device):
        W = torch.empty_like(B)
        if R is None:
            R = torch.empty(K * r_elems(N, tiled), dtype=B.dtype, device=B.device)
        spill = None
        if mode & 1 and plan["home"] == "global":
            spill = torch.empty((K, plan["spill_cols"]), dtype=B.dtype,
                                device=B.device)
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = getattr(lib, name)(
            ptr(H), ptr(shifts), ptr(B if mode & 1 else None), ptr(W), ptr(R),
            ptr(spill), ptr(B if mode == 2 else None),
            int(B.dtype == torch.complex128), K, N, plan["cols"],
            plan["cluster"], mode, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return W, R


@functools.lru_cache(maxsize=None)
def _occupancy(cluster: int, dtype: torch.dtype, tiled: bool, device: int) -> int:
    return back_occupancy(cluster, dtype, tiled, torch.device("cuda", device))


def card_plan(K: int, N: int, dtype: torch.dtype, tiled: bool,
              cluster: int | None = None, device=None) -> dict:
    """:func:`blocked_plan` with the occupancy of the card at ``device``
    (default: the current one), as P1's (``tiled=False``) and P2's wrappers
    launch."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return blocked_plan(K, N, dtype, cluster,
                        active=lambda C: _occupancy(C, dtype, tiled, index))


def back_occupancy(cluster: int, dtype: torch.dtype, tiled: bool = False,
                   device=None) -> int:
    """The most clusters of ``cluster`` back-substitution CTAs of P1
    (``tiled=False``) or P2 that the card runs at once
    (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from .build import library

    if dtype not in BLOCKED_COLS:
        raise ValueError(f"no P1/P2 kernel for {dtype}")
    name = "maus_hess_solve_v3" if tiled else "maus_hess_solve_v2"
    out = ctypes.c_int(0)
    with torch.cuda.device(device or torch.device("cuda")):
        err = getattr(library(), name)(
            None, None, None, ctypes.c_void_p(ctypes.addressof(out)), None, None,
            None, int(dtype == torch.complex128), 1, 1, 0, cluster, 0, None)
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {err}")
    return out.value


def hess_solve_v2(H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor,
                  cluster: int | None = None) -> torch.Tensor:
    """:func:`hess_solve_qr`'s function through P1 (the streaming sweep,
    then the cluster's blocked back substitution with divides); same
    arguments and contract. ``cluster`` forces the back substitution's CTAs
    a candidate (1..8; default :func:`blocked_plan`'s)."""
    global LAUNCHES_V2
    _check(H, shifts, B)
    _check_cluster(cluster)
    if B.device.type == "cpu":
        return hess_solve_v2_plain(H, shifts, B)
    W, _ = _blocked(False, 3, H, shifts, B, cluster=cluster)
    LAUNCHES_V2 += 1
    return W


def hess_solve_v3(H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor,
                  cluster: int | None = None) -> torch.Tensor:
    """:func:`hess_solve_qr`'s function through P2 (the streaming sweep with
    the divide-free rotation, R in column tiles, the cluster's blocked back
    substitution with reciprocal diagonals); same arguments as
    :func:`hess_solve_v2`."""
    global LAUNCHES_V3
    _check(H, shifts, B)
    _check_cluster(cluster)
    if B.device.type == "cpu":
        return hess_solve_v3_plain(H, shifts, B)
    W, _ = _blocked(True, 3, H, shifts, B, cluster=cluster)
    LAUNCHES_V3 += 1
    return W


def blocked_sweep(H: torch.Tensor, shifts: torch.Tensor, B: torch.Tensor,
                  tiled: bool = False):
    """The sweep of P1 (``tiled=False``) or P2 alone: (R, y), R flat in the
    kernel's layout (:func:`r_elems` a candidate), y (K, N) the rotated
    right-hand sides; with :func:`blocked_back` it splits the solve for
    timing."""
    global LAUNCHES_SWEEP
    _check(H, shifts, B)
    if B.device.type == "cpu":
        return blocked_sweep_plain(H, shifts, B, tiled)
    Y, R = _blocked(tiled, 1, H, shifts, B)
    LAUNCHES_SWEEP += 1
    return R, Y


def blocked_back(R: torch.Tensor, Y: torch.Tensor, tiled: bool = False,
                 cluster: int | None = None) -> torch.Tensor:
    """The back substitution of P1 (``tiled=False``) or P2 alone: x with
    R x = y from :func:`blocked_sweep`'s (R, y)."""
    global LAUNCHES_BACK
    _check_cluster(cluster)
    if Y.dtype not in (torch.complex64, torch.complex128) or Y.ndim != 2:
        raise TypeError(f"Y must be (K, N) complex64 or complex128, got "
                        f"{Y.dtype} {tuple(Y.shape)}")
    K, N = Y.shape
    if R.dtype != Y.dtype or R.shape != (K * r_elems(N, tiled),) or \
            R.device != Y.device:
        raise ValueError(f"R must be ({K * r_elems(N, tiled)},) {Y.dtype} on "
                         f"{Y.device}, got {tuple(R.shape)} {R.dtype} on {R.device}")
    if K == 0 or N == 0 or not (R.is_contiguous() and Y.is_contiguous()):
        raise ValueError("R and Y must be non-empty and contiguous")
    if Y.device.type == "cpu":
        return blocked_back_plain(R, Y, tiled)
    X, _ = _blocked(tiled, 2, None, None, Y, R=R, cluster=cluster)
    LAUNCHES_BACK += 1
    return X


def hess_solve_v2_rowloop(H: torch.Tensor, shifts: torch.Tensor,
                          B: torch.Tensor, sweep_only: bool = False) -> torch.Tensor:
    """:func:`hess_solve_v2`'s function through the row-loop body of P1 (one
    block of 256 threads a candidate, sweep and back substitution in one
    kernel), kept as the redesign's yardstick. With ``sweep_only`` it stops
    after the sweep and returns the rotated right-hand sides y."""
    global LAUNCHES_V2_ROWLOOP
    _check(H, shifts, B)
    if B.device.type == "cpu":
        if sweep_only:
            return _sweep(H, shifts, B, _givens)[1]
        return hess_solve_v2_plain(H, shifts, B)
    N = B.shape[1]
    W = _launch("maus_hess_solve_v2_rowloop", H, shifts, B, r_elems(N, False),
                _SHARED_ROW_BYTES_BLOCKED, BLOCK, int(sweep_only))
    LAUNCHES_V2_ROWLOOP += 1
    return W


def hess_solve_v3_rowloop(H: torch.Tensor, shifts: torch.Tensor,
                          B: torch.Tensor, sweep_only: bool = False) -> torch.Tensor:
    """:func:`hess_solve_v3`'s function through the row-loop body of P2; as
    :func:`hess_solve_v2_rowloop`."""
    global LAUNCHES_V3_ROWLOOP
    _check(H, shifts, B)
    if B.device.type == "cpu":
        if sweep_only:
            return _sweep(H, shifts, B, _givens_rsqrt)[1]
        return hess_solve_v3_plain(H, shifts, B)
    W = _launch("maus_hess_solve_v3_rowloop", H, shifts, B,
                r_elems(B.shape[1], True), _SHARED_ROW_BYTES_BLOCKED, BLOCK,
                int(sweep_only))
    LAUNCHES_V3_ROWLOOP += 1
    return W
