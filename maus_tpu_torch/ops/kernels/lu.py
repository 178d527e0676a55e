"""Kernels P3 and P4: batched LU with partial pivoting, unblocked and blocked.

Replace ``benchmarks/parked/pallas_lu.py::lu_factor_batched`` (P3) and
``benchmarks/parked/pallas_lu_blocked.py::lu_factor_batched_blocked`` (P4).
The CUDA source is ``maus_tpu_torch/csrc/lu.cu`` (design and bounds in its
header). :func:`lu_panel` factors the columns [s, e) of a batch in place — with
[s, e) = [0, N) it is the whole unblocked LU, P3's counterpart.
:func:`lu_factor` is the blocked right-looking LU, P4's counterpart: per
panel of ``NB`` columns (the last one ragged) the panel factorization, the
panel's row interchanges on the other columns fused with the unit-lower solve
for U₁₂, and the trailing update A₂₂ −= L₂₁·U₁₂ by kernel K3, all launched by
one C function (``maus_lu_factor``) on the current stream. The result is
``(lu, piv)`` exactly as ``torch.linalg.lu_factor`` gives it (packed LU,
int32 1-based pivots), so ``torch.linalg.lu_solve`` consumes it unchanged.

Two panel kernels: the cluster kernel keeps a matrix's panel in the shared
memory of a cluster of C CTAs (C ≤ 16) for the whole panel; the one-block
kernel keeps it in global memory. :func:`choose_panel_kernel` picks, from the
shape alone and the card's ``cudaOccupancyMaxActiveClusters``, before any
launch: a panel of at most ``CLUSTER_MAX_WIDTH`` columns whose rows, split
over C CTAs, fit a CTA's shared memory (``SMEM_LIMIT``) takes the cluster
kernel, with the C of fewest waves of clusters and then fewest rows per CTA;
anything else (wider panels, complex128 at N − s > 3520, complex64 at
N − s > 7024) takes the one-block kernel.

The pivot of a column is the row of largest |a|² (the first on ties), as in
the JAX kernels; LAPACK, behind ``torch.linalg.lu_factor`` and
``jax.scipy.linalg.lu_factor``, ranks by |Re| + |Im| and may pick another
row. A zero pivot leaves zero multipliers and a zero on U's diagonal, so a
solve against the factors comes back non-finite.

The wrappers launch the kernels for CUDA tensors and take the plain versions
(:func:`lu_panel_plain`, :func:`lu_factor_plain`, the same algorithm in torch
operations) only for tensors on the CPU; on a CUDA tensor they launch or
raise. ``PANEL_LAUNCHES`` counts one-block panel launches,
``CLUSTER_PANEL_LAUNCHES`` cluster panel launches, ``LAUNCHES`` the blocked
factorizations run on the card; each of those also adds its K3 launches to
``cgemm.LAUNCHES``.
"""
from __future__ import annotations

import torch

from . import cgemm as cgemm_mod

LAUNCHES = 0
PANEL_LAUNCHES = 0
CLUSTER_PANEL_LAUNCHES = 0

# Panel width of the blocked LU: the panel's column steps are a latency-bound
# chain whatever its width, while each trailing update reads and writes the
# whole trailing matrix, so wider panels mean fewer of those passes. The
# kernel's triangular solve holds the panel's L₁₁ in shared memory, up to 64.
NB = 64

# The cluster panel kernel: cluster sizes it may take (16 is past the
# portable 8), the widest panel (a warp's 32 lanes own two columns each), and
# the dynamic shared memory a CTA may hold (227 KB on sm_90, less 2 KB for
# the kernel's static arrays: 1.3 KB at complex128).
CLUSTER_SIZES = (16, 14, 12, 10, 8, 4, 2, 1)
CLUSTER_MAX_WIDTH = 64
SMEM_LIMIT = 227 * 1024 - 2048


def cluster_smem_bytes(rows_per_cta: int, width: int, itemsize: int) -> int:
    """Dynamic shared memory of a cluster-kernel CTA: its rows of the panel
    (``itemsize`` bytes per complex entry, one entry of padding per row)
    and one row index per row."""
    return rows_per_cta * ((width + 1) * itemsize + 4)


def choose_panel_kernel(K: int, n_rows: int, width: int, itemsize: int,
                        active_clusters) -> int:
    """The panel kernel for K matrices whose panel has ``n_rows`` rows (N − s)
    and ``width`` columns of ``itemsize``-byte entries: a cluster size C > 0
    for the cluster kernel, or 0 for the one-block kernel. A C qualifies if
    its ⌈n_rows/C⌉ rows fit a CTA (``SMEM_LIMIT``) and
    ``active_clusters(C, rows_per_cta, width)`` (the card's
    ``cudaOccupancyMaxActiveClusters``) is positive; of those, the fewest
    waves ⌈K/active⌉ × rows per CTA wins (per column step a CTA's time grows
    with its rows), ties to the larger C. A pure function of its arguments."""
    if width > CLUSTER_MAX_WIDTH:
        return 0
    best, best_cost = 0, None
    for C in CLUSTER_SIZES:
        rows = -(-n_rows // C)
        if cluster_smem_bytes(rows, width, itemsize) > SMEM_LIMIT:
            continue
        active = active_clusters(C, rows, width)
        if active <= 0:
            continue
        cost = -(-K // active) * rows
        if best_cost is None or cost < best_cost:
            best, best_cost = C, cost
    return best


def panel_routes(K: int, N: int, itemsize: int, active_clusters, nb: int = NB):
    """:func:`choose_panel_kernel` for every panel of the blocked LU."""
    return [choose_panel_kernel(K, N - s, min(nb, N - s), itemsize, active_clusters)
            for s in range(0, N, nb)]


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


def _stream(t: torch.Tensor):
    import ctypes

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor):
    import ctypes

    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


_OCCUPANCY: dict = {}


def cluster_occupancy(C: int, rows_per_cta: int, width: int, dtype: torch.dtype,
                      device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster panel kernel with C
    CTAs of ``rows_per_cta`` rows of a ``width``-column panel each, on a CUDA
    device (cached)."""
    import ctypes

    from .build import library

    device = torch.device(device)
    key = (device.index, C, rows_per_cta, width, dtype)
    if key not in _OCCUPANCY:
        active = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = library().maus_lu_cluster_occupancy(
                int(dtype == torch.complex128), C, rows_per_cta, width,
                ctypes.byref(active))
        _raise_on(err, f"cudaOccupancyMaxActiveClusters (C = {C})")
        _OCCUPANCY[key] = active.value
    return _OCCUPANCY[key]


def _active_clusters(lu: torch.Tensor):
    """``active_clusters(C, rows_per_cta, width)`` for
    :func:`choose_panel_kernel` on ``lu``'s card."""
    return lambda C, rows, width: cluster_occupancy(C, rows, width, lu.dtype,
                                                    lu.device)


_ROUTES: dict = {}


def _factor_routes(lu: torch.Tensor) -> list:
    """:func:`panel_routes` for ``lu``'s shape on its card (cached)."""
    K, N, _ = lu.shape
    key = (lu.device.index, K, N, lu.dtype)
    if key not in _ROUTES:
        _ROUTES[key] = panel_routes(K, N, lu.element_size(), _active_clusters(lu))
    return _ROUTES[key]


def lu_panel(lu: torch.Tensor, piv: torch.Tensor, s: int, e: int,
             cluster: int | None = None) -> None:
    """Factor columns [s, e) of rows [s, N) of the contiguous (K, N, N)
    complex batch ``lu`` in place, with partial pivoting; the pivots go to
    ``piv[:, s:e]`` (int32, 1-based) and the row swaps touch the panel's
    columns only. The kernel on a CUDA tensor, the plain version on a CPU
    tensor. ``cluster`` picks the kernel on the card: None by
    :func:`choose_panel_kernel`, 0 the one-block kernel, C > 0 the cluster
    kernel with C CTAs per matrix (ValueError if the panel does not fit)."""
    global PANEL_LAUNCHES, CLUSTER_PANEL_LAUNCHES
    _check_panel_args(lu, piv, s, e)
    K, N, _ = lu.shape
    w = e - s
    if cluster and (cluster not in CLUSTER_SIZES or w > CLUSTER_MAX_WIDTH or
                    cluster_smem_bytes(-(-(N - s) // cluster), w,
                                       lu.element_size()) > SMEM_LIMIT):
        raise ValueError(f"panel [{s}, {e}) of N = {N} {lu.dtype} does not fit "
                         f"the cluster kernel at C = {cluster}")
    if lu.device.type == "cpu":
        return lu_panel_plain(lu, piv, s, e)
    if lu.device.type != "cuda":
        raise ValueError(f"no lu_panel for device {lu.device}")
    from .build import library

    if cluster is None:
        cluster = choose_panel_kernel(K, N - s, w, lu.element_size(),
                                      _active_clusters(lu))
    if K * max(cluster, 1) >= 2 ** 31:
        raise ValueError(f"batch {K} × cluster {cluster} exceeds the grid")
    lib = library()
    c128 = int(lu.dtype == torch.complex128)
    with torch.cuda.device(lu.device):
        if cluster:
            err = lib.maus_lu_panel_cluster(_ptr(lu), _ptr(piv), c128, K, N, s, e,
                                            cluster, _stream(lu))
        else:
            err = lib.maus_lu_panel(_ptr(lu), _ptr(piv), c128, K, N, s, e,
                                    _stream(lu))
    _raise_on(err, "lu_panel kernel launch")
    if cluster:
        CLUSTER_PANEL_LAUNCHES += 1
    else:
        PANEL_LAUNCHES += 1
    return None


def _count_factor(routes) -> None:
    """Count one blocked factorization run by ``maus_lu_factor`` with the
    route table ``routes``: its panel launches on the kernel each route
    names, and one K3 trailing update per panel but the last."""
    global LAUNCHES, PANEL_LAUNCHES, CLUSTER_PANEL_LAUNCHES
    LAUNCHES += 1
    clustered = sum(1 for c in routes if c)
    CLUSTER_PANEL_LAUNCHES += clustered
    PANEL_LAUNCHES += len(routes) - clustered
    cgemm_mod.LAUNCHES += len(routes) - 1


def lu_factor(H: torch.Tensor):
    """LU with partial pivoting of a (K, N, N) or (N, N) complex64 or
    complex128 tensor (any K, N ≥ 1; H is not modified). Returns
    ``(lu, piv)`` in ``torch.linalg.lu_factor``'s layout: the kernels on a
    CUDA tensor, :func:`lu_factor_plain` on a CPU tensor."""
    _check_batch(H)
    if H.device.type == "cpu":
        return lu_factor_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"no lu_factor for device {H.device}")
    import ctypes

    from .build import library

    lib = library()
    squeeze = H.ndim == 2
    lu = (H.unsqueeze(0) if squeeze else H).clone(
        memory_format=torch.contiguous_format)
    K, N, _ = lu.shape
    if K > 65535:
        raise ValueError(f"batch {K} exceeds the solve and update kernels' grid "
                         f"(K <= 65535)")
    piv = torch.empty((K, N), dtype=torch.int32, device=lu.device)
    routes = _factor_routes(lu)
    table = (ctypes.c_int * len(routes))(*routes)
    with torch.cuda.device(lu.device):
        err = lib.maus_lu_factor(_ptr(lu), _ptr(piv),
                                 int(lu.dtype == torch.complex128), K, N, NB, table,
                                 _stream(lu))
    _raise_on(err, "lu_factor kernel launch")
    _count_factor(routes)
    return (lu[0], piv[0]) if squeeze else (lu, piv)
