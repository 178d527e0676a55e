"""Hessenberg reduction and batched shifted Hessenberg solves.

Counterpart of ``maus_tpu/ops/hessenberg.py``. Every candidate of the
non-Hermitian eig path solves ``(A − λ_k I + ψ_k I) w = v_k`` against the same
A, so A is reduced once per evolve to ``A = Q H Qᴴ`` (upper Hessenberg H,
unitary Q), after which

    (A − λI + ψI)⁻¹ v  =  Q · (H − λI + ψI)⁻¹ · Qᴴ v

and each shifted solve is a Givens factorization of an upper-Hessenberg
matrix, O(N²) per candidate with no pivoting. That solve is kernel K2 on the
card (:mod:`maus_tpu_torch.ops.kernels.hess_solve`: a bottom-up RQ sweep
fused with the back substitution, where the JAX package sweeps top-down by
QR; the two orders agree to rounding in residual and direction); the two
GEMMs around it stay ``torch.matmul``. torch has no Hessenberg reduction either, so the
compact-WY blocked Householder reduction is carried over; on the card each of
its reflectors is one replay of a captured CUDA graph.

Not carried over, because both are TPU limits and not part of the contract:
the ``_pallas_dispatch_ok`` gate (complex64, N % 128 == 0, N ≤ 1024, K a
multiple of the VMEM chunk), which sent every other shape to a ``lax.scan``
fallback, and the ``_HESS_SOLVE_TEMP_CAP`` candidate chunking, which bounded
the scan's double-buffered (K, N, N) HLO temporaries. The CUDA kernel takes
any (K, N) and stores no triangular factor: its scratch is O(K·N), beside a
transposed copy of H.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..utils.metrics import span
from .kernels.hess_solve import hess_solve


@dataclasses.dataclass
class HessCache:
    """Shared Hessenberg form of the operand: A = Q H Qᴴ."""

    h: torch.Tensor   # (N, N) upper Hessenberg, contiguous
    q: torch.Tensor   # (N, N) unitary


def _reflector(col: torch.Tensor, c: int) -> torch.Tensor:
    """Normalized Householder vector, support rows > c, that zeroes ``col``
    below row c+1 (``v = 0`` when there is nothing to zero)."""
    N = col.shape[0]
    rows = torch.arange(N, device=col.device)
    x = torch.where(rows > c, col, torch.zeros_like(col))
    normx = torch.linalg.vector_norm(x)
    pivot = x[c + 1]
    absp = pivot.abs()
    sign = torch.where(absp > 0, pivot / torch.clamp_min(absp, 1e-30),
                       torch.ones_like(pivot))
    beta = -sign * normx.to(col.dtype)
    v = x - beta * (rows == c + 1).to(col.dtype)
    vn = torch.linalg.vector_norm(v)
    ok = (vn > 1e-30) & (normx > 1e-30)
    return torch.where(ok, v / torch.clamp_min(vn, 1e-30).to(col.dtype),
                       torch.zeros_like(v))


def _similarity_step(H: torch.Tensor, Q: torch.Tensor, c: int) -> None:
    """One reflector P = I − 2vvᴴ applied in place: H ← P H P, Q ← Q P."""
    v = _reflector(H[:, c], c)
    H -= 2.0 * torch.outer(v, v.conj() @ H)
    H -= 2.0 * torch.outer(H @ v, v.conj())
    Q -= 2.0 * torch.outer(Q @ v, v.conj())


def reduce_hessenberg(A: torch.Tensor) -> HessCache:
    """Householder reduction to upper Hessenberg form, one column at a time
    (O(N³), GEMV-bound). Entries below the subdiagonal come back exactly 0."""
    N = A.shape[0]
    H = A.clone()
    Q = torch.eye(N, dtype=A.dtype, device=A.device)
    for c in range(max(N - 2, 0)):
        _similarity_step(H, Q, c)
    return HessCache(h=torch.triu(H, diagonal=-1).contiguous(), q=Q)


@dataclasses.dataclass
class _PanelWork:
    """The blocked reduction's working state: H reduced in place, the
    panel's compact-WY factors (P = I − V T Vᴴ, Y = H·V) and the current
    column c and panel column j as device integers, so that one reflector is
    the same sequence of device operations wherever it falls. On the card
    that sequence is captured once as a CUDA graph (``graph``) and replayed
    for every reflector: the reduction is a chain of about forty small
    operations a reflector, and launched one by one from the host its time
    follows the host's speed, which varies by tens of percent from run to
    run on a shared machine."""

    H: torch.Tensor       # (N, N)
    V: torch.Tensor       # (N, nb)
    T: torch.Tensor       # (nb, nb)
    Y: torch.Tensor       # (N, nb)
    rows: torch.Tensor    # (N,) 0 … N − 1
    c: torch.Tensor       # (1,) int64: the column being reduced
    j: torch.Tensor       # (1,) int64: its column in the panel
    two: torch.Tensor     # () the reflectors' τ = 2
    graph: object = None  # torch.cuda.CUDAGraph of one _reflector_step


def _reflector_step(w: _PanelWork) -> None:
    """Reflector c of the panel: column c of the partly updated H
    (H − Y·T·Vᴴ then (I − V·Tᴴ·Vᴴ)·), its normalized Householder vector v
    (support rows > c, zero when there is nothing to zero; ‖v‖ taken from
    ‖x‖ and the pivot), then T's column j, V[:, j] = v, Y[:, j] = H·v; then
    c and j move on by one."""
    c1 = w.c + 1
    vrow = w.V.index_select(0, w.c).squeeze(0).conj()
    g = w.H.index_select(1, w.c).squeeze(1) - w.Y @ (w.T @ vrow)
    col = g - w.V @ (w.T.mH @ (w.V.mH @ g))
    x = torch.where(w.rows > w.c, col, 0)
    normx = torch.linalg.vector_norm(x)
    pivot = x.index_select(0, c1)
    absp = pivot.abs()
    sign = torch.where(absp > 0, pivot / absp, 1)
    v = x.index_add(0, c1, sign * normx)       # x − β·e_{c+1}, β = −sign·‖x‖
    v = v * torch.where(normx > 1e-30, torch.rsqrt(2 * normx * (normx + absp)), 0)
    w.T.index_copy_(1, w.j, (-2 * (w.T @ (w.V.mH @ v))).unsqueeze(1))
    w.T.index_put_((w.j, w.j), w.two)
    w.V.index_copy_(1, w.j, v.unsqueeze(1))
    w.Y.index_copy_(1, w.j, (w.H @ v).unsqueeze(1))
    w.c.add_(1)
    w.j.add_(1)


def _panel_work(N: int, nb: int, dtype, device) -> _PanelWork:
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def index():
        return torch.zeros(1, dtype=torch.int64, device=device)

    return _PanelWork(H=zeros(N, N), V=zeros(N, nb), T=zeros(nb, nb), Y=zeros(N, nb),
                      rows=torch.arange(N, device=device), c=index(), j=index(),
                      two=torch.full((), 2.0, dtype=dtype, device=device))


# the CUDA working state of the last shape reduced, with its captured graph
_CUDA_WORK: dict = {}


def _cuda_work(N: int, nb: int, dtype, device) -> _PanelWork:
    """The cached working state for this shape on the card (one shape is
    kept), its reflector step captured as a graph on first use, after one
    warm-up run on the capture's side stream."""
    key = (N, nb, dtype, device)
    w = _CUDA_WORK.get(key)
    if w is None:
        _CUDA_WORK.clear()
        w = _panel_work(N, nb, dtype, device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _reflector_step(w)
        torch.cuda.current_stream(device).wait_stream(side)
        w.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(w.graph):
            _reflector_step(w)
        _CUDA_WORK[key] = w
    return w


def reduce_hessenberg_blocked(A: torch.Tensor, nb: int = 64) -> HessCache:
    """Blocked (compact-WY) Householder reduction to upper Hessenberg form.

    The same factorization as :func:`reduce_hessenberg`, but a panel of
    ``nb`` reflectors is accumulated as P = I − V T Vᴴ: within the panel the
    current column is rebuilt from (V, T, Y = H·V) with thin O(N·nb) products
    and one full GEMV per reflector (:func:`_reflector_step`; one graph
    replay a reflector on the card); at the panel's end H and Q take three
    N×nb×N GEMM updates in place. The (N − 2) mod nb remaining reflectors
    are applied one column at a time."""
    N = A.shape[0]
    n_panels = (N - 2) // nb
    if A.is_cuda:
        w = _cuda_work(N, nb, A.dtype, A.device)
        step = w.graph.replay
    else:
        w = _panel_work(N, nb, A.dtype, A.device)
        step = functools.partial(_reflector_step, w)
    H = w.H
    H.copy_(A)
    w.c.zero_()
    Q = torch.eye(N, dtype=A.dtype, device=A.device)
    for _ in range(n_panels):
        with span("maus.hessenberg.panel"):
            w.V.zero_()
            w.T.zero_()
            w.Y.zero_()
            w.j.zero_()
            for _ in range(nb):
                step()
            W = w.T @ w.V.mH
            H.addmm_(w.Y, W, alpha=-1)
            H.addmm_(w.V, w.T.mH @ (w.V.mH @ H), alpha=-1)
            Q.addmm_(Q @ w.V, W, alpha=-1)
    for c in range(n_panels * nb, max(N - 2, 0)):
        _similarity_step(H, Q, c)
    return HessCache(h=torch.triu(H, diagonal=-1).contiguous(), q=Q)


def reduce_hessenberg_auto(A: torch.Tensor, nb: int = 64) -> HessCache:
    """The blocked reduction when N is large enough to amortize its panels,
    the column-at-a-time one otherwise."""
    if A.shape[0] - 2 >= 2 * nb:
        return reduce_hessenberg_blocked(A, nb=nb)
    return reduce_hessenberg(A)


def solve_shifted_hessenberg(H: torch.Tensor, lams: torch.Tensor,
                             B: torch.Tensor,
                             psi: torch.Tensor | None = None) -> torch.Tensor:
    """Solve ``(H − λ_k I + ψ_k I) w_k = b_k`` for K candidates at once.

    ``psi``: optional (K,) real regularization added to the shifted
    diagonal (the Ψ ladder's rung). A CUDA tensor goes to kernel K2, a CPU
    tensor to its plain version; there is no shape gate."""
    shift = -lams.to(B.dtype)
    if psi is not None:
        shift = shift + psi.to(B.dtype)
    return hess_solve(H.contiguous(), shift.contiguous(), B.contiguous())


def solve_shifted_via_hessenberg(cache: HessCache, lams: torch.Tensor,
                                 B: torch.Tensor,
                                 psi: torch.Tensor | None = None) -> torch.Tensor:
    """(A − λ_k I + ψ_k I)⁻¹ b_k given the shared Hessenberg form of A."""
    Bh = B @ cache.q.conj()                  # rows = Qᴴ b_k
    W = solve_shifted_hessenberg(cache.h, lams, Bh, psi)
    return W @ cache.q.T                     # rows = Q w_k
