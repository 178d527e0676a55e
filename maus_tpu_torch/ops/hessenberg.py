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
compact-WY blocked Householder reduction is carried over.

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

import torch

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


def reduce_hessenberg_blocked(A: torch.Tensor, nb: int = 64) -> HessCache:
    """Blocked (compact-WY) Householder reduction to upper Hessenberg form.

    The same factorization as :func:`reduce_hessenberg`, but a panel of
    ``nb`` reflectors is accumulated as P = I − V T Vᴴ: within the panel the
    current column is rebuilt from (V, T, Y = H·V) with thin O(N·nb) products
    and one full GEMV per reflector; at the panel's end H and Q take three
    N×nb×N GEMM updates. The (N − 2) mod nb remaining reflectors are applied
    one column at a time."""
    N = A.shape[0]
    dtype, dev = A.dtype, A.device
    H = A.clone()
    Q = torch.eye(N, dtype=dtype, device=dev)
    n_panels = (N - 2) // nb
    tau = torch.tensor(2.0, dtype=dtype, device=dev)
    for p in range(n_panels):
        s = p * nb
        V = torch.zeros((N, nb), dtype=dtype, device=dev)
        T = torch.zeros((nb, nb), dtype=dtype, device=dev)
        Y = torch.zeros((N, nb), dtype=dtype, device=dev)
        for j in range(nb):
            c = s + j
            vrow = V[c].conj()
            g = H[:, c] - Y @ (T @ vrow)
            col = g - V @ (T.conj().T @ (V.conj().T @ g))
            v = _reflector(col, c)
            tcol = -(T @ (V.conj().T @ v)) * tau
            T[:, j] = tcol
            T[j, j] = tau
            V[:, j] = v
            Y[:, j] = H @ v
        W = T @ V.conj().T
        HP = H - Y @ W
        H = HP - V @ (T.conj().T @ (V.conj().T @ HP))
        Q = Q - (Q @ V) @ W
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
