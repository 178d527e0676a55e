"""Ψ-regularized direct solves: the shared factorization of the linear path.

Counterpart of ``maus_tpu/ops/batched_solve.py``. QR, Cholesky and the
triangular solves are library calls (``torch.linalg``), as the JAX package
leaves them to XLA. LU factorizations go through the port's own batched LU
(``ops/kernels/lu.lu_factor``: kernels P3, P4 and K3 on the card), the one
the JAX package parked as swappable here; ``torch.linalg.lu_solve`` takes
its factors unchanged. Every candidate of a linear system solves the same
``(A + ΨD) x = b``, so one factorization per Ψ level is computed and reused
across iterations. The eig path's per-candidate shifted solves escalate Ψ
through :func:`psi_ladder`; :func:`batched_shifted_solve` is its LU form,
used when the shared Hessenberg reduction is switched off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.metrics import span
from .kernels.lu import lu_factor
from .regularize import apply_shift, psi_magnitude, shift_diagonal


def _solve_upper(R: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(R, y.unsqueeze(-1), upper=True).squeeze(-1)


def _solve_lower(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, y.unsqueeze(-1), upper=False).squeeze(-1)


# ---------------------------------------------------------------------------
# LU
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LUFactors:
    """LU bundle in ``torch.linalg.lu_factor`` layout (1-based pivots)."""

    lu: torch.Tensor
    piv: torch.Tensor


def factor(H: torch.Tensor) -> LUFactors:
    """LU-factorize a square matrix or a (K, N, N) batch."""
    lu, piv = lu_factor(H)
    return LUFactors(lu, piv)


def solve_factored(fac: LUFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve(s) against an existing LU factorization; ``b`` is (..., N)."""
    return torch.linalg.lu_solve(fac.lu, fac.piv, b.unsqueeze(-1)).squeeze(-1)


def shared_factor(A: torch.Tensor, psi) -> LUFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once by LU."""
    return factor(apply_shift(A, psi))


# ---------------------------------------------------------------------------
# Hermitian-positive-definite path: Cholesky
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CholFactors:
    L: torch.Tensor


def factor_chol(H: torch.Tensor) -> CholFactors:
    """Cholesky of an HPD (possibly batched) matrix. Like ``jnp.linalg.
    cholesky``, a matrix that is not positive definite yields a NaN factor
    instead of an error; the engine reads that as a failed solve."""
    L, info = torch.linalg.cholesky_ex(H)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return CholFactors(torch.where(bad, torch.full_like(L, float("nan")), L))


def solve_chol(fac: CholFactors, b: torch.Tensor) -> torch.Tensor:
    """Two triangular solves against the Cholesky factor."""
    y = _solve_lower(fac.L, b)
    return _solve_upper(fac.L.mH, y)


def shared_factor_hpd(A: torch.Tensor, psi) -> CholFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once by Cholesky (HPD linear path)."""
    return factor_chol(apply_shift(A, psi))


# ---------------------------------------------------------------------------
# QR: the default shared linear factorization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QRFactors:
    """Householder-QR bundle with an explicit Q, and R⁻¹ where it is not
    None: the form in which a carry of the JAX package arrives
    (``utils/convert.fac_from_numpy``), so that the parity tests run both
    packages from one state. No module of the port builds one; the port's
    own QR is :class:`QRReflectors`."""

    q: torch.Tensor
    r: torch.Tensor
    rinv: Optional[torch.Tensor] = None


@dataclasses.dataclass
class QRReflectors:
    """The linear path's Householder-QR bundle, without an explicit Q, as
    LAPACK's xGELS keeps it: ``v`` holds geqrf's Householder vectors (unit
    diagonal, zeros above it), ``t`` the compact-WY factor T_k of each block
    of ``nb`` of them, stacked (N/nb rounded up, nb, nb), so that Q = Π_k
    (I − V_k T_k V_kᴴ); a last, narrower block's T is zero-padded. ``rinv``
    is R⁻¹, built from geqrf's upper triangle before that buffer became
    ``v``, with which every solve is products instead of a triangular
    substitution: in iterative refinement the correction solve is a
    preconditioner, so the O(ε·κ) forward error of an explicit inverse
    leaves the contraction rate unchanged. A solve applies Qᴴ (or Q) block
    by block, reading about as many bytes as one product with an explicit
    Q, which this form never spends (16/3)·N³ flops to build."""

    v: torch.Tensor
    t: torch.Tensor
    rinv: torch.Tensor
    # the solves of one vector by A and by Aᴴ, each captured as a CUDA graph
    # on the card (not state)
    graph: object = dataclasses.field(default=None, repr=False, compare=False,
                                      metadata={"checkpoint": False})
    graph_adj: object = dataclasses.field(default=None, repr=False, compare=False,
                                          metadata={"checkpoint": False})


def invert_triangular(R: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Explicit inverse of an upper-triangular R by blocked recursion:

        [R₁₁ R₁₂]⁻¹   [R₁₁⁻¹   −R₁₁⁻¹ R₁₂ R₂₂⁻¹]
        [ 0  R₂₂]   = [ 0            R₂₂⁻¹     ]

    The off-diagonal work is matrix products; only ``block``-sized diagonal
    tiles go to the triangular solver. The blocks are written into one
    preallocated output instead of concatenated, which keeps the peak memory
    at one extra N² buffer (the JAX version concatenates). Only R's upper
    triangle is read (the tiles' triangular solves and the strictly upper
    blocks), so geqrf's output can be passed as it is."""
    out = torch.zeros_like(R)
    _invert_into(R, out, block)
    return out


def _invert_into(R: torch.Tensor, out: torch.Tensor, block: int) -> None:
    n = R.shape[0]
    if n <= block:
        eye = torch.eye(n, dtype=R.dtype, device=R.device)
        out.copy_(torch.linalg.solve_triangular(R, eye, upper=True))
        return
    h = ((n // 2 + block - 1) // block) * block
    h = min(h, n - 1)
    _invert_into(R[:h, :h], out[:h, :h], block)
    _invert_into(R[h:, h:], out[h:, h:], block)
    out[:h, h:] = -(out[:h, :h] @ (R[:h, h:] @ out[h:, h:]))


def wy_block(n: int) -> int:
    """Reflectors per compact-WY block of an N×N implicit QR: N/8 as a
    power of two within [64, 512]. On the card a solve's Qᴴ is then 8 to 32
    blocks; fewer and wider blocks read V in fewer, longer products (at
    4096² 8 blocks of 512 replay in 0.13 ms, 16 of 256 in 0.64 ms), and past
    512 the blocks' T cost more to build than they save (at 16384², 12.8 ms
    for blocks of 512, 25.4 ms for 1024)."""
    return min(512, max(64, 1 << max(0, (n // 8).bit_length() - 1)))


def qr_template(n: int, dtype: torch.dtype) -> QRReflectors:
    """The :class:`QRReflectors` of an N×N operand with meta tensors of its
    leaves' shapes and dtype in place of the factors (a checkpoint loader's
    template)."""
    nb = wy_block(n)

    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    return QRReflectors(meta(n, n), meta(-(-n // nb), nb, nb), meta(n, n))


def _column_major(H: torch.Tensor) -> torch.Tensor:
    """A copy of the square H in LAPACK's column-major layout, which geqrf
    factors in place."""
    n = H.shape[0]
    return torch.empty_strided((n, n), (1, n), dtype=H.dtype,
                               device=H.device).copy_(H)


def _wy_factors(v: torch.Tensor, tau: torch.Tensor, nb: int) -> torch.Tensor:
    """T_k of each block of ``nb`` reflectors of ``v`` (unit-lower, zero
    above the diagonal), stacked (blocks, nb, nb). xLARFT's recurrence
    T(:i, i) = −τ_i·T(:i, :i)·V(:, :i)ᴴ·v_i, T(i, i) = τ_i, is the row
    triangular system T·(I + S·D) = D with S = striu(V_kᴴV_k) and D =
    diag(τ); I + S·D is unit upper triangular whatever τ, so a reflector
    with τ = 0 (a column already reduced) needs no special case."""
    n = v.shape[-1]
    blocks = -(-n // nb)
    S = v.new_zeros((blocks, nb, nb))
    D = v.new_zeros((blocks * nb,))
    D[:n] = tau
    D = D.view(blocks, nb)
    for k in range(blocks):
        j = k * nb
        w = min(nb, n - j)
        vk = v[j:, j:j + w]
        S[k, :w, :w] = vk.mH @ vk
    M = S.triu_(1).mul_(D.unsqueeze(-2))
    return torch.linalg.solve_triangular(M, torch.diag_embed(D), upper=True,
                                         left=False, unitriangular=True).contiguous()


def _factor_reflectors(a: torch.Tensor) -> QRReflectors:
    """The QR of the column-major ``a``, overwritten: geqrf in place, R⁻¹
    from its upper triangle, then the same buffer turned into V and the
    blocks' T."""
    tau = a.new_empty((a.shape[0],))
    torch.geqrf(a, out=(a, tau))
    rinv = invert_triangular(a)
    a.tril_(-1).diagonal().fill_(1)
    return QRReflectors(a, _wy_factors(a, tau, wy_block(a.shape[0])), rinv)


def factor_qr(H: torch.Tensor) -> QRReflectors:
    """The QR of the square H (the condition probe's)."""
    return _factor_reflectors(_column_major(H))


class _Work:
    """The buffers of one solve of (N, M) right-hand sides against a
    :class:`QRReflectors`: ``x`` the right-hand sides, ``c`` conjugates,
    ``r`` and ``s`` a block's rows, ``out`` the answer. With them a solve
    allocates nothing, which a captured graph needs: allocations inside a
    capture would each take a private pool of the graph's own, new device
    memory for every factorization."""

    def __init__(self, like: torch.Tensor, n: int, nb: int, m: int):
        self.x, self.c, self.out = (like.new_empty((n, m)) for _ in range(3))
        self.r, self.s = like.new_empty((m, nb)), like.new_empty((m, nb))

    def solve(self, fac: QRReflectors) -> None:
        """out ← R⁻¹·Qᴴ·x, x overwritten by Qᴴ·x. Block k is x ← x −
        V_k·(T_kᴴ·(V_kᴴ·x)) on rows j_k … N, the blocks in order. Its first
        two products are taken as rows, zᴴ = (xᴴ·V_k)·T_k, so that V_k and
        T_k are read as stored: a product with a conjugate-transposed matrix
        makes torch conjugate all of it first (at 16384² that copy of an
        explicit Q takes twice the product's own time), and here only the M
        vectors are conjugated."""
        n, nb = fac.v.shape[-1], fac.t.shape[-1]
        for k in range(fac.t.shape[0]):
            j = k * nb
            w = min(nb, n - j)
            vk, xk, r, s = fac.v[j:, j:j + w], self.x[j:], self.r[:, :w], self.s[:, :w]
            ck = torch.conj_physical(xk, out=self.c[j:])
            torch.mm(ck.mT, vk, out=r)
            torch.mm(r, fac.t[k, :w, :w], out=s)
            xk.addmm_(vk, s.conj_physical_().mT, alpha=-1)
        torch.mm(fac.rinv, self.x, out=self.out)

    def solve_adj(self, fac: QRReflectors) -> None:
        """out ← Q·R⁻ᴴ·x. R⁻ᴴ·x is conj(R⁻¹ᵀ·conj x); then block k is y ←
        y − V_k·(T_k·(V_kᴴ·y)) on rows j_k … N, the blocks in reverse order.
        As in :meth:`solve`, R⁻¹, V_k and T_k are read as stored or
        transposed, never conjugated: zᵀ = conj(yᴴ·V_k)·T_kᵀ."""
        n, nb = fac.v.shape[-1], fac.t.shape[-1]
        torch.conj_physical(self.x, out=self.c)
        y = torch.mm(fac.rinv.mT, self.c, out=self.out).conj_physical_()
        for k in reversed(range(fac.t.shape[0])):
            j = k * nb
            w = min(nb, n - j)
            vk, yk, r, s = fac.v[j:, j:j + w], y[j:], self.r[:, :w], self.s[:, :w]
            ck = torch.conj_physical(yk, out=self.c[j:])
            torch.mm(ck.mT, vk, out=r)
            torch.mm(r.conj_physical_(), fac.t[k, :w, :w].mT, out=s)
            yk.addmm_(vk, s.mT, alpha=-1)


# one capture stream a card, as ``torch.cuda.graph`` keeps one: cuBLAS holds
# a workspace for every stream it has run on
_CAPTURE_STREAMS: dict = {}


class _SolveGraph:
    """A bundle's solve of one vector (``_Work.solve``, or ``_Work.
    solve_adj`` for Aᴴ) as one captured CUDA graph. Its five launches a
    block, about forty at 4096², take the host several times as long as the
    device when launched one by one. The first solve runs eagerly on a side
    stream, which also readies cuBLAS there, and the graph is captured after
    it (with no synchronisation and no emptying of the allocator's cache,
    which ``torch.cuda.graph`` would add); a later solve copies b into the
    work's ``x`` and replays. Either leaves the answer in the work's
    ``out``."""

    def __init__(self, fac: QRReflectors, b: torch.Tensor, adjoint: bool = False):
        dev = b.device
        main = torch.cuda.current_stream(dev)
        side = _CAPTURE_STREAMS.setdefault(dev, torch.cuda.Stream(device=dev))
        self.work = _Work(b, b.shape[0], fac.t.shape[-1], 1)
        solve = self.work.solve_adj if adjoint else self.work.solve
        self.graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.work.x.copy_(b.unsqueeze(-1))
            solve(fac)
            self.graph.capture_begin()
            solve(fac)
            self.graph.capture_end()
        main.wait_stream(side)

    def replay(self, b: torch.Tensor) -> None:
        self.work.x.copy_(b.unsqueeze(-1))
        self.graph.replay()


def _solve_reflectors(fac: QRReflectors, b: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """A solve by A (or Aᴴ) for ``b`` of shape (..., N); a single vector on
    the card goes through the bundle's captured graph of that direction."""
    if b.is_cuda and b.ndim == 1 and b.dtype == fac.v.dtype:
        slot = "graph_adj" if adjoint else "graph"
        graph = getattr(fac, slot)
        if graph is None:
            graph = _SolveGraph(fac, b, adjoint)
            setattr(fac, slot, graph)
        else:
            graph.replay(b)
        return graph.work.out.squeeze(-1).clone()
    n = fac.v.shape[-1]
    B = b.reshape(-1, n)
    work = _Work(B, n, fac.t.shape[-1], B.shape[0])
    work.x.copy_(B.mT)
    (work.solve_adj if adjoint else work.solve)(fac)
    return work.out.mT.reshape(b.shape)


def solve_qr(fac, b: torch.Tensor) -> torch.Tensor:
    """x = R⁻¹ Qᴴ b, the solve by A, for ``b`` of shape (..., N)."""
    if isinstance(fac, QRReflectors):
        return _solve_reflectors(fac, b, adjoint=False)
    y = (fac.q.mH @ b.unsqueeze(-1)).squeeze(-1)
    if fac.rinv is not None:
        return (fac.rinv @ y.unsqueeze(-1)).squeeze(-1)
    return _solve_upper(fac.r, y)


def solve_qr_adj(fac: QRReflectors, b: torch.Tensor) -> torch.Tensor:
    """x = Q R⁻ᴴ b, the solve by Aᴴ, for ``b`` of shape (..., N)."""
    return _solve_reflectors(fac, b, adjoint=True)


def shared_factor_qr(A: torch.Tensor, psi) -> QRReflectors:
    """Factor ``H = A + Ψ·(I + jitter)`` once by QR (default linear path),
    the factorization in one span ``maus.factor.implicit_q``. It shifts a
    column-major copy of A and factors it in place, so no other N² copy of
    H is held."""
    H = _column_major(A)
    H.diagonal().add_(shift_diagonal(A.shape[-1], psi, A.dtype, device=A.device))
    with span("maus.factor.implicit_q"):
        return _factor_reflectors(H)


def solve_any(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve against whichever factorization bundle ``fac`` is."""
    if isinstance(fac, CholFactors):
        return solve_chol(fac, b)
    if isinstance(fac, (QRFactors, QRReflectors)):
        return solve_qr(fac, b)
    return solve_factored(fac, b)


# ---------------------------------------------------------------------------
# Ψ ladder: per-candidate escalation of the eig path's shifted solves
# ---------------------------------------------------------------------------

def _finite_rows(x: torch.Tensor) -> torch.Tensor:
    return (torch.isfinite(x.real) & torch.isfinite(x.imag)).all(dim=-1)


def psi_ladder(solve_at, K: int, max_attempts: int, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``solve_at(attempt_k: (K,) int32) -> (K, N)`` solves at per-candidate
    attempt levels. Candidates whose result is finite are frozen; the ladder
    re-solves while some candidate is non-finite and has attempts left.
    Rows still non-finite at the end come back zero (the candidate layer
    reads a zero update as a failed solve). Returns ``(W, attempts)``."""
    attempts = torch.zeros((K,), dtype=torch.int32, device=device)
    W = solve_at(attempts)
    ok = _finite_rows(W)
    while bool((~ok & (attempts < max_attempts)).any()):
        attempts = torch.where(ok, attempts, attempts + 1)
        W_try = solve_at(attempts)
        W = torch.where(ok[:, None], W, W_try)
        ok = ok | _finite_rows(W_try)
    W = torch.where(ok[:, None], W, torch.zeros_like(W))
    return W, attempts


def batched_shifted_solve(A: torch.Tensor, lams: torch.Tensor,
                          stuck: torch.Tensor, psi_base, aggression,
                          B: torch.Tensor, max_attempts: int = 4
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve ``(A − λ_k I + Ψ_k D) w_k = B_k`` by one LU per candidate, with
    Ψ_k growing with the candidate's stuck counter and ladder attempt.
    Returns ``(W, attempts)``."""
    K, N = B.shape

    def solve_at(attempt_k):
        psi = psi_magnitude(psi_base, aggression, attempt_k, stuck)
        d = shift_diagonal(N, psi[:, None], A.dtype) - lams[:, None].to(A.dtype)
        H = A.expand(K, N, N).clone()
        H.diagonal(dim1=-2, dim2=-1).add_(d)
        fac = factor(H)
        return torch.linalg.lu_solve(fac.lu, fac.piv, B.unsqueeze(-1)).squeeze(-1)

    return psi_ladder(solve_at, K, max_attempts, device=B.device)
