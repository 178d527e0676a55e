"""Placement for the mesh engine: a column-sharded operand that the
candidate steps use through a narrow interface, and the candidate axis over
replica ranks.

Counterpart of ``maus_tpu/parallel/placement.py``. In the JAX package the
engine steps take a mesh-sharded A unchanged, because GSPMD shards every
product with A. The port has no GSPMD, so the steps see A through the
functions below: for a plain tensor each is the expression the steps always
used (same numbers, bit for bit); for a :class:`ColumnSharded` operand
each is a local product followed by one collective, and norms and traces
are all_reduced partials (``dist_hessenberg.py:299-327``).

The candidate axis over replica ranks: the caller builds the carry, places
its population and evolves from that carry, as in the JAX package::

    carry0 = evolve.init_carry(cfg, knowledge, A, seed)
    carry0.pop = placement.place_population(mesh, carry0.pop)
    carry = evolve.evolve_while(cfg, knowledge, A, b, seed, iters, target,
                                carry0=carry0)      # or evolve_metrics

:func:`place_population` changes no value: it attaches this rank's slot
range ``[lo, hi)`` along K (``lo`` = replica index · K/r). JAX's layout
shards the population's storage over ``replica``; here every rank keeps
the whole population (K×N: 512 KB at 16 × 4096 complex64) and what is split
is the candidate step. Each step runs its per-candidate work (the mixing,
the shifted solves, the products with A, Lanczos, the snaps) on the rank's
slots through :func:`on_slots`, and the stepped rows and per-candidate flags
come back to every rank of the replica group in one collective
(:func:`gather_rows`). The numbers are those of one device: a row's result
does not depend on the rows beside it (the Ψ ladder freezes finite rows,
GMRES keeps converged ones), up to the rounding of a product's batch
(bit-equal on the CPU; on a card the Lanczos branch can carry that
rounding into another trajectory to other, equally valid, eigenpairs).
With model > 1 the operand is :class:`ColumnSharded` and the steps'
products and shifted solves run inside the model group, whose ranks share
one replica index, so hold the same slots and branch alike.

Cross-candidate work keeps seeing the whole population, on every rank,
after the gather, so that every rank branches alike:
``strategy.compute_diagnostics`` (with ``_pairwise_same`` and
``_svd_leaders_and_target``: the distinct registry, the leader election and
the SVD target); ``population.manage`` and ``_eig_respawn`` (the cumsum
rank of retired slots, the categorical leader pick, the deflation against
the leaders, the slot parity); ``evolve._metrics_row``; the steps'
bookkeeping (``candidate._adapt_and_classify``, the ``StepStats``
fractions, the eig and SVD steps' scale from the largest |λ| or σ); the
SVD step's block round (its QRs and small SVD mix every candidate, so each
rank runs it on the whole block with global slot numbers); the shared
linear proposal x̂ (replicated over replica, as under GSPMD); the
Hermitian steps' claim sets and deflation against the converged vectors.

The public ``solve/eig/svd(mesh=)``, ``MeshSolver`` and the CLI do not
place the population: like the JAX ``_mesh_hosted_drive``
(``maus_tpu/solver/api.py:1081-1153``), each replica group there repeats
the run.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.types import Population, ReplicaSlots
from ..ops.regularize import shift_diagonal
from . import comm
from .mesh import MODEL_AXIS, REPLICA_AXIS, Mesh, column_range


class ColumnSharded:
    """This rank's columns ``A[:, lo:hi]`` of an (M, N) operand, with the
    products the engine needs. ``local`` is (M, N/m) on the rank's device;
    the norm and the trace are reduced once, on first use."""

    def __init__(self, mesh: Mesh, local: torch.Tensor):
        self.mesh = mesh
        self.local = local
        m_rows, c = local.shape
        self.shape = (m_rows, c * mesh.size(MODEL_AXIS))
        self.lo, self.hi = column_range(self.shape[1], mesh)
        self._fro = self._trace = None

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def rows(self, X: torch.Tensor) -> torch.Tensor:
        """X @ A.T: rows A·x_k for X (K, N)."""
        return matvec_rows(self.mesh, self.local, X)

    def left(self, Y: torch.Tensor) -> torch.Tensor:
        """Y @ A for Y (K, M)."""
        return comm.gather(Y @ self.local, self.lo, self.shape[1], self.mesh)

    def rows_conj(self, X: torch.Tensor) -> torch.Tensor:
        """X @ conj(A): rows Aᴴ·x_k for X (K, M)."""
        return matvec_adj(self.mesh, self.local, X)

    def fro(self) -> torch.Tensor:
        """‖A‖_F, a 0-d tensor of A's real dtype."""
        if self._fro is None:
            self._fro = torch.sqrt(comm.all_reduce(
                torch.linalg.vector_norm(self.local) ** 2, self.mesh))
        return self._fro

    def _diag_local(self) -> torch.Tensor:
        return torch.diagonal(self.local[self.lo:self.hi])

    def trace(self) -> torch.Tensor:
        if self._trace is None:
            self._trace = comm.all_reduce(self._diag_local().sum(), self.mesh)
        return self._trace

    def diagonal(self) -> torch.Tensor:
        """The (N,) diagonal of a square A, on every rank."""
        return comm.gather(self._diag_local(), self.lo, self.shape[1], self.mesh)

    def shifted(self, psi) -> torch.Tensor:
        """This rank's columns of ``A + Ψ·(I + 0.15·jitter)``
        (``ops.regularize.apply_shift``), as a new local tensor."""
        d = shift_diagonal(self.shape[1], psi, self.dtype, device=self.device)
        H = self.local.clone()
        torch.diagonal(H[self.lo:self.hi]).add_(d[self.lo:self.hi])
        return H


def place_operands(mesh: Mesh, A_loc: torch.Tensor) -> ColumnSharded:
    """The column-sharded operand of this rank's shard ``A_loc`` (the JAX
    function also places b, which here is simply the same on every
    rank)."""
    return ColumnSharded(mesh, A_loc)


def place_population(mesh: Mesh, pop: Population) -> Population:
    """The population with this rank's slot range along K attached (the
    values unchanged): the candidate steps then advance only slots ``[lo,
    hi)``, ``lo`` = replica index · K/r. K must be divisible by the
    replica axis r; with r = 1 nothing is placed."""
    r = mesh.size(REPLICA_AXIS)
    K = pop.capacity
    if K % r != 0:
        raise ValueError(f"{K} candidates must be divisible by the replica "
                         f"axis ({r})")
    if r == 1:
        return pop
    lo = mesh.index(REPLICA_AXIS) * (K // r)
    return dataclasses.replace(pop, slots=ReplicaSlots(mesh, lo, lo + K // r))


def gather_rows(slots: ReplicaSlots, K: int, outs) -> tuple:
    """Each per-row tensor of ``outs`` ((hi − lo, ...), any dtype) for all K
    slots, on every rank of the replica group, in ONE collective: the rows
    are packed side by side in the complex dtype that holds them all
    (complex128 if any is 64-bit, else complex64; the integers are small
    counts, exact in either), gathered over the replica axis, and unpacked
    to their own dtypes."""
    k = slots.hi - slots.lo
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in outs),
                             torch.complex64)
    flat = [t.reshape(k, -1) for t in outs]
    full = comm.gather(torch.cat([f.to(dtype) for f in flat], dim=1),
                       slots.lo, K, slots.mesh, dim=0, axis=REPLICA_AXIS)
    out, off = [], 0
    for t, f in zip(outs, flat):
        piece = full[:, off:off + f.shape[1]]
        off += f.shape[1]
        if t.dtype == torch.bool:
            piece = piece.real != 0
        elif t.is_complex():
            piece = piece.to(t.dtype)
        else:
            piece = piece.real.to(t.dtype)
        out.append(piece.reshape((K,) + tuple(t.shape[1:])))
    return tuple(out)


def on_slots(pop: Population, fn, *per_row: torch.Tensor) -> tuple:
    """``fn(population, *per_row)`` → a tuple of per-row tensors, run on
    this rank's slots of a placed population (every per-slot tensor and
    ``per_row``'s (K, ...) tensors narrowed to ``[lo, hi)``, no copy; the
    view itself unplaced) and gathered to all K rows; on an unplaced
    population ``fn`` runs on the whole of it."""
    if pop.slots is None:
        return fn(pop, *per_row)
    lo, hi = pop.slots.lo, pop.slots.hi
    view = dataclasses.replace(pop, slots=None, **{
        f.name: getattr(pop, f.name)[lo:hi] for f in dataclasses.fields(pop)
        if isinstance(getattr(pop, f.name), torch.Tensor)})
    return gather_rows(pop.slots, pop.capacity,
                       fn(view, *(t[lo:hi] for t in per_row)))


def matvec_rows(mesh: Mesh, M_loc: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Rows M·x_k, i.e. X @ M.T, for a column-sharded M (``M_loc`` (R,
    N/m)) and X (K, N) on every rank: local product, one all_reduce."""
    lo, hi = column_range(X.shape[-1], mesh)
    return comm.all_reduce(X[:, lo:hi] @ M_loc.T, mesh)


def matvec_adj(mesh: Mesh, M_loc: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Rows Mᴴ·x_k, i.e. X @ conj(M), for a column-sharded M and X (K, R)
    on every rank: the local columns, gathered."""
    n = M_loc.shape[1] * mesh.size(MODEL_AXIS)
    lo, _ = column_range(n, mesh)
    return comm.gather(X @ M_loc.conj(), lo, n, mesh)


def rows(A, X: torch.Tensor) -> torch.Tensor:
    """X @ A.T."""
    return X @ A.T if isinstance(A, torch.Tensor) else A.rows(X)


def left(A, Y: torch.Tensor) -> torch.Tensor:
    """Y @ A."""
    return Y @ A if isinstance(A, torch.Tensor) else A.left(Y)


def rows_conj(A, X: torch.Tensor) -> torch.Tensor:
    """X @ A.conj()."""
    return X @ A.conj() if isinstance(A, torch.Tensor) else A.rows_conj(X)


def fro(A) -> torch.Tensor:
    """‖A‖_F."""
    return torch.linalg.vector_norm(A) if isinstance(A, torch.Tensor) else A.fro()


def trace(A) -> torch.Tensor:
    return torch.trace(A) if isinstance(A, torch.Tensor) else A.trace()


def diagonal(A) -> torch.Tensor:
    return torch.diagonal(A) if isinstance(A, torch.Tensor) else A.diagonal()
