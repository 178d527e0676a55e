"""Operand placement for the mesh engine: a column-sharded operand that the
candidate steps use through a narrow interface.

Counterpart of ``maus_tpu/parallel/placement.py``. In the JAX package the
engine steps take a mesh-sharded A unchanged, because GSPMD shards every
product with A. The port has no GSPMD, so the steps see A through the
functions below: for a plain tensor each is the expression the steps always
used (same numbers, bit for bit); for a :class:`ColumnSharded` operand
each is a local product followed by one collective, and norms and traces
are all_reduced partials (``dist_hessenberg.py:299-327``).

``place_population`` (the candidate axis over replica ranks) is not ported
yet: the population statistics would have to be reduced across ranks.
"""
from __future__ import annotations

import torch

from ..ops.regularize import shift_diagonal
from . import comm
from .mesh import MODEL_AXIS, Mesh, column_range


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
