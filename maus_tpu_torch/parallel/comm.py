"""The collectives of the mesh paths, all in one place.

The port's counterpart of every ``jax.lax.psum`` / ``all_gather`` / ``pmax``
in ``maus_tpu/parallel/`` and of the collectives GSPMD inserts around a
sharded operand. Two kinds suffice: :func:`all_reduce` (sum, or max for the
one range statistic of the distributed SVD) and :func:`broadcast` from the
owner of a block. An ``all_gather`` of disjoint column supports is a scatter
into the full width followed by one sum (:func:`gather`), as the JAX code
itself does (``dist_hessenberg.py:232-236``, ``dist_svd.py:155-159``).

Every collective adds its calls and its bytes (the operand's, per rank) to
the counters of its kind, and of its mesh axis, in every :func:`counting`
context open around it (``utils/comm_budget.py`` reads one). Both kinds take the tensor where it
lies: gloo and NCCL run them on CUDA tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, REPLICA_AXIS, Mesh

KINDS = ("all_reduce", "broadcast")
AXES = (MODEL_AXIS, REPLICA_AXIS)


def _zeros(keys):
    return dataclasses.field(default_factory=lambda: dict.fromkeys(keys, 0))


@dataclasses.dataclass
class Counts:
    """Calls, bytes and the largest single call's bytes per collective
    kind, and the same per mesh axis (``axis_calls``, ``axis_bytes``,
    ``axis_largest``)."""

    calls: dict = _zeros(KINDS)
    bytes: dict = _zeros(KINDS)
    largest: dict = _zeros(KINDS)
    axis_calls: dict = _zeros(AXES)
    axis_bytes: dict = _zeros(AXES)
    axis_largest: dict = _zeros(AXES)

    def add(self, kind: str, axis: str, nbytes: int) -> None:
        for calls, total, largest, key in (
                (self.calls, self.bytes, self.largest, kind),
                (self.axis_calls, self.axis_bytes, self.axis_largest, axis)):
            calls[key] += 1
            total[key] += nbytes
            largest[key] = max(largest[key], nbytes)


_open: list = []


@contextlib.contextmanager
def counting():
    """Count the collectives issued inside the block into a fresh
    :class:`Counts`."""
    counts = Counts()
    _open.append(counts)
    try:
        yield counts
    finally:
        _open.remove(counts)


def _record(kind: str, axis: str, t: torch.Tensor) -> None:
    for counts in _open:
        counts.add(kind, axis, t.numel() * t.element_size())


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS,
               op: str = "sum") -> torch.Tensor:
    """The sum (or, with ``op="max"``, the maximum of a real tensor) of
    ``t`` over the ranks of ``axis``, as a new tensor on every rank."""
    if mesh.size(axis) == 1:
        return t
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = t.contiguous().clone()
    _record("all_reduce", axis, out)
    dist.all_reduce(out, op=reduce_op, group=mesh.groups[axis])
    return out


def broadcast(t: torch.Tensor, src: int, mesh: Mesh,
              axis: str = MODEL_AXIS) -> torch.Tensor:
    """``t`` of the rank at index ``src`` along ``axis``, as a new tensor on
    every rank (the others pass a tensor of the same shape and dtype, whose
    values are ignored)."""
    if mesh.size(axis) == 1:
        return t
    out = t.contiguous().clone()
    _record("broadcast", axis, out)
    dist.broadcast(out, src=mesh.global_rank(axis, src), group=mesh.groups[axis])
    return out


def gather(local: torch.Tensor, lo: int, n: int, mesh: Mesh, dim: int = -1,
           axis: str = MODEL_AXIS) -> torch.Tensor:
    """The full tensor whose slice ``[lo, lo + width)`` along ``dim`` is
    this rank's ``local`` (the ranks' slices tile ``[0, n)``): scattered into
    zeros of the full extent and summed."""
    dim = dim % local.ndim
    shape = list(local.shape)
    shape[dim] = n
    full = local.new_zeros(shape)
    full.narrow(dim, lo, local.shape[dim]).copy_(local)
    return all_reduce(full, mesh, axis)


def barrier(mesh: Mesh, axis: str = MODEL_AXIS) -> None:
    """Wait for every rank of ``axis`` (a one-element sum)."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh, axis)
