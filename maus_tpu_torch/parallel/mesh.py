"""The device mesh over ``torch.distributed`` ranks.

Counterpart of ``maus_tpu/parallel/mesh.py``. The JAX package names two
axes over its devices: ``replica`` (the candidate population) and ``model``
(the matrix dimension, operands sharded by column). Here every rank is one
process with one device; ``make_mesh(replica, model)`` lays the ranks out
row-major, ``rank = replica_index · model + model_index`` (the JAX
``reshape(replica, model)``), and builds one process group per axis, so a
collective over one axis reaches exactly the ranks that share the other
axis's index.

The collective backend is always the caller's, never guessed: NCCL, the
default on CUDA, needs a card per rank; ranks that share a card, and every
CPU run, name ``gloo``. A rank's device is ``cuda:(local_rank %
device_count)`` unless the caller passes ``device=``; the CPU only when
asked for, as for the rest of the port.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

REPLICA_AXIS = "replica"
MODEL_AXIS = "model"
# how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(seconds=900)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a (replica, model) mesh: its global rank, its
    device, the process group of each axis it belongs to (``None`` for an
    axis of size 1) and the collective backend."""

    replica: int
    model: int
    rank: int
    device: torch.device
    groups: dict
    backend: Optional[str] = None

    @property
    def shape(self) -> dict:
        return {REPLICA_AXIS: self.replica, MODEL_AXIS: self.model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == REPLICA_AXIS \
            else self.rank % self.model

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` with this rank's
        coordinate on the other axis."""
        if axis == REPLICA_AXIS:
            return index * self.model + self.index(MODEL_AXIS)
        return self.index(REPLICA_AXIS) * self.model + index


def default_device(local_rank: int = 0) -> torch.device:
    """``cuda:(local_rank % device_count)``; without a card this raises, as
    the port's entry points do (pass ``device="cpu"`` for a CPU run)."""
    if not torch.cuda.is_available():
        raise RuntimeError('maus_tpu_torch runs on a CUDA card by default and '
                           'none is available; pass device="cpu" to run on '
                           'the CPU')
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def resolve_backend(backend: Optional[str], ranks_on_host: int,
                    device=None) -> str:
    """The caller's backend, checked: ``None`` means NCCL, which needs a
    CUDA card for each rank. Ranks that would share a card, or run on the
    CPU, raise ``ValueError`` unless the caller names ``gloo``."""
    backend = "nccl" if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        dev = torch.device(device) if device is not None else None
        if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
            raise ValueError("NCCL runs only between CUDA cards; pass "
                             "backend='gloo' for ranks on the CPU")
        if ranks_on_host > torch.cuda.device_count() or \
                (dev is not None and dev.index is not None and ranks_on_host > 1):
            raise ValueError(
                f"NCCL refuses two ranks on one GPU: {ranks_on_host} ranks, "
                f"{torch.cuda.device_count()} card(s) on this host; pass "
                f"backend='gloo' to let ranks share a card")
    return backend


def initialize_distributed(backend: Optional[str] = None, *, init_method=None,
                           store=None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, device=None) -> str:
    """Join the process group (``torch.distributed.init_process_group``)
    with the backend :func:`resolve_backend` allows. A no-op when this
    process already belongs to one. Under ``torchrun`` the arguments come
    from the environment (``init_method="env://"``). Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = resolve_backend(backend, on_host, device)
    kwargs = {} if store is None else {"store": store}
    if store is None:
        kwargs["init_method"] = init_method or "env://"
    dist.init_process_group(backend, world_size=world_size, rank=rank,
                            timeout=TIMEOUT, **kwargs)
    return backend


def single_device_mesh(device=None) -> Mesh:
    """The trivial 1×1 mesh of this process's own device."""
    dev = torch.device(device) if device is not None else default_device()
    return Mesh(replica=1, model=1, rank=0, device=dev, groups={})


def make_mesh(replica: int = 1, model: Optional[int] = None,
              device=None) -> Mesh:
    """Build this rank's (replica, model) mesh over the initialized process
    group (every rank must call it, in the same order: it creates the axis
    groups). ``model=None`` takes every rank the replica axis leaves."""
    if not dist.is_initialized():
        if replica * (model or 1) != 1:
            raise ValueError(f"a {replica}×{model} mesh needs an initialized "
                             f"process group (initialize_distributed)")
        return single_device_mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model is None:
        if world % replica != 0:
            raise ValueError(f"{world} ranks not divisible by replica={replica}")
        model = world // replica
    if replica * model != world:
        raise ValueError(f"mesh {replica}x{model} needs {replica * model} "
                         f"ranks, have {world}")
    groups = {}
    layouts = ((MODEL_AXIS, model,
                [[r * model + i for i in range(model)] for r in range(replica)]),
               (REPLICA_AXIS, replica,
                [[r * model + i for r in range(replica)] for i in range(model)]))
    for axis, size, members in layouts:
        for ranks in members:
            group = dist.new_group(ranks) if size > 1 else None
            if rank in ranks:
                groups[axis] = group
    dev = torch.device(device) if device is not None else default_device(local_rank())
    return Mesh(replica=replica, model=model, rank=rank, device=dev,
                groups=groups, backend=dist.get_backend())


def column_range(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's columns ``[lo, hi)`` of an N-column operand sharded over
    the model axis; N must be divisible by the model size, as the JAX
    mesh paths require."""
    m = mesh.size(MODEL_AXIS)
    if n % m != 0:
        raise ValueError(f"N={n} must be divisible by the model axis ({m})")
    c = n // m
    lo = mesh.index(MODEL_AXIS) * c
    return lo, lo + c
