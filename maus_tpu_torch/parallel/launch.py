"""Run one function on M ranks from one process.

The JAX API is single-controller: ``solve(A, b, mesh=mesh)`` is called once.
In the port every rank calls the same entry point with the same arguments.
:func:`run` starts ``world_size`` ranks with ``torch.multiprocessing.spawn``
(a ``FileStore`` in a temporary directory joins them), calls
``fn(mesh, *args, **kwargs)`` on each and returns rank 0's result. Under
``torchrun`` (``WORLD_SIZE`` set in the environment) this process already is
one rank: :func:`run` joins the group from the environment, returns this
rank's result, and leaves the group it joined. A rank that raises makes
the whole launch raise, and the other ranks are stopped.

``fn`` is pickled by reference, so it must be a module-level function;
rank 0's result travels back through ``torch.save``/``torch.load`` of a
file only this launch writes.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import (default_device, initialize_distributed, make_mesh,
                   resolve_backend)


def _rank_device(device, local_rank: int) -> torch.device:
    """This rank's device, made current before the rank joins the group
    (NCCL builds its communicators on the current device)."""
    dev = torch.device(device) if device is not None else default_device(local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _rank_main(rank: int, world_size: int, workdir: str, fn, args, kwargs,
               backend: str, device, replica: int,
               model: Optional[int]) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    dev = _rank_device(device, rank)
    initialize_distributed(backend, world_size=world_size, rank=rank,
                           device=device,
                           store=dist.FileStore(os.path.join(workdir, "store"),
                                                world_size))
    try:
        mesh = make_mesh(replica, model, device=dev)
        out = fn(mesh, *args, **kwargs)
        if rank == 0:
            path = os.path.join(workdir, "result.pt")
            torch.save(out, path + ".tmp")
            os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, *args, backend: Optional[str] = None,
        device=None, replica: int = 1, model: Optional[int] = None,
        **kwargs):
    """``fn(mesh, *args, **kwargs)`` on ``world_size`` ranks of a
    (replica, model) mesh (``model=None``: every rank the replica axis
    leaves); returns rank 0's result. ``backend``: ``None`` (NCCL, a card
    per rank) or ``"gloo"`` (ranks on the CPU or sharing a card);
    ``device``: every rank's device (default ``cuda:(rank % cards)``)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:       # under torchrun
        dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", "0")))
        joined = not dist.is_initialized()
        initialize_distributed(backend, device=device)
        try:
            return fn(make_mesh(replica, model, device=dev), *args, **kwargs)
        finally:
            if joined:
                # as a spawned rank does: a gloo group still alive when the
                # interpreter exits can abort the process there ("terminate
                # called without an active exception")
                dist.destroy_process_group()
    backend = resolve_backend(backend, world_size, device)
    with tempfile.TemporaryDirectory(prefix="maus_launch_") as workdir:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(world_size, workdir, fn, args, kwargs, backend, device,
                       replica, model))
        return torch.load(os.path.join(workdir, "result.pt"),
                          weights_only=False)
