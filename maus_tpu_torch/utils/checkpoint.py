"""Checkpoint and resume of the solver's state.

Counterpart of ``maus_tpu/utils/checkpoint.py``. The whole state of a run
is one tree of dataclasses (``solver/evolve.EvolveCarry``: the population
with its per-slot random streams, the strategy, the carried factorization,
the counters), so a checkpoint is a flat dump of its tensors and resuming is
re-entering the loop with the loaded tree.

Format: one ``.npz`` holding ``__version__`` and one array per tensor leaf,
named by its field path (``pop.v``, ``fac.q``, ``stall_count``); ``None``
leaves are not stored. Complex leaves are stored as they are (the JAX
package splits them into re/im planes because the TPU runtime cannot move
complex data across its host boundary). Nothing is pickled: the file is
written with ``np.savez`` and read with ``allow_pickle=False``. Loading
needs a template of the same structure, whose leaves may be meta tensors:
any difference in leaf names, count, shape or dtype raises ``ValueError``,
and nothing is cast.

A mesh run's carry (``save_state(..., mesh=)``) holds column-sharded leaves
(the ``DistQR`` factors of the linear path, a ``DistHess``: any dataclass
with ``sharded = True``). Its checkpoint is PyTorch's idiom, per-rank shard
files plus a manifest: ``path`` holds the replicated leaves and the model
size; ``path.shard{i}`` holds the (N, N/m) shards of model index i. Each
rank writes and reads only its own shard, so no rank ever holds a whole
(N, N) leaf, and a resume is bit-exact. A file from another model size, a
single-device file given to a mesh load and a mesh file given to a
single-device load are refused with ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.types import as_torch_dtype

FORMAT_VERSION = 1
MESH_KEY = "__mesh_model__"


def _items(node):
    """A node's children by name; a dataclass field whose metadata says
    ``checkpoint: False`` (a population's replica placement) is not state
    and is left out, so a loaded tree keeps the template's value."""
    if dataclasses.is_dataclass(node):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)
                if f.metadata.get("checkpoint", True)]
    if isinstance(node, dict):
        return list(node.items())
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _flatten(node, prefix: str = "") -> dict:
    """{field path: tensor} over the tree's tensor leaves."""
    if node is None:
        return {}
    if isinstance(node, torch.Tensor):
        return {prefix: node}
    out = {}
    for key, val in _items(node):
        out.update(_flatten(val, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _sharded_names(node, prefix: str = "", inside: bool = False) -> set:
    """Field paths of the tensor leaves under a node marked ``sharded``."""
    if node is None:
        return set()
    if isinstance(node, torch.Tensor):
        return {prefix} if inside else set()
    inside = inside or getattr(type(node), "sharded", False)
    out = set()
    for key, val in _items(node):
        out |= _sharded_names(val, f"{prefix}.{key}" if prefix else str(key),
                              inside)
    return out


def _write(path: str, arrays: dict, tag: str = "") -> None:
    """``np.savez`` to a temporary file renamed over ``path``."""
    arrays["__version__"] = np.asarray(FORMAT_VERSION, np.int64)
    tmp = f"{path}.tmp{tag}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def shard_path(path: str, index: int) -> str:
    """The shard file of model index ``index`` of a mesh checkpoint."""
    return f"{path}.shard{index}"


def _rebuild(node, leaves: dict, prefix: str = ""):
    """The template ``node`` with each tensor leaf replaced from ``leaves``."""
    if node is None:
        return None
    if isinstance(node, torch.Tensor):
        return leaves[prefix]
    vals = {key: _rebuild(val, leaves, f"{prefix}.{key}" if prefix else str(key))
            for key, val in _items(node)}
    return dataclasses.replace(node, **vals) if dataclasses.is_dataclass(node) \
        else type(node)(vals)


def _mesh_model(mesh) -> int:
    return 1 if mesh is None else mesh.size("model")


def save_state(path: str, state, mesh=None) -> int:
    """Write ``state``'s tensor leaves to ``path`` (one ``.npz``, written
    to a temporary file and renamed over ``path``, so that a crash never
    leaves a torn checkpoint). Returns the leaf count. With a ``mesh`` of
    model size m > 1 every rank calls it: the first rank of the model axis
    writes the manifest and each rank its shard file, and the call returns
    once every rank of the axis has written."""
    leaves = _flatten(state)
    arrays = {name: x.detach().cpu().numpy() for name, x in leaves.items()}
    m = _mesh_model(mesh)
    if m == 1:
        _write(path, arrays)
        return len(leaves)
    from ..parallel import comm

    sharded = _sharded_names(state)
    me = mesh.index("model")
    tag = str(mesh.rank)
    _write(shard_path(path, me), {MESH_KEY: np.asarray(m, np.int64),
                                  **{k: arrays[k] for k in sharded}}, tag)
    if me == 0:
        _write(path, {MESH_KEY: np.asarray(m, np.int64),
                      **{k: v for k, v in arrays.items() if k not in sharded}},
               tag)
    comm.barrier(mesh)
    return len(leaves)


def _read(path: str, want: dict, m: int, device, out: dict) -> None:
    """Check the file at ``path`` against the template leaves ``want``
    (and the model size ``m``; 1 for a single-device file) and load them
    into ``out``."""
    with np.load(path, allow_pickle=False) as data:
        names = set(data.files)
        if "__version__" not in names or \
                int(data["__version__"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: not a checkpoint of format version "
                             f"{FORMAT_VERSION}")
        names.discard("__version__")
        saved_m = int(data[MESH_KEY]) if MESH_KEY in names else 1
        names.discard(MESH_KEY)
        if saved_m != m:
            raise ValueError(
                f"{path}: a checkpoint of a model axis of {saved_m} "
                f"({'single-device' if saved_m == 1 else 'mesh'} format), "
                f"loaded on a model axis of {m}")
        if names != set(want):
            raise ValueError(
                f"checkpoint has {len(names)} leaves, template expects "
                f"{len(want)}; missing {sorted(set(want) - names)}, "
                f"unexpected {sorted(names - set(want))}")
        for name, leaf in want.items():
            got = data[name]
            got_dtype = as_torch_dtype(got.dtype)
            if got_dtype != leaf.dtype:
                raise ValueError(f"leaf {name}: checkpoint dtype {got_dtype} != "
                                 f"template {leaf.dtype}; refusing to cast")
            if tuple(got.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {name}: checkpoint shape "
                                 f"{tuple(got.shape)} != template "
                                 f"{tuple(leaf.shape)}")
            out[name] = torch.from_numpy(got).to(
                device if device is not None else leaf.device)


def load_state(path: str, template, device=None, mesh=None):
    """The tree of ``template`` with the file's leaves, each on ``device``
    (default: the template leaf's own device; pass ``device`` when the
    template holds meta tensors). With a ``mesh`` of model size m > 1 the
    template's sharded leaves have this rank's shard shapes, each rank
    reads the manifest and its own shard file, and ``device`` defaults to
    the mesh's."""
    want = _flatten(template)
    if device is None and mesh is not None:
        device = mesh.device
    m = _mesh_model(mesh)
    out = {}
    if m == 1:
        _read(path, want, 1, device, out)
    else:
        sharded = _sharded_names(template)
        _read(path, {k: v for k, v in want.items() if k not in sharded}, m,
              device, out)
        _read(shard_path(path, mesh.index("model")),
              {k: v for k, v in want.items() if k in sharded}, m, device, out)
    return _rebuild(template, out)
