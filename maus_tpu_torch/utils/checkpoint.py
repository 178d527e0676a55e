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
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.types import as_torch_dtype

FORMAT_VERSION = 1


def _items(node):
    if dataclasses.is_dataclass(node):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
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


def save_state(path: str, state) -> int:
    """Write ``state``'s tensor leaves to ``path`` (one ``.npz``, written
    to a temporary file and renamed over ``path``, so that a crash never
    leaves a torn checkpoint). Returns the leaf count."""
    leaves = _flatten(state)
    arrays = {name: x.detach().cpu().numpy() for name, x in leaves.items()}
    arrays["__version__"] = np.asarray(FORMAT_VERSION, np.int64)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return len(leaves)


def load_state(path: str, template, device=None):
    """The tree of ``template`` with the file's leaves, each on ``device``
    (default: the template leaf's own device; pass ``device`` when the
    template holds meta tensors)."""
    want = _flatten(template)
    with np.load(path, allow_pickle=False) as data:
        names = set(data.files)
        if "__version__" not in names or \
                int(data["__version__"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: not a checkpoint of format version "
                             f"{FORMAT_VERSION}")
        names.discard("__version__")
        if names != set(want):
            raise ValueError(
                f"checkpoint has {len(names)} leaves, template expects "
                f"{len(want)}; missing {sorted(set(want) - names)}, "
                f"unexpected {sorted(names - set(want))}")
        out = {}
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
    return _rebuild(template, out)
