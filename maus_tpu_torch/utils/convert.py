"""Carry solver state over from the JAX package.

:func:`carry_from_numpy` builds the port's
:class:`~maus_tpu_torch.solver.evolve.EvolveCarry` from the JAX package's
``EvolveCarry`` whose leaves were turned into numpy arrays (for example
``jax.tree.map(np.asarray, carry)``). It reads the leaves by attribute name
only, so this module imports nothing of the JAX package. The tests use it to
run both packages from identical state, since the two draw different random
numbers from the same seed. :func:`dist_qr_from_numpy` and
:func:`dist_hess_from_numpy` do the same for the mesh factors: a JAX
``DistQR``/``DistHess`` gathered to numpy becomes this rank's column shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Population, StrategyState
from ..ops.batched_solve import CholFactors, LUFactors, QRFactors
from ..ops.hessenberg import HessCache
from ..parallel.dist_hessenberg import DistHess
from ..parallel.dist_qr import DistQR
from ..parallel.mesh import column_range


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def keys_from_threefry(keys) -> np.ndarray:
    """Raw (K, 2) uint32 threefry keys → the port's (seed, counter) pairs:
    the two words form the slot's seed and the counter starts at 0."""
    keys = np.asarray(keys, np.uint64)
    out = np.zeros((keys.shape[0], 2), np.int64)
    out[:, 0] = (((keys[:, 0] << np.uint64(32)) | keys[:, 1])
                 >> np.uint64(1)).astype(np.int64)
    return out


def fac_from_numpy(fac, device):
    """``QRFactors`` (q, r, rinv), ``CholFactors`` (L) or ``LUFactors``
    (lu, piv with 0-based pivots, as ``jax.scipy.linalg.lu_factor`` gives
    them; torch's are 1-based)."""
    if fac is None:
        return None
    if hasattr(fac, "q"):
        rinv = getattr(fac, "rinv", None)
        return QRFactors(_t(fac.q, device), _t(fac.r, device),
                         None if rinv is None else _t(rinv, device))
    if hasattr(fac, "L"):
        return CholFactors(_t(fac.L, device))
    return LUFactors(_t(fac.lu, device),
                     _t(np.asarray(fac.piv).astype(np.int32) + 1, device))


def hess_from_numpy(cache, device=None) -> HessCache:
    """The port's ``HessCache`` from the JAX package's (fields ``h``, ``q``,
    numpy leaves)."""
    return HessCache(h=_t(cache.h, device).contiguous(), q=_t(cache.q, device))


def _shard(a, mesh, device) -> torch.Tensor:
    a = np.asarray(a)
    lo, hi = column_range(a.shape[1], mesh)
    return _t(a[:, lo:hi], device if device is not None else mesh.device).contiguous()


def dist_qr_from_numpy(fac, mesh, device=None) -> DistQR:
    """This rank's shards of a JAX ``DistQR`` (fields ``q``, ``r``, whole
    (N, N) numpy arrays)."""
    return DistQR(q=_shard(fac.q, mesh, device), r=_shard(fac.r, mesh, device))


def dist_hess_from_numpy(hess, mesh, device=None) -> DistHess:
    """This rank's shards of a JAX ``DistHess`` (fields ``h``, ``q``, whole
    (N, N) numpy arrays)."""
    return DistHess(h=_shard(hess.h, mesh, device), q=_shard(hess.q, mesh, device))


def eigh_from_numpy(cache, device=None):
    """The port's ``EighCache`` from the JAX package's (fields ``w``, ``V``,
    numpy leaves). Eigenvector phases differ between LAPACK builds, so a
    parity test hands both packages one decomposition."""
    from ..solver.hermitian import EighCache

    return EighCache(w=_t(cache.w, device), V=_t(cache.V, device))


def carry_from_numpy(leaves, device=None):
    """The port's ``EvolveCarry`` from the JAX package's carry with numpy
    leaves (fields ``pop``, ``strat``, ``fac``, ``psi_cached``,
    ``iteration``, ``best_residual``, ``stall_count``; ``refactor_psi`` is
    ignored). Every population field is carried, the SVD left vector
    ``pop.u`` included (``None`` outside SVD), and every strategy field,
    ``target_dynamic`` included. An eig or SVD carry has ``fac=None``."""
    from ..solver.evolve import EvolveCarry

    pop = leaves.pop
    fields = {}
    for f in dataclasses.fields(Population):
        val = getattr(pop, f.name, None)      # the port's ``slots``: None
        if f.name == "keys":
            val = keys_from_threefry(val)
        fields[f.name] = None if val is None else _t(val, device)
    strat = StrategyState(**{f.name: _t(getattr(leaves.strat, f.name), device)
                             for f in dataclasses.fields(StrategyState)})
    return EvolveCarry(
        pop=Population(**fields), strat=strat,
        fac=fac_from_numpy(leaves.fac, device),
        psi_cached=_t(np.float32(leaves.psi_cached), device),
        iteration=_t(np.int32(leaves.iteration), device),
        best_residual=_t(np.float32(leaves.best_residual), device),
        stall_count=_t(np.int32(leaves.stall_count), device))
