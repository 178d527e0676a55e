"""Population management — retire / prune / respawn as masked slot reuse.

Counterpart of ``maus_tpu/solver/population.py``: converged duplicates and
pruned candidates flip to RETIRED, and respawning re-initializes RETIRED
slots in place. A respawned linear slot takes a fresh random iterate; an SVD
slot fresh random unit vectors v and u and σ = 1, its spawn budget counted
against the dynamic effective-rank target. A respawned eig slot either
warm-starts near a claimed eigenpair (when the landscape is calm) or
explores: a fresh shift pushed away from the claimed eigenvalues and a
fresh vector deflated once against the claimed eigenvectors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.types import (CandidateStatus, Population, ProblemType, SolverConfig,
                          StrategyState)
from .strategy import Diagnostics

# independent per-slot draws of one respawn (the first, stream 0, is the
# fresh vector)
_PICK, _NOISE_V, _NOISE_LAM, _FRESH_LAM, _BUMP, _FRESH_U = 1, 2, 3, 4, 5, 6


def _eig_respawn(cfg: SolverConfig, pop: Population, diag: Diagnostics,
                 rows: list, fresh_v: torch.Tensor, lam_scale, lam_center):
    """(new_v, new_lam) of the respawned slots ``rows``: warm starts on even
    slots while a leader exists and the landscape energy is below 0.8,
    explorers otherwise."""
    dtype, rdt = cfg.dtype, cfg.real_dtype
    device = pop.v.device
    n = pop.v.shape[1]
    leader = diag.distinct_leader
    have_leader = bool(leader.any())
    lam_scale = torch.as_tensor(lam_scale, device=device).to(rdt)
    lam_center = torch.as_tensor(lam_center, device=device).to(dtype)

    # warm start: near a leader picked uniformly at random
    if have_leader:
        logits = torch.where(leader, 0.0, float("-inf")).to(torch.float32)
        picked = rng.categorical(pop.keys, rows, logits, stream=_PICK)
    else:
        picked = torch.zeros((len(rows),), dtype=torch.int64, device=device)
    scale = (0.1 + diag.landscape_energy).to(rdt)
    warm_v = pop.v[picked] + rng.normal_rows(pop.keys, rows, n, dtype, device,
                                             stream=_NOISE_V) * scale * 0.1
    warm_v = warm_v / torch.clamp_min(
        torch.linalg.vector_norm(warm_v, dim=-1, keepdim=True),
        torch.finfo(rdt).tiny)
    warm_lam = pop.lam[picked] + rng.normal_scalars(
        pop.keys, rows, dtype, device, stream=_NOISE_LAM) * scale * 0.05

    # explorers: fresh shifts over the spectral scale, bumped away from the
    # eigenvalues that leaders already claim
    fresh_lam = rng.normal_scalars(pop.keys, rows, dtype, device,
                                   stream=_FRESH_LAM) * lam_scale.to(dtype) \
        + lam_center
    lam_claimed = torch.where(leader, pop.lam, torch.full_like(
        pop.lam, complex(float("inf"), 0.0)))
    min_dist = (fresh_lam[:, None] - lam_claimed[None, :]).abs().amin(dim=-1)
    too_close = min_dist < 0.05 * lam_scale
    bump = rng.normal_scalars(pop.keys, rows, dtype, device, stream=_BUMP)
    bump = bump / torch.clamp_min(bump.abs(), 1e-30) * 0.2 * lam_scale.to(dtype)
    fresh_lam = torch.where(too_close, fresh_lam + bump, fresh_lam)
    # a one-time deflation against the claimed eigenvectors, so inverse
    # iteration first amplifies unclaimed components
    Vc = pop.v * leader.to(dtype)[:, None]
    coeff = Vc.conj() @ fresh_v.T                      # (K, R)
    fresh_defl = fresh_v - coeff.T @ Vc
    nrm = torch.linalg.vector_norm(fresh_defl, dim=-1, keepdim=True)
    fresh_v = torch.where(nrm > 1e-6, fresh_defl / torch.clamp_min(nrm, 1e-30),
                          fresh_v)

    slot_parity = (torch.tensor(rows, device=device) % 2) == 0
    use_warm = (diag.landscape_energy < 0.8) & slot_parity & have_leader
    return (torch.where(use_warm[:, None], warm_v, fresh_v),
            torch.where(use_warm, warm_lam, fresh_lam))


def manage(cfg: SolverConfig, pop: Population, strat: StrategyState,
           diag: Diagnostics, target_solutions: int,
           lam_scale=1.0, lam_center=0.0) -> Population:
    rdt = cfg.real_dtype
    i8 = torch.int8

    def code(c):
        return torch.tensor(int(c), dtype=i8, device=pop.status.device)

    # 1) retire converged duplicates (the per-class leader stays)
    status = torch.where(diag.duplicate, code(CandidateStatus.RETIRED), pop.status)
    # 2) prune: weight below floor or stuck at cap, unless converged
    conv = status == CandidateStatus.CONVERGED
    prune = (~conv) & ((pop.weight < cfg.min_weight) |
                       (pop.stuck >= cfg.max_stuck_for_retirement))
    status = torch.where(prune, code(CandidateStatus.RETIRED), status)

    # 3) spawn budget: restore the population plus one explorer per missing
    # distinct solution, scaled by the spawn rate
    retired = status == CandidateStatus.RETIRED
    n_retired = torch.sum(retired.to(torch.int32))
    target = diag.target_dynamic if cfg.problem_type == ProblemType.SVD \
        else target_solutions
    missing = torch.clamp_min(target - diag.num_distinct, 0)
    want = torch.clamp_min(n_retired, 0) + missing
    want = (want.to(torch.float32) * strat.spawn_rate).to(torch.int32)
    n_spawn = torch.minimum(want, n_retired)
    rank = torch.cumsum(retired.to(torch.int32), 0) - 1
    respawn = retired & (rank < n_spawn)

    # 4) re-initialize respawned slots; a slot draws only when it respawns
    keys = rng.advance(pop.keys)
    rows = torch.nonzero(respawn).flatten().tolist()
    v, u, lam = pop.v, pop.u, pop.lam
    if rows:
        fresh = rng.normal_rows(pop.keys, rows, v.shape[1], cfg.dtype, v.device)
        fresh = fresh / torch.linalg.vector_norm(fresh, dim=-1, keepdim=True)
        if cfg.problem_type == ProblemType.EIGENVALUE:
            fresh, fresh_lam = _eig_respawn(cfg, pop, diag, rows, fresh,
                                            lam_scale, lam_center)
        else:
            fresh_lam = torch.full((len(rows),),
                                   1.0 if cfg.problem_type == ProblemType.SVD
                                   else 0.0, dtype=lam.dtype, device=lam.device)
        v, lam = v.clone(), lam.clone()
        v[rows] = fresh
        lam[rows] = fresh_lam
        if u is not None:
            fresh_u = rng.normal_rows(pop.keys, rows, u.shape[1], cfg.dtype,
                                      u.device, stream=_FRESH_U)
            u = u.clone()
            u[rows] = fresh_u / torch.linalg.vector_norm(fresh_u, dim=-1,
                                                          keepdim=True)

    # spawned α gets the aggression boost, capped at 1 (computed in f32)
    spawn_alpha = torch.clamp_max(cfg.alpha_initial *
                                  (1.0 + strat.psi_aggression / 10.0),
                                  1.0).to(rdt)
    r = respawn

    def fill(val, like):
        return torch.where(r, torch.as_tensor(val, dtype=like.dtype,
                                              device=like.device), like)

    return dataclasses.replace(
        pop, v=v, u=u, lam=lam,
        weight=fill(0.01, pop.weight),
        alpha=torch.where(r, spawn_alpha, pop.alpha),
        stuck=fill(0, pop.stuck),
        status=torch.where(r, code(CandidateStatus.EXPLORING), status),
        residual=fill(float("inf"), pop.residual),
        prev_residual=fill(float("inf"), pop.prev_residual),
        psi_level=fill(0, pop.psi_level),
        keys=keys,
        retire_count=torch.where(r, pop.retire_count + 1, pop.retire_count))
