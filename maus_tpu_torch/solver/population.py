"""Population management — retire / prune / respawn as masked slot reuse.

Counterpart of ``maus_tpu/solver/population.py`` for linear systems: converged
duplicates and pruned candidates flip to RETIRED, and respawning
re-initializes RETIRED slots in place with fresh random iterates.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.types import (CandidateStatus, Population, ProblemType, SolverConfig,
                          StrategyState)
from .strategy import Diagnostics


def manage(cfg: SolverConfig, pop: Population, strat: StrategyState,
           diag: Diagnostics, target_solutions: int) -> Population:
    if cfg.problem_type != ProblemType.SOLVE_LINEAR_SYSTEM:
        raise NotImplementedError("only SOLVE_LINEAR_SYSTEM is ported")
    K = pop.capacity
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
    missing = torch.clamp_min(target_solutions - diag.num_distinct, 0)
    want = torch.clamp_min(n_retired, 0) + missing
    want = (want.to(torch.float32) * strat.spawn_rate).to(torch.int32)
    n_spawn = torch.minimum(want, n_retired)
    rank = torch.cumsum(retired.to(torch.int32), 0) - 1
    respawn = retired & (rank < n_spawn)

    # 4) re-initialize respawned slots; a slot draws only when it respawns
    keys = rng.advance(pop.keys)
    rows = torch.nonzero(respawn).flatten().tolist()
    v = pop.v
    if rows:
        fresh = rng.normal_rows(pop.keys, rows, v.shape[1], cfg.dtype, v.device)
        fresh = fresh / torch.linalg.vector_norm(fresh, dim=-1, keepdim=True)
        v = v.clone()
        v[rows] = fresh

    # spawned α gets the aggression boost, capped at 1 (computed in f32)
    spawn_alpha = torch.clamp_max(cfg.alpha_initial *
                                  (1.0 + strat.psi_aggression / 10.0),
                                  1.0).to(rdt)
    r = respawn

    def fill(val, like):
        return torch.where(r, torch.as_tensor(val, dtype=like.dtype,
                                              device=like.device), like)

    return dataclasses.replace(
        pop, v=v,
        weight=fill(0.01, pop.weight),
        alpha=torch.where(r, spawn_alpha, pop.alpha),
        stuck=fill(0, pop.stuck),
        status=torch.where(r, code(CandidateStatus.EXPLORING), status),
        residual=fill(float("inf"), pop.residual),
        prev_residual=fill(float("inf"), pop.prev_residual),
        psi_level=fill(0, pop.psi_level),
        keys=keys,
        retire_count=torch.where(r, pop.retire_count + 1, pop.retire_count))
