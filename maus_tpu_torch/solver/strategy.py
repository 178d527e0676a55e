"""Global diagnostics and strategy adaptation.

Counterpart of ``maus_tpu/solver/strategy.py`` (``compute_diagnostics``,
``adjust_strategy``). The distinct-solution registry is one K×K 'same
solution' matrix; the leader election over it is sequential in priority
order, so it runs on the host over the K×K boolean matrix (K is the
population size, 16 or 32 on the headline problems). An SVD run also
re-derives its target, the effective rank, from the converged σ spectrum
every iteration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import (CandidateStatus, Population, ProblemType, SolverConfig,
                          StabilityState, StrategyState)


@dataclasses.dataclass
class Diagnostics:
    distinct_leader: torch.Tensor   # (K,) bool — converged and first of its class
    duplicate: torch.Tensor         # (K,) bool — converged but redundant
    num_distinct: torch.Tensor      # i32
    avg_residual: torch.Tensor      # f32
    avg_stuckness: torch.Tensor     # f32
    landscape_energy: torch.Tensor  # f32
    stability: torch.Tensor         # i32
    target_dynamic: torch.Tensor    # i32


def _pairwise_same(cfg: SolverConfig, pop: Population) -> torch.Tensor:
    """K×K 'same solution' matrix.

    * eig: |Δλ| < λ_tol + |λ|·1e-6 + 4·(r_i + r_j) and |⟨v_i, v_j⟩| > 0.999.
      The residual band covers the value noise of two backward-stable
      approximations of one eigenpair (~κ·(r_i + r_j), Bauer–Fike); the
      vector overlap keeps clustered spectra unmerged.
    * linear: ‖x_i − x_j‖ < 100·tol, from the differences themselves. The
      JAX package takes ‖x_i‖² + ‖x_j‖² − 2·Re⟨x_i, x_j⟩ from one Gram
      matrix, whose cancellation noise in the working dtype (~ε·‖x‖², 1e7
      for ‖x‖ ≈ 1e7 at κ = 1e6 in complex64) swamps the 1e-12 threshold, so
      identical candidates count as distinct there; here they count as one
      (a recorded divergence, ROADMAP Queue 3).
    * SVD: |Δσ| < max(σ_abs, σ·σ_rel) + the same residual band, and both
      |⟨u_i, u_j⟩| and |⟨v_i, v_j⟩| > 0.999 (overlaps and |Δσ| carry no
      cancellation, so the JAX package's rule stands as it is)."""
    if cfg.problem_type in (ProblemType.EIGENVALUE, ProblemType.SVD):
        gram_v = (pop.v.conj() @ pop.v.T).abs()
        r_eff = torch.where(torch.isfinite(pop.residual), pop.residual,
                            torch.zeros_like(pop.residual))
        band = 4.0 * (r_eff[:, None] + r_eff[None, :])
        if cfg.problem_type == ProblemType.SVD:
            sig = pop.lam.real
            dsig = (sig[:, None] - sig[None, :]).abs()
            tol = torch.clamp_min(sig[None, :] * cfg.sigma_similarity_rel,
                                  cfg.sigma_similarity_abs) + band
            gram_u = (pop.u.conj() @ pop.u.T).abs()
            return (dsig < tol) & (gram_u > cfg.vector_similarity_tol) & \
                (gram_v > cfg.vector_similarity_tol)
        dlam = (pop.lam[:, None] - pop.lam[None, :]).abs()
        tol = cfg.lambda_similarity_tol + pop.lam.abs()[None, :] * 1e-6 + band
        return (dlam < tol) & (gram_v > cfg.vector_similarity_tol)
    X = torch.view_as_real(pop.v.resolve_conj()).reshape(pop.v.shape[0], -1)
    d = torch.cdist(X, X, compute_mode="donot_use_mm_for_euclid_dist")
    return d < cfg.tol * 100


def _svd_leaders_and_target(cfg: SolverConfig, pop: Population,
                            strat: StrategyState, conv: torch.Tensor,
                            leader: torch.Tensor):
    """(leaders, target) of an SVD population.

    A σ below σ_rel × the largest converged σ is not a distinct triplet,
    unless it is a null vector (σ = 0). The target is the effective rank
    read from the converged spectrum: the leaders above rank_rel_cut·σ_max
    once a σ below that cut has converged (the noise floor is reached), one
    more than that until then (capped at min(K, M, N)); with no leader yet
    the previous target stands. When every triplet of an exact low-rank
    operand is found before a below-cut σ converges, the target stays one
    above the rank: the JAX package's behaviour, reproduced for parity."""
    sig = pop.lam.real
    zero = torch.zeros_like(sig)
    max_sig = torch.clamp_min(torch.max(torch.where(conv, sig, zero)), 1e-30)
    tiny = (sig < max_sig * cfg.sigma_similarity_rel) & (sig > 0.0)
    leader = leader & ~tiny
    cap = min(pop.capacity, pop.u.shape[1], pop.v.shape[1])
    smax_l = torch.max(torch.where(leader, sig, zero))
    cut = smax_l * cfg.rank_rel_cut
    rank_det = torch.sum(leader & (sig > cut)).to(torch.int32)
    floor_found = torch.any(conv & (sig < cut))
    tgt = torch.where(floor_found, rank_det, torch.clamp_max(rank_det + 1, cap))
    target = torch.where(smax_l > 0.0, tgt, strat.target_dynamic)
    return leader, target.to(torch.int32)


def compute_diagnostics(cfg: SolverConfig, pop: Population, strat: StrategyState,
                        target_solutions: int) -> Diagnostics:
    K = pop.capacity
    device = pop.v.device
    conv = pop.status == CandidateStatus.CONVERGED
    retired = pop.status == CandidateStatus.RETIRED
    nonconv_active = ~conv & ~retired

    # Leader election among converged duplicates, sequential in priority
    # order (lowest residual first, ties by slot index): a candidate leads iff
    # it is not similar to an already accepted leader.
    same_h = _pairwise_same(cfg, pop).cpu().numpy()
    conv_h = conv.cpu().numpy()
    res_h = pop.residual.cpu().numpy()
    prio = np.where(np.isfinite(res_h), res_h, np.inf)
    order = np.lexsort((np.arange(K), np.where(conv_h, prio, np.inf)))
    leader_h = np.zeros(K, bool)
    for i in order:
        leader_h[i] = conv_h[i] and not np.any(same_h[i] & leader_h)
    leader = torch.from_numpy(leader_h).to(device)
    # duplicates are decided before the SVD tiny-σ exclusion: a tiny-σ
    # leader leaves the count but is not a duplicate to retire
    duplicate = conv & ~leader
    if cfg.problem_type == ProblemType.SVD:
        leader, target_dynamic = _svd_leaders_and_target(cfg, pop, strat,
                                                         conv, leader)
    else:
        target_dynamic = torch.tensor(target_solutions, dtype=torch.int32,
                                      device=device)
    num_distinct = torch.sum(leader).to(torch.int32)

    # averages over non-converged, non-retired candidates; a non-finite
    # residual counts as 100× the current threshold
    res_eff = torch.where(torch.isfinite(pop.residual), pop.residual,
                          strat.threshold * 100.0)
    denom = torch.clamp_min(torch.sum(nonconv_active), 1)
    avg_res = torch.sum(torch.where(nonconv_active, res_eff,
                                    torch.zeros_like(res_eff))) / denom
    avg_stuck = torch.sum(torch.where(nonconv_active, pop.stuck,
                                      torch.zeros_like(pop.stuck))
                          ).to(torch.float32) / denom

    norm_missing = torch.clamp_min(target_dynamic - num_distinct, 0) \
        .to(torch.float32) / torch.clamp_min(target_dynamic, 1).to(torch.float32)
    norm_res = avg_res / (strat.threshold * 10.0)
    norm_stuck = avg_stuck / (cfg.max_stuck_for_retirement * 2.0)
    energy = torch.clamp(0.4 * norm_res + 0.3 * norm_stuck + 0.3 * norm_missing,
                         0.0, 1.0)

    i32 = torch.int32
    stability = torch.where(
        avg_stuck > cfg.max_stuck_for_retirement * 0.5,
        torch.tensor(int(StabilityState.CRITICAL), dtype=i32, device=device),
        torch.where(avg_stuck > cfg.max_stuck_for_pruning * 0.5,
                    torch.tensor(int(StabilityState.FRAGILE), dtype=i32,
                                 device=device),
                    torch.tensor(int(StabilityState.STABLE), dtype=i32,
                                 device=device)))

    return Diagnostics(distinct_leader=leader, duplicate=duplicate,
                       num_distinct=num_distinct,
                       avg_residual=avg_res.to(torch.float32),
                       avg_stuckness=avg_stuck.to(torch.float32),
                       landscape_energy=energy.to(torch.float32),
                       stability=stability, target_dynamic=target_dynamic)


def adjust_strategy(cfg: SolverConfig, strat: StrategyState,
                    diag: Diagnostics) -> StrategyState:
    """The three-regime controller: high energy + Critical → escalate;
    mid energy + Fragile → mild escalation; low energy + Stable → relax.
    The solver preference is not regime-forced (failover drives it)."""
    energy, stab = diag.landscape_energy, diag.stability
    hot = (energy > 0.6) & (stab == StabilityState.CRITICAL)
    warm = (energy > 0.4) & (stab == StabilityState.FRAGILE) & ~hot
    cool = (energy < 0.2) & (stab == StabilityState.STABLE)

    psi, spawn, thr = strat.psi_aggression, strat.spawn_rate, strat.threshold
    tol = torch.tensor(cfg.tol, dtype=torch.float32, device=psi.device)
    where = torch.where

    psi = where(hot, torch.clamp_max(psi * 1.1, 200.0),
          where(warm, torch.clamp_max(psi * 1.05, 50.0),
          where(cool, torch.clamp_min(psi * 0.9, 1.0), psi)))
    spawn = where(hot, torch.clamp_max(spawn * 1.2, 10.0),
            where(warm, torch.clamp_max(spawn * 1.1, 5.0),
            where(cool, torch.clamp_min(spawn * 0.9, 0.01), spawn)))
    thr = where(hot, torch.maximum(tol * 50.0, thr * 1.05),
          where(warm, torch.maximum(tol * 5.0, thr * 1.02),
          where(cool, torch.maximum(tol, thr * 0.9), thr)))

    psi = torch.clamp(psi, 1.0, 200.0)
    spawn = torch.clamp(spawn, 0.01, 10.0)
    thr = torch.minimum(torch.maximum(thr, tol), torch.ones_like(thr))

    return dataclasses.replace(
        strat, psi_aggression=psi, spawn_rate=spawn, threshold=thr,
        stability=diag.stability, landscape_energy=diag.landscape_energy,
        avg_residual=diag.avg_residual, avg_stuckness=diag.avg_stuckness,
        num_distinct=diag.num_distinct, target_dynamic=diag.target_dynamic)
