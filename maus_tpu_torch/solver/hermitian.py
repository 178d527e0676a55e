"""The Hermitian eigenproblem's two steps.

Counterpart of ``maus_tpu/solver/hermitian.py``. Up to ``cfg.eigh_max_n``
(dense input) one shared ``torch.linalg.eigh`` is taken once per evolve and
every active candidate snaps to the eigenpair its vector overlaps most among
those no converged candidate owns (:func:`step_hermitian`), so respawned
candidates land on unclaimed eigenpairs and the population covers the
spectrum in ⌈N/K⌉ rounds. Beyond it, or for sparse input, each candidate
runs a batched Lanczos from its own vector, deflated against the converged
vectors, and takes its best unclaimed Ritz pair
(:func:`step_hermitian_lanczos`; the reference's ARPACK ``eigsh`` branch).
On a population placed over replica ranks (``parallel/placement``) the
claim sets and the deflation basis come from the whole population, and the
snaps and Lanczos runs from the rank's slots only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.types import CandidateStatus, Population, SolverConfig, StrategyState
from ..ops.lanczos import lanczos_batched
from ..parallel.placement import on_slots
from ..utils.precision import full_precision
from .candidate import StepStats


class EighCache(NamedTuple):
    """Shared spectral decomposition of the Hermitian operand."""

    w: torch.Tensor    # (N,) real eigenvalues, ascending
    V: torch.Tensor    # (N, N) eigenvectors in columns


def eigh_setup(A: torch.Tensor) -> EighCache:
    with full_precision():
        w, V = torch.linalg.eigh(A)
    return EighCache(w=w, V=V)


def _no_stats(device) -> StepStats:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return StepStats(solve_fail_frac=zero, regress_frac=zero)


def _anorm(cfg: SolverConfig, A: torch.Tensor) -> torch.Tensor:
    """‖A‖_F/√N in the working real dtype: eig residuals are absolute."""
    return (torch.linalg.vector_norm(A) / A.shape[0] ** 0.5).to(cfg.real_dtype)


def _status(pop: Population, take: torch.Tensor,
            good: torch.Tensor) -> torch.Tensor:
    """CONVERGED where ``good``, else REFINING where ``take``, else kept."""
    conv = torch.tensor(int(CandidateStatus.CONVERGED), dtype=pop.status.dtype,
                        device=pop.status.device)
    refining = torch.tensor(int(CandidateStatus.REFINING),
                            dtype=pop.status.dtype, device=pop.status.device)
    return torch.where(good, conv, torch.where(take, refining, pop.status))


def step_hermitian(cfg: SolverConfig, A: torch.Tensor, cache: EighCache,
                   pop: Population, strat: StrategyState
                   ) -> tuple[Population, StepStats]:
    """Snap every active candidate to its best *unclaimed* eigenpair."""
    N = cache.w.shape[0]
    conv = pop.status == CandidateStatus.CONVERGED
    retired = pop.status == CandidateStatus.RETIRED
    active = ~conv & ~retired

    # the eigenpair each converged candidate owns: the nearest eigenvalue;
    # an eigenpair is claimed when any converged candidate owns it (a
    # scatter-max, since a plain indexed write keeps the last write)
    dist = (pop.lam.real[:, None] - cache.w[None, :]).abs()            # (K, N)
    owned_idx = torch.argmin(dist, dim=-1)                              # (K,)
    claimed = torch.zeros(N, dtype=torch.int32, device=A.device).scatter_reduce(
        0, owned_idx, conv.to(torch.int32), "amax") > 0                 # (N,)
    any_unclaimed = (~claimed).any()

    def snap_to(p: Population):
        overlap = (p.v @ cache.V.conj()).abs()                          # (K, N)
        overlap = torch.where(claimed[None, :], float("-inf"), overlap)
        snap = torch.argmax(overlap, dim=-1)                            # (K,)
        v_new = cache.V[:, snap].T                                      # (K, N)
        lam_new = cache.w[snap].to(cfg.dtype)
        resid = torch.linalg.vector_norm(v_new @ A.T - lam_new[:, None] * v_new,
                                         dim=-1).to(cfg.real_dtype)
        return v_new, lam_new, resid

    v_new, lam_new, resid = on_slots(pop, snap_to)
    thresh_eff = torch.clamp_min(strat.threshold, cfg.convergence_floor) \
        * _anorm(cfg, A)

    take = active & any_unclaimed
    pop = dataclasses.replace(
        pop,
        v=torch.where(take[:, None], v_new, pop.v),
        lam=torch.where(take, lam_new, pop.lam),
        residual=torch.where(take, resid, pop.residual),
        prev_residual=torch.where(take, pop.residual, pop.prev_residual),
        weight=torch.where(take, torch.ones_like(pop.weight), pop.weight),
        stuck=torch.where(take, torch.zeros_like(pop.stuck), pop.stuck),
        status=_status(pop, take, take & (resid < thresh_eff)))
    return pop, _no_stats(A.device)


def step_hermitian_lanczos(cfg: SolverConfig, A: torch.Tensor, pop: Population,
                           strat: StrategyState, k: int = 6, m: int = 32
                           ) -> tuple[Population, StepStats]:
    """Each candidate runs an m-step Lanczos from its own vector, deflated
    against the converged candidates' vectors, so successive respawn waves
    converge to successive unclaimed extremal eigenpairs instead of
    re-finding the dominant ones."""
    N = A.shape[0]
    k = min(k, N - 1)
    conv = pop.status == CandidateStatus.CONVERGED
    retired = pop.status == CandidateStatus.RETIRED
    active = ~conv & ~retired

    Vc = pop.v * conv.to(cfg.dtype)[:, None]
    # a Ritz pair is claimed when a converged candidate already owns its
    # eigenvalue (the duplicate rule's value tolerance)
    lam_conv = torch.where(conv, pop.lam.real, float("inf"))            # (K,)

    def run(p: Population):
        coeff = Vc.conj() @ p.v.T                                       # (K, K)
        v0 = p.v - coeff.T @ Vc
        norms = torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
        v0 = torch.where(norms > 1e-6, v0 / torch.clamp_min(norms, 1e-30), p.v)

        res = lanczos_batched(A, v0, k=k, m=m)
        dist = (res.eigenvalues[:, :, None] - lam_conv[None, None, :]).abs()
        tol_eff = cfg.lambda_similarity_tol + \
            res.eigenvalues.abs()[:, :, None] * 1e-6
        is_claimed = (dist < tol_eff).any(dim=-1)                       # (K, k)

        # the best unclaimed Ritz pair per candidate (lowest residual)
        score = res.residuals + torch.where(is_claimed, 1e30, 0.0)
        pick = torch.argmin(score, dim=-1)                              # (K,)
        rows = torch.arange(p.capacity, device=A.device)
        return (res.eigenvectors[rows, pick],                           # (K, N)
                res.eigenvalues[rows, pick].to(cfg.dtype),
                res.residuals[rows, pick].to(cfg.real_dtype),
                (~is_claimed).any(dim=-1))

    v_new, lam_new, resid_new, any_unclaimed = on_slots(pop, run)
    take = active & any_unclaimed & torch.isfinite(resid_new)
    good = take & (resid_new < torch.clamp_min(strat.threshold,
                                               cfg.convergence_floor)
                   * _anorm(cfg, A))
    pop = dataclasses.replace(
        pop,
        v=torch.where(take[:, None], v_new, pop.v),
        lam=torch.where(take, lam_new, pop.lam),
        residual=torch.where(take, resid_new, pop.residual),
        prev_residual=torch.where(take, pop.residual, pop.prev_residual),
        weight=torch.where(good, torch.ones_like(pop.weight), pop.weight),
        stuck=torch.where(good, torch.zeros_like(pop.stuck), pop.stuck),
        status=_status(pop, take, good))
    return pop, _no_stats(A.device)
