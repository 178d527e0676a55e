"""Batched candidate update steps for linear systems.

Counterpart of ``maus_tpu/solver/candidate.py`` (``init_population``,
``_adapt_and_classify``, ``step_linear`` and helpers). One call advances all K
candidates; solve success or failure, stuckness and convergence are masked
tensor arithmetic on the :class:`~maus_tpu_torch.core.types.Population`.
``step_eigen`` and ``step_svd`` wait for their slices.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.types import (CandidateStatus, Population, ProblemType, SolverConfig,
                          SolverPreference, StrategyState)
from ..ops.batched_solve import solve_any
from ..ops.gmres import gmres_batched, jacobi_from_diag
from ..ops.regularize import psi_magnitude, shift_diagonal


@dataclasses.dataclass
class StepStats:
    """Per-iteration step diagnostics consumed by the strategy layer."""

    solve_fail_frac: torch.Tensor  # fraction of active candidates whose solve failed
    regress_frac: torch.Tensor     # fraction of active candidates that regressed


def _regressed_mask(cfg: SolverConfig, prev: torch.Tensor,
                    new_residual: torch.Tensor, floor_scale=1.0) -> torch.Tensor:
    """The one regression predicate, gated relative to the residual scale."""
    return (new_residual > cfg.regress_ratio * prev) & \
        (prev > 1e-5 * floor_scale) & torch.isfinite(prev)


def _regress_frac(cfg: SolverConfig, pop_before: Population,
                  new_residual: torch.Tensor, frozen: torch.Tensor,
                  floor_scale=1.0) -> torch.Tensor:
    regressed = _regressed_mask(cfg, pop_before.residual, new_residual,
                                floor_scale)
    active_f = (~frozen).to(torch.float32)
    nact = torch.clamp_min(active_f.sum(), 1.0)
    return (regressed.to(torch.float32) * active_f).sum() / nact


def _frozen(pop: Population) -> torch.Tensor:
    return (pop.status == CandidateStatus.CONVERGED) | \
        (pop.status == CandidateStatus.RETIRED)


def init_population(cfg: SolverConfig, seed: int, shape: tuple,
                    device=None) -> Population:
    """Zero-mean Gaussian unit iterates, one independent stream per slot."""
    if cfg.problem_type != ProblemType.SOLVE_LINEAR_SYSTEM:
        raise NotImplementedError("only SOLVE_LINEAR_SYSTEM is ported")
    n = int(shape[1]) if len(shape) > 1 else int(shape[0])
    K = cfg.num_candidates
    keys = rng.make_candidate_keys(seed, K, device)
    v = rng.normal_rows(keys, range(K), n, cfg.dtype, device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    keys = rng.advance(keys)
    rdt = cfg.real_dtype

    def full(val, dtype):
        return torch.full((K,), val, dtype=dtype, device=device)

    return Population(
        v=v,
        weight=full(1.0, rdt),
        alpha=full(cfg.alpha_initial, rdt),
        stuck=full(0, torch.int32),
        status=full(int(CandidateStatus.EXPLORING), torch.int8),
        residual=full(float("inf"), rdt),
        prev_residual=full(float("inf"), rdt),
        psi_level=full(0, torch.int32),
        keys=keys,
        retire_count=full(0, torch.int32),
    )


def _adapt_and_classify(cfg: SolverConfig, pop: Population,
                        new_residual: torch.Tensor, solve_ok: torch.Tensor,
                        strat: StrategyState, params_finite: torch.Tensor,
                        floor_scale=1.0) -> Population:
    """α adaptation, failure handling and the convergence test as masked
    updates; CONVERGED and RETIRED candidates stay frozen."""
    frozen = _frozen(pop)
    active = ~frozen
    where = torch.where
    i8 = torch.int8

    def code(c):
        return torch.tensor(int(c), dtype=i8, device=pop.status.device)

    prev = pop.residual
    improved = new_residual < cfg.improve_ratio * prev
    regressed = _regressed_mask(cfg, prev, new_residual, floor_scale)

    alpha = where(improved, torch.clamp_max(pop.alpha * cfg.alpha_grow, 1.0),
                  where(regressed,
                        torch.clamp_min(pop.alpha * cfg.alpha_shrink, cfg.alpha_min),
                        torch.clamp_min(pop.alpha * cfg.alpha_decay, cfg.alpha_min)))
    status = where(improved, code(CandidateStatus.REFINING),
                   where(regressed, code(CandidateStatus.STUCK),
                         code(CandidateStatus.EXPLORING)))
    stuck = where(regressed, pop.stuck + 1,
                  where(improved, torch.clamp_min(pop.stuck - 1, 0), pop.stuck))
    weight = pop.weight

    # solve failure: weight ×0.001, α halved, stuck++
    fail = active & ~solve_ok
    weight = where(fail, weight * 1e-3, weight)
    alpha = where(fail, torch.clamp_min(pop.alpha * 0.5, cfg.alpha_min), alpha)
    stuck = where(fail, pop.stuck + 1, stuck)
    status = where(fail, code(CandidateStatus.STUCK), status)

    retire = active & (stuck >= cfg.max_stuck_for_retirement)
    status = where(retire, code(CandidateStatus.RETIRED), status)

    # convergence: residual under the current threshold (floored at the
    # working dtype's reachable precision; refinement closes the rest) and
    # every parameter finite
    thresh_eff = torch.clamp_min(strat.threshold, cfg.convergence_floor) * floor_scale
    conv = active & (new_residual < thresh_eff) & params_finite & solve_ok
    status = where(conv, code(CandidateStatus.CONVERGED), status)
    weight = where(conv, torch.ones_like(weight), weight)
    stuck = where(conv, torch.zeros_like(stuck), stuck)

    return dataclasses.replace(
        pop,
        weight=where(frozen, pop.weight, weight),
        alpha=where(frozen, pop.alpha, alpha),
        stuck=where(frozen, pop.stuck, stuck),
        status=where(frozen, pop.status, status),
        residual=where(frozen, pop.residual, new_residual),
        prev_residual=where(frozen, pop.prev_residual, prev))


def _finite_rows(x: torch.Tensor) -> torch.Tensor:
    return (torch.isfinite(x.real) & torch.isfinite(x.imag)).all(dim=-1)


def step_linear(cfg: SolverConfig, A: torch.Tensor, b: torch.Tensor, fac,
                pop: Population, strat: StrategyState
                ) -> tuple[Population, StepStats]:
    """One population step for Ax=b.

    Every candidate solves the same regularized system, so the proposal x̂
    is computed once against the carried factorization (or, under the
    GMRES preference, by GMRES on the same Ψ-shifted system), and only the
    damped mixing ``x_k ← (1−α_k)x_k + α_k x̂`` plus the bookkeeping is
    per-candidate work.
    """
    bnorm = torch.clamp_min(torch.linalg.vector_norm(b),
                            torch.finfo(cfg.real_dtype).tiny)

    if int(strat.solver_pref) == SolverPreference.DIRECT:
        x_hat = solve_any(fac, b)
    else:
        # GMRES solves the same Ψ-regularized system the factorization would
        N = A.shape[0]
        anorm = (torch.linalg.vector_norm(A) / torch.sqrt(
            torch.tensor(float(N), dtype=cfg.real_dtype, device=A.device))
                 ).to(torch.float32)
        psi = psi_magnitude(cfg.psi_base * anorm, strat.psi_aggression,
                            strat.frustration, 0.0)
        d = shift_diagonal(N, psi, cfg.dtype)
        diag = torch.diagonal(A) + d
        res = gmres_batched(lambda X: X @ A.T + d[None, :] * X, b[None, :],
                            precond_diag=jacobi_from_diag(diag)[None, :],
                            tol=cfg.tol, restart=min(32, N), max_restarts=8)
        x_hat = res.x[0]
    ok = _finite_rows(x_hat[None, :])[0]
    solve_ok = ok.expand(pop.capacity)

    alpha_c = pop.alpha.to(cfg.dtype)[:, None]
    v_new = (1.0 - alpha_c) * pop.v + alpha_c * x_hat[None, :]
    v_new = torch.where(solve_ok[:, None], v_new, pop.v)

    resid = torch.linalg.vector_norm(v_new @ A.T - b[None, :], dim=-1) / bnorm
    frozen = _frozen(pop)
    # the linear path escalates at population level: the shared
    # factorization's rung (strategy frustration) is each candidate's depth
    rung = torch.round(strat.frustration).to(torch.int32)
    pop = dataclasses.replace(
        pop, v=torch.where(frozen[:, None], pop.v, v_new),
        psi_level=torch.where(frozen, pop.psi_level, rung.expand(pop.capacity)))
    resid = resid.to(cfg.real_dtype)
    regress = _regress_frac(cfg, pop, resid, frozen)
    pop = _adapt_and_classify(cfg, pop, resid, solve_ok, strat,
                              _finite_rows(v_new))
    active_f = (~frozen).to(torch.float32)
    nact = torch.clamp_min(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).to(torch.float32) * active_f).sum() / nact,
        regress_frac=regress)
