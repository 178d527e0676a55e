"""The evolution loop for linear systems, eigenproblems and SVD.

Counterpart of ``maus_tpu/solver/evolve.py`` (``_effective_psi``,
``make_iteration``, ``init_carry``, ``_use_hessenberg``, ``_use_shared_eigh``,
``_setup_caches``, ``_stop_condition``, ``evolve_while``, ``Metrics`` and
``evolve_scan``). The JAX ``lax.while_loop`` becomes an eager Python loop
with a stop check after every iteration; the ``lax.cond`` around the shared
refactorization becomes a Python branch on a host read. The metrics path
(:func:`evolve_metrics`) runs the same loop and keeps each iteration's
:class:`Metrics` row on the device; the rows are stacked once at the end.
Per-iteration order is the reference's: diagnostics → strategy adjustment
→ candidate step → population management.
The linear path carries its shared factorization across iterations and
rebuilds it only when the strategy's Ψ rung changes; the eig path carries no
factorization and builds its shared one-time form once per evolve: the
Hessenberg form for a general operand, the full eigh of a dense Hermitian
operand up to ``eigh_max_n`` (else per-candidate deflated Lanczos, which
needs none); the SVD step needs neither (its block round is matrix
products, two thin QRs and a small SVD).

With A a column-sharded ``parallel/placement.ColumnSharded`` (its mesh a
model axis over ``torch.distributed`` ranks) the loop is the mesh engine of
the JAX package: the linear path's shared factorization is the
column-sharded ``dist_qr`` and its solves ``dist_qr_solve``; every shifted
solve of the eig path, Hermitian operands included, goes through the
column-sharded Hessenberg form (``dist_solve_shifted``; a replicated eigh
or Lanczos would defeat the sharding); the SVD step needs no routing.

Every rank runs the same loop on the same replicated population. A
population placed over replica ranks (``parallel/placement.
place_population``, as in the JAX package: ``carry0.pop =
place_population(mesh, carry0.pop)``, then :func:`evolve_while` or
:func:`evolve_metrics` from ``carry0``) splits only the candidate step:
each rank steps its K/r slots and the stepped rows come back to every rank
in one replica-axis collective an iteration, while the diagnostics, the
strategy, population management, the escalation and failover logic, the
stall tracking and the metrics rows see the whole population on every
rank, so every rank branches alike. With model > 1 too, the steps'
products and shifted solves run inside the model group of the rank's
replica index.

Not carried over: the host-refactor handoff and ``refactor_psi`` (an XLA:TPU
scoped-VMEM workaround) and the hoisted large-N Hessenberg program (a TPU
fault workaround).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.types import (CandidateStatus, Population, ProblemKnowledge,
                          ProblemType, SolverConfig, StrategyState,
                          initial_strategy)
from ..ops.batched_solve import (CholFactors, qr_template, shared_factor_hpd,
                                 shared_factor_qr)
from ..ops.hessenberg import HessCache, reduce_hessenberg_auto
from ..ops.regularize import pow10, psi_magnitude
from ..parallel.dist_hessenberg import dist_hessenberg, dist_solve_shifted
from ..parallel.dist_qr import DistQR, dist_qr, dist_qr_solve, panel_block
from ..parallel.placement import ColumnSharded, fro, trace
from ..utils.metrics import span
from . import candidate as cand
from . import hermitian as herm
from . import population as popmgmt
from . import strategy as strat_mod


@dataclasses.dataclass
class Metrics:
    """Per-iteration population statistics, under the JAX package's names:
    one row of 0-d tensors per iteration, or rows stacked along a leading
    axis. The ``candidate_*`` fields hold each candidate's residual, α and
    status ((K,) a row) when ``cfg.capture_history`` is set, and its iterate
    ((K, N) a row) when ``cfg.capture_param_history`` is; otherwise they
    are zero-size ((0,) and (0, 0) a row)."""

    landscape_energy: torch.Tensor
    avg_residual: torch.Tensor
    avg_stuckness: torch.Tensor
    num_distinct: torch.Tensor
    min_residual: torch.Tensor
    psi_aggression: torch.Tensor
    threshold: torch.Tensor
    solve_fail_frac: torch.Tensor
    candidate_residuals: torch.Tensor
    candidate_alpha: torch.Tensor
    candidate_status: torch.Tensor
    candidate_params: torch.Tensor


def _metrics_row(cfg: SolverConfig, pop: Population, strat: StrategyState,
                 solve_fail_frac: torch.Tensor) -> Metrics:
    """One iteration's row, computed on the device without a host read."""
    if cfg.capture_history:
        hist = (pop.residual, pop.alpha, pop.status)
    else:
        hist = tuple(t.new_zeros((0,)) for t in (pop.residual, pop.alpha,
                                                 pop.status))
    return Metrics(
        landscape_energy=strat.landscape_energy,
        avg_residual=strat.avg_residual,
        avg_stuckness=strat.avg_stuckness,
        num_distinct=strat.num_distinct,
        min_residual=torch.min(torch.where(
            torch.isfinite(pop.residual), pop.residual,
            torch.full_like(pop.residual, float("inf")))),
        psi_aggression=strat.psi_aggression,
        threshold=strat.threshold,
        solve_fail_frac=solve_fail_frac,
        candidate_residuals=hist[0], candidate_alpha=hist[1],
        candidate_status=hist[2],
        candidate_params=pop.v if cfg.capture_param_history
        else pop.v.new_zeros((0, 0)))


@dataclasses.dataclass
class EvolveCarry:
    pop: Population
    strat: StrategyState
    fac: object                  # a QR bundle / CholFactors / LUFactors / DistQR; None (eig)
    psi_cached: torch.Tensor     # f32 — Ψ the carried factorization was built with
    iteration: torch.Tensor      # i32
    best_residual: torch.Tensor  # f32 — previous iteration's best active residual
    stall_count: torch.Tensor    # i32 — iterations without progress


def _anorm(A: torch.Tensor) -> torch.Tensor:
    """‖A‖_F/√N as float32, the scale Ψ is relative to."""
    n = A.shape[-1]
    fro_a = fro(A)
    return (fro_a / torch.sqrt(
        torch.tensor(float(n), dtype=fro_a.dtype, device=A.device))).to(torch.float32)


def _effective_psi(cfg: SolverConfig, strat: StrategyState,
                   anorm: torch.Tensor) -> torch.Tensor:
    """Iteration-level Ψ of the shared factorization: base × matrix scale ×
    aggression × 10^frustration, quantized to half-decade rungs so that the
    controller's gentle aggression nudges do not refactorize every
    iteration."""
    raw = psi_magnitude(cfg.psi_base * anorm, strat.psi_aggression,
                        strat.frustration, 0.0)
    half_decades = torch.round(torch.log10(torch.clamp_min(raw, 1e-300)) * 2.0)
    return pow10(half_decades / 2.0).to(raw.dtype)


def _refactor(knowledge: ProblemKnowledge, A: torch.Tensor, psi):
    """The shared factorization of A + ψI: ``dist_qr`` of the shifted
    shards for a column-sharded A (panels of ``panel_block`` of the shard
    width), else a Cholesky or a QR on the device."""
    with span("maus.factor"):
        if isinstance(A, ColumnSharded):
            return dist_qr(A.mesh, A.shifted(psi),
                           block=panel_block(A.local.shape[1]))
        return shared_factor_hpd(A, psi) if knowledge.is_positive_definite \
            else shared_factor_qr(A, psi)


def _spectral_moments(A: torch.Tensor):
    """(center, spread) of the spectrum: tr(A)/N, and
    √(‖A‖_F²/N − |center|²) in A's real dtype, which bounds the RMS
    eigenvalue distance from the centroid. A rectangular operand (SVD) has
    no spectrum: (0, ‖A‖_F/√N)."""
    n = A.shape[-1]
    if A.shape[0] != n:
        return torch.zeros((), dtype=A.dtype, device=A.device), \
            fro(A) / n ** 0.5
    center = (trace(A) / n).to(A.dtype)
    spread = torch.sqrt(torch.clamp_min(
        fro(A) ** 2 / n - center.abs() ** 2, 1e-12))
    return center, spread


def make_iteration(cfg: SolverConfig, knowledge: ProblemKnowledge,
                   A: torch.Tensor, b: Optional[torch.Tensor],
                   target_solutions: int,
                   hess_cache: Optional[HessCache] = None,
                   eigh_cache: Optional[herm.EighCache] = None,
                   with_metrics: bool = False):
    """Build the single-iteration function ``carry → carry``, or
    ``carry → (carry, Metrics row)`` with ``with_metrics``.
    ``hess_cache``: the shared Hessenberg form of A (general eig path; a
    ``DistHess`` for a column-sharded A, whose linear solves and eig solves
    go through the column-sharded factors);
    ``eigh_cache``: the shared eigh of A (Hermitian eig path; without it a
    Hermitian operand takes the deflated-Lanczos step)."""
    anorm = _anorm(A)
    lam_center, lam_spread = _spectral_moments(A)
    lam_spread = lam_spread.to(torch.float32)
    linear = cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM
    mesh = A.mesh if isinstance(A, ColumnSharded) else None
    direct_solve = None if mesh is None else (lambda f_, b_: dist_qr_solve(
        mesh, f_, b_, block=panel_block(A.local.shape[1])))

    def iteration(carry: EvolveCarry) -> EvolveCarry:
        pop, strat = carry.pop, carry.strat
        diag = strat_mod.compute_diagnostics(cfg, pop, strat, target_solutions)
        strat = strat_mod.adjust_strategy(cfg, strat, diag)

        fac, psi_eff = carry.fac, carry.psi_cached
        if linear:
            psi_eff = _effective_psi(cfg, strat, anorm).to(carry.psi_cached.dtype)
            if bool(psi_eff != carry.psi_cached):
                fac = _refactor(knowledge, A, psi_eff)
            pop, stats = cand.step_linear(cfg, A, b, fac, pop, strat,
                                          direct_solve=direct_solve)
        elif cfg.problem_type == ProblemType.EIGENVALUE and mesh is not None:
            pop, stats = cand.step_eigen(
                cfg, A, pop, strat, dist_solve=lambda l_, B_, p_: dist_solve_shifted(
                    mesh, hess_cache, l_, B_, p_))
        elif cfg.problem_type == ProblemType.EIGENVALUE and knowledge.is_hermitian:
            if eigh_cache is not None:
                pop, stats = herm.step_hermitian(cfg, A, eigh_cache, pop, strat)
            else:
                pop, stats = herm.step_hermitian_lanczos(cfg, A, pop, strat)
        elif cfg.problem_type == ProblemType.EIGENVALUE:
            pop, stats = cand.step_eigen(cfg, A, pop, strat,
                                         hess_cache=hess_cache)
        else:
            pop, stats = cand.step_svd(cfg, A, pop, strat)
        pop = popmgmt.manage(cfg, pop, strat, diag, target_solutions,
                             lam_scale=lam_spread, lam_center=lam_center)

        # population-level escalation pressure (see _effective_psi)
        bad_step = (stats.solve_fail_frac > 0.5) | (stats.regress_frac > 0.5)
        frustration = torch.where(
            stats.solve_fail_frac > 0.5,
            torch.clamp_max(strat.frustration + 1.0, 24.0),
            torch.where(stats.solve_fail_frac == 0.0,
                        torch.clamp_min(strat.frustration - 0.25, 0.0),
                        strat.frustration))
        # direct↔GMRES failover after a few consecutive bad steps
        pref_failures = torch.where(bad_step, strat.pref_failures + 1.0,
                                    torch.clamp_min(strat.pref_failures - 1.0, 0.0))
        flip = pref_failures >= 3.0
        solver_pref = torch.where(flip, 1 - strat.solver_pref, strat.solver_pref)
        pref_failures = torch.where(flip, torch.zeros_like(pref_failures),
                                    pref_failures)
        strat = dataclasses.replace(strat, frustration=frustration,
                                    pref_failures=pref_failures,
                                    solver_pref=solver_pref)

        # stagnation tracking: progress is a better best ACTIVE residual than
        # last iteration's, or a new distinct solution
        frozen_now = (pop.status == CandidateStatus.CONVERGED) | \
            (pop.status == CandidateStatus.RETIRED)
        cur_min = torch.min(torch.where(
            torch.isfinite(pop.residual) & ~frozen_now, pop.residual,
            torch.full_like(pop.residual, float("inf")))).to(torch.float32)
        improved = (cur_min < carry.best_residual * 0.99) | \
            (strat.num_distinct > carry.strat.num_distinct)
        best_residual = torch.where(torch.isfinite(cur_min), cur_min,
                                    carry.best_residual)
        stall_count = torch.where(improved, torch.zeros_like(carry.stall_count),
                                  carry.stall_count + 1)
        new = EvolveCarry(pop=pop, strat=strat, fac=fac, psi_cached=psi_eff,
                          iteration=carry.iteration + 1,
                          best_residual=best_residual, stall_count=stall_count)
        if with_metrics:
            return new, _metrics_row(cfg, pop, strat, stats.solve_fail_frac)
        return new

    return iteration


def _fac_template(knowledge: ProblemKnowledge, A: torch.Tensor):
    """The shared factorization's bundle with meta tensors of its shapes
    and dtypes in place of the O(N³) factors (this rank's (N, N/m) shards of
    a ``DistQR`` for a column-sharded A)."""
    if isinstance(A, ColumnSharded):
        shard = A.local.shape
        return DistQR(torch.empty(shard, dtype=A.dtype, device="meta"),
                      torch.empty(shard, dtype=A.dtype, device="meta"))
    if knowledge.is_positive_definite:
        n = A.shape[-1]
        return CholFactors(torch.empty((n, n), dtype=A.dtype, device="meta"))
    return qr_template(A.shape[-1], A.dtype)


def init_carry(cfg: SolverConfig, knowledge: ProblemKnowledge, A: torch.Tensor,
               seed: int, template: bool = False) -> EvolveCarry:
    """Initial population and strategy; for a linear system also the shared
    factorization at the first Ψ (an eigenproblem carries none). With
    ``template`` the factorization is not computed: its leaves are meta
    tensors of the right shapes, which is all a checkpoint's loader needs
    (``utils/checkpoint.load_state``). For a column-sharded A the
    factorization is the ``dist_qr`` of its shifted shards."""
    device = A.device
    lam_center, lam_scale = _spectral_moments(A)
    pop = cand.init_population(cfg, seed, knowledge.shape, device=device,
                               lam_scale=lam_scale, lam_center=lam_center)
    strat = initial_strategy(cfg, knowledge, device=device)
    if cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        psi0 = _effective_psi(cfg, strat, _anorm(A))
        fac = _fac_template(knowledge, A) if template else \
            _refactor(knowledge, A, psi0)
    else:
        fac, psi0 = None, torch.tensor(0.0, dtype=torch.float32, device=device)
    return EvolveCarry(
        pop=pop, strat=strat, fac=fac, psi_cached=psi0,
        iteration=torch.tensor(0, dtype=torch.int32, device=device),
        best_residual=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        stall_count=torch.tensor(0, dtype=torch.int32, device=device))


def _use_hessenberg(cfg: SolverConfig, knowledge: ProblemKnowledge) -> bool:
    """Shared Hessenberg reduction for the non-Hermitian eig path: one O(N³)
    setup turns every per-candidate shifted solve into O(N²). Hermitian
    operands take the eigh/Lanczos steps instead."""
    return cfg.problem_type == ProblemType.EIGENVALUE and \
        not knowledge.is_hermitian and cfg.use_hessenberg


def _use_shared_eigh(cfg: SolverConfig, knowledge: ProblemKnowledge) -> bool:
    """Shared full eigh for dense Hermitian operands up to
    ``cfg.eigh_max_n``; deflated Lanczos beyond it or for sparse input."""
    if cfg.problem_type != ProblemType.EIGENVALUE or not knowledge.is_hermitian:
        return False
    return knowledge.shape[-1] <= cfg.eigh_max_n and not knowledge.is_sparse_input


@dataclasses.dataclass
class Caches:
    """The per-evolve one-time factorizations shared by every iteration."""

    hess: Optional[HessCache] = None        # general eig: A = Q H Qᴴ
    eigh: Optional[herm.EighCache] = None   # dense Hermitian eig: A = V W Vᴴ


def _setup_caches(cfg: SolverConfig, knowledge: ProblemKnowledge,
                  A: torch.Tensor) -> Caches:
    """Build the caches the problem's path uses (none for a linear system,
    an SVD or the Lanczos branch). For a column-sharded A an eigenproblem,
    Hermitian or not, gets the column-sharded Hessenberg form."""
    if isinstance(A, ColumnSharded):
        return Caches(hess=dist_hessenberg(A.mesh, A.local)
                      if cfg.problem_type == ProblemType.EIGENVALUE else None)
    return Caches(
        hess=reduce_hessenberg_auto(A) if _use_hessenberg(cfg, knowledge) else None,
        eigh=herm.eigh_setup(A) if _use_shared_eigh(cfg, knowledge) else None)


def _stop_condition(cfg: SolverConfig, target_solutions: int,
                    carry: EvolveCarry) -> torch.Tensor:
    """Done ⇔ the target number of distinct converged solutions exists, or
    the best residual has not improved for ``cfg.stall_limit`` iterations
    (refinement takes over from there). An SVD run compares against its
    dynamic target (``strat.target_dynamic``), re-estimated every iteration
    from the converged σ spectrum."""
    target = carry.strat.target_dynamic \
        if cfg.problem_type == ProblemType.SVD else target_solutions
    return (carry.strat.num_distinct >= target) | \
        (carry.stall_count >= cfg.stall_limit)


def _loop(cfg: SolverConfig, knowledge: ProblemKnowledge, A: torch.Tensor,
          b: Optional[torch.Tensor], seed: int, max_iterations: int,
          target_solutions: int, carry0: Optional[EvolveCarry],
          caches: Optional[Caches], with_metrics: bool):
    """The loop under :func:`evolve_while` and :func:`evolve_metrics`:
    (last carry, the metrics rows that ran). The span ``maus.engine.init``
    holds the step's set-up, the carry's (unless ``carry0`` is given) and
    the first stop check, the first host read that waits for them; each
    ``maus.engine.iteration`` holds one step and the stop check after it."""
    if caches is None:
        caches = _setup_caches(cfg, knowledge, A)

    def done(carry) -> bool:
        return bool((carry.iteration >= max_iterations) |
                    _stop_condition(cfg, target_solutions, carry))

    with span("maus.engine.init"):
        step = make_iteration(cfg, knowledge, A, b, target_solutions,
                              hess_cache=caches.hess, eigh_cache=caches.eigh,
                              with_metrics=with_metrics)
        carry = carry0 if carry0 is not None else \
            init_carry(cfg, knowledge, A, seed)
        stop = done(carry)
    rows = []
    while not stop:
        with span("maus.engine.iteration"):
            if with_metrics:
                carry, row = step(carry)
                rows.append(row)
            else:
                carry = step(carry)
            stop = done(carry)
    return carry, rows


def evolve_while(cfg: SolverConfig, knowledge: ProblemKnowledge,
                 A: torch.Tensor, b: Optional[torch.Tensor], seed: int,
                 max_iterations: int, target_solutions: int,
                 carry0: Optional[EvolveCarry] = None,
                 caches: Optional[Caches] = None) -> EvolveCarry:
    """Iterate until the stop condition holds or ``max_iterations`` (a bound
    on the carry's total iteration count) is reached. ``caches``: prebuilt
    shared factorizations (:func:`_setup_caches`); built here when not
    given. The caller sets the matmul precision
    (``utils/precision.full_precision``, as ``MausSolver.evolve`` does)."""
    return _loop(cfg, knowledge, A, b, seed, max_iterations, target_solutions,
                 carry0, caches, with_metrics=False)[0]


def evolve_metrics(cfg: SolverConfig, knowledge: ProblemKnowledge,
                   A: torch.Tensor, b: Optional[torch.Tensor], seed: int,
                   max_iterations: int, target_solutions: int,
                   carry0: Optional[EvolveCarry] = None,
                   caches: Optional[Caches] = None
                   ) -> tuple[EvolveCarry, Metrics]:
    """:func:`evolve_while` that also returns the stacked :class:`Metrics`,
    one row for each iteration from the carry's to ``max_iterations``: the
    rows of the iterations that ran, then all-zero rows from where the stop
    condition held (the contract of the JAX ``evolve_scan``). The rows stay
    on the device until one stack at the end, so collecting them adds no
    host read per iteration."""
    start = int(carry0.iteration) if carry0 is not None else 0
    carry, ran = _loop(cfg, knowledge, A, b, seed, max_iterations,
                       target_solutions, carry0, caches, with_metrics=True)
    zero = _metrics_row(cfg, carry.pop, carry.strat,
                        torch.zeros((), dtype=torch.float32, device=A.device))
    pad = map_metrics(lambda z: z.new_zeros(
        (max(max_iterations - start, 0) - len(ran),) + z.shape), zero)
    if not ran:
        return carry, pad
    return carry, map_metrics(lambda *xs: torch.cat([torch.stack(xs[:-1]), xs[-1]]),
                              *ran, pad)


def map_metrics(fn, *ms: Metrics) -> Metrics:
    """``fn`` applied field by field across :class:`Metrics` values."""
    return Metrics(**{f.name: fn(*(getattr(m, f.name) for m in ms))
                      for f in dataclasses.fields(Metrics)})
