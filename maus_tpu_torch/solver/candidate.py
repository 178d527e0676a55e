"""Batched candidate update steps for linear systems, eigenproblems and SVD.

Counterpart of ``maus_tpu/solver/candidate.py`` (``init_population``,
``_adapt_and_classify``, ``step_linear``, ``step_eigen``, ``step_svd`` and
helpers). One call advances all K candidates; solve success or failure,
stuckness and convergence are masked tensor arithmetic on the
:class:`~maus_tpu_torch.core.types.Population`. The steps touch the
operand only through ``parallel/placement``'s ``rows``, ``left``,
``rows_conj``, ``fro`` and ``diagonal``: the plain expressions for a tensor,
local products and collectives for a column-sharded operand (the mesh
engine), where the JAX package relies on GSPMD. Each step runs its
per-candidate work through ``parallel/placement.on_slots``: on the whole
population, or on this rank's slots of one placed over replica ranks
(``place_population``), whose rows then come back to every rank in one
collective; the bookkeeping after it (α, status, the ``StepStats``
fractions, the regress scale) always sees all K candidates.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.types import (CandidateStatus, Population, ProblemType, SolverConfig,
                          SolverPreference, StrategyState)
from ..ops.batched_solve import batched_shifted_solve, psi_ladder, solve_any
from ..ops.gmres import gmres_batched, jacobi_from_diag
from ..ops.hessenberg import solve_shifted_via_hessenberg
from ..ops.regularize import psi_magnitude, shift_diagonal
from ..parallel.placement import diagonal, fro, left, on_slots, rows, rows_conj
from ..utils.metrics import span

# Eigen shift locking (step_eigen): a candidate keeps its carried (diverse)
# shift until its eigenresidual drops below this fraction of the operand's
# ‖A‖_F/√N scale, then switches to the Rayleigh quotient (RQI).
_SHIFT_LOCK_FRAC = 0.1

# independent per-slot draws at one counter (stream 0 is the iterate v)
_LAM, _U, _RESEED = 1, 2, 3


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
                    device=None, lam_scale=1.0, lam_center=0.0) -> Population:
    """Zero-mean Gaussian unit iterates, one independent stream per slot.

    Eigenproblems also draw one shift per slot, matched to the spectrum's
    first two moments: ``lam_center`` = tr(A)/N, ``lam_scale`` =
    √(‖A‖_F²/N − |center|²), which bounds the RMS eigenvalue distance from
    the centroid (the reference's fixed ±2.5 window misses spectra that live
    elsewhere). An SVD population also draws a unit left vector u of length
    M per slot and starts at σ = 1."""
    m = int(shape[0])
    n = int(shape[1]) if len(shape) > 1 else m
    K = cfg.num_candidates
    keys = rng.make_candidate_keys(seed, K, device)
    v = rng.normal_rows(keys, range(K), n, cfg.dtype, device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    u = None
    lam = torch.zeros((K,), dtype=cfg.dtype, device=device)
    if cfg.problem_type == ProblemType.EIGENVALUE:
        lam = rng.normal_scalars(keys, range(K), cfg.dtype, device, stream=_LAM) \
            * torch.as_tensor(lam_scale, device=device).to(cfg.dtype) \
            + torch.as_tensor(lam_center, device=device).to(cfg.dtype)
    elif cfg.problem_type == ProblemType.SVD:
        u = rng.normal_rows(keys, range(K), m, cfg.dtype, device, stream=_U)
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        lam = torch.ones((K,), dtype=cfg.dtype, device=device)
    keys = rng.advance(keys)
    rdt = cfg.real_dtype

    def full(val, dtype):
        return torch.full((K,), val, dtype=dtype, device=device)

    return Population(
        v=v,
        u=u,
        lam=lam,
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
    # every parameter finite. An eigenpair is accepted only at the user's
    # tol or the dtype floor, never at the strategy's loosened threshold: a
    # loosely accepted pair freezes with an O(threshold) vector error and
    # the finisher snaps several of them onto one true pair.
    if cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        thresh_eff = torch.clamp_min(strat.threshold,
                                     cfg.convergence_floor) * floor_scale
    else:
        thresh_eff = max(cfg.tol, cfg.convergence_floor) * floor_scale
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
                pop: Population, strat: StrategyState, direct_solve=None
                ) -> tuple[Population, StepStats]:
    """One population step for Ax=b.

    Every candidate solves the same regularized system, so the proposal x̂
    is computed once against the carried factorization (or, under the
    GMRES preference, by GMRES on the same Ψ-shifted system), and only the
    damped mixing ``x_k ← (1−α_k)x_k + α_k x̂`` plus the bookkeeping is
    per-candidate work. ``direct_solve``: a ``(fac, b) → x̂`` in place of
    ``solve_any`` (the mesh engine's ``dist_qr_solve`` on sharded factors).
    On a population placed over replica ranks x̂ is computed on every rank
    and the mixing and the residual products run on the rank's slots.
    """
    bnorm = torch.clamp_min(torch.linalg.vector_norm(b),
                            torch.finfo(cfg.real_dtype).tiny)

    if int(strat.solver_pref) == SolverPreference.DIRECT:
        x_hat = solve_any(fac, b) if direct_solve is None \
            else direct_solve(fac, b)
    else:
        # GMRES solves the same Ψ-regularized system the factorization would
        N = A.shape[0]
        anorm = (fro(A) / torch.sqrt(
            torch.tensor(float(N), dtype=cfg.real_dtype, device=A.device))
                 ).to(torch.float32)
        psi = psi_magnitude(cfg.psi_base * anorm, strat.psi_aggression,
                            strat.frustration, 0.0)
        d = shift_diagonal(N, psi, cfg.dtype)
        diag = diagonal(A) + d
        res = gmres_batched(lambda X: rows(A, X) + d[None, :] * X, b[None, :],
                            precond_diag=jacobi_from_diag(diag)[None, :],
                            tol=cfg.tol, restart=min(32, N), max_restarts=8)
        x_hat = res.x[0]
    ok = _finite_rows(x_hat[None, :])[0]
    solve_ok = ok.expand(pop.capacity)

    def mix(p: Population):
        alpha_c = p.alpha.to(cfg.dtype)[:, None]
        v_new = (1.0 - alpha_c) * p.v + alpha_c * x_hat[None, :]
        v_new = torch.where(ok, v_new, p.v)
        resid = torch.linalg.vector_norm(rows(A, v_new) - b[None, :],
                                         dim=-1) / bnorm
        return v_new, resid.to(cfg.real_dtype)

    v_new, resid = on_slots(pop, mix)
    frozen = _frozen(pop)
    # the linear path escalates at population level: the shared
    # factorization's rung (strategy frustration) is each candidate's depth
    rung = torch.round(strat.frustration).to(torch.int32)
    pop = dataclasses.replace(
        pop, v=torch.where(frozen[:, None], pop.v, v_new),
        psi_level=torch.where(frozen, pop.psi_level, rung.expand(pop.capacity)))
    regress = _regress_frac(cfg, pop, resid, frozen)
    pop = _adapt_and_classify(cfg, pop, resid, solve_ok, strat,
                              _finite_rows(v_new))
    active_f = (~frozen).to(torch.float32)
    nact = torch.clamp_min(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).to(torch.float32) * active_f).sum() / nact,
        regress_frac=regress)


def step_eigen(cfg: SolverConfig, A: torch.Tensor, pop: Population,
               strat: StrategyState, hess_cache=None, dist_solve=None
               ) -> tuple[Population, StepStats]:
    """One population step for Ax = λx: per-candidate shift, then a batched
    regularized shifted solve ``(A − λ_k I + Ψ_k) w_k = v_k``.

    With ``hess_cache`` (the shared Hessenberg form A = Q H Qᴴ, built once
    per evolve) the direct branch solves every shift in O(N²) through kernel
    K2; without it, one LU per candidate. Under the GMRES preference the
    step is a Jacobi–Davidson correction instead. A candidate keeps its
    carried (diverse) shift until its eigenresidual drops below
    ``_SHIFT_LOCK_FRAC``·‖A‖_F/√N, then switches to the Rayleigh quotient.
    ``dist_solve``: a ``(λ, B, ψ) → W`` shifted solve in place of the
    Hessenberg one (the mesh engine's ``dist_solve_shifted`` against the
    column-sharded Hessenberg form). On a population placed over replica
    ranks everything up to the new iterates, λ and residuals runs on the
    rank's slots: K2 solves K/r shifts."""
    N = A.shape[0]
    rdt = cfg.real_dtype
    fro_a = fro(A)
    anorm = (fro_a / torch.sqrt(torch.tensor(
        float(N), dtype=fro_a.dtype, device=A.device))).to(torch.float32)
    psi_scaled = cfg.psi_base * anorm * 1e6   # ≈ ε²·‖A‖ for complex64
    direct = int(strat.solver_pref) == SolverPreference.DIRECT

    def advance(p: Population):
        K = p.capacity
        Av = rows(A, p.v)
        vv = torch.sum(p.v.conj() * p.v, dim=-1)
        rq = torch.where(vv.abs() > 1e-12,
                         torch.sum(p.v.conj() * Av, dim=-1) / vv, p.lam)
        aligned = p.residual < _SHIFT_LOCK_FRAC * anorm
        lam = torch.where(aligned, rq, p.lam)

        if direct and (hess_cache is not None or dist_solve is not None):
            shifted = dist_solve or (lambda l_, B_, p_: solve_shifted_via_hessenberg(
                hess_cache, l_, B_, p_))

            def solve_at(attempt_k):
                psi = psi_magnitude(psi_scaled, strat.psi_aggression,
                                    attempt_k, p.stuck)
                return shifted(lam, p.v, psi)

            W, attempts = psi_ladder(solve_at, K, cfg.max_psi_attempts,
                                     device=A.device)
        elif direct:
            W, attempts = batched_shifted_solve(
                A, lam, p.stuck, psi_scaled, strat.psi_aggression, p.v,
                max_attempts=cfg.max_psi_attempts)
        else:
            # Jacobi–Davidson correction: inverse iteration through the
            # nearly singular (A − λI) is where restarted GMRES stalls, so
            # solve the projected system (I − vvᴴ)(A − λI)(I − vvᴴ) t = −r,
            # t ⊥ v, which is well conditioned on v's complement, and step
            # to v + t.
            vk = p.v
            r = Av - lam[:, None] * vk

            def cproj(X):
                return X - torch.sum(vk.conj() * X, dim=-1, keepdim=True) * vk

            def matvec(X):
                Xp = cproj(X)
                return cproj(rows(A, Xp) - lam[:, None] * Xp)

            diag = diagonal(A)[None, :] - lam[:, None]
            res = gmres_batched(matvec, -cproj(r), x0=torch.zeros_like(vk),
                                precond_diag=jacobi_from_diag(diag), tol=1e-2,
                                restart=min(32, N), max_restarts=2)
            W = vk + cproj(res.x)
            attempts = torch.zeros((K,), dtype=torch.int32, device=A.device)

        tiny = torch.finfo(rdt).tiny
        solve_ok = _finite_rows(W) & (torch.linalg.vector_norm(W, dim=-1) > 0)
        # damped update + renormalize: normalize w before mixing so α mixes
        # directions, and align its phase with v so the mix does not cancel
        Wn = W / torch.clamp_min(torch.linalg.vector_norm(W, dim=-1, keepdim=True),
                                 tiny)
        phase = torch.sum(Wn.conj() * p.v, dim=-1)
        phase = torch.where(phase.abs() > 1e-12, phase / phase.abs(),
                            torch.ones_like(phase))
        Wn = Wn * phase[:, None]
        # while the shift is locked, take the full inverse-iteration step;
        # α-damped mixing resumes with RQI
        alpha_eff = torch.where(aligned, p.alpha.to(rdt),
                                torch.ones((), dtype=rdt, device=A.device))
        alpha_c = alpha_eff.to(cfg.dtype)[:, None]
        v_new = (1.0 - alpha_c) * p.v + alpha_c * Wn
        v_new = v_new / torch.clamp_min(
            torch.linalg.vector_norm(v_new, dim=-1, keepdim=True), tiny)
        v_new = torch.where(solve_ok[:, None], v_new, p.v)

        # Rayleigh quotient and residual against the operand
        Av_new = rows(A, v_new)
        lam_new = torch.sum(v_new.conj() * Av_new, dim=-1)
        resid = torch.linalg.vector_norm(Av_new - lam_new[:, None] * v_new, dim=-1)

        # the carried λ: a locked shift persists until the NEW iterate aligns
        aligned_new = resid < _SHIFT_LOCK_FRAC * anorm
        lam_keep = torch.where(aligned_new, lam_new, p.lam)
        return (v_new, lam_keep, resid.to(rdt), solve_ok,
                attempts.to(torch.int32),
                _finite_rows(v_new) & _finite_rows(lam_new[:, None]))

    v_new, lam_keep, resid, solve_ok, attempts, params_finite = \
        on_slots(pop, advance)
    frozen = _frozen(pop)
    pop = dataclasses.replace(
        pop, psi_level=torch.where(frozen, pop.psi_level, attempts),
        v=torch.where(frozen[:, None], pop.v, v_new),
        lam=torch.where(frozen, pop.lam, lam_keep))
    # acceptance/regress scale: max(‖A‖_F/√N, max |RQ|); the Rayleigh
    # quotients of unit iterates lower-bound ‖A‖₂ on low-rank spectra
    lam_abs = pop.lam.abs()
    scale_eff = torch.maximum(
        anorm.to(rdt),
        torch.max(torch.where(torch.isfinite(lam_abs), lam_abs,
                              torch.zeros_like(lam_abs))).to(rdt))
    regress = _regress_frac(cfg, pop, resid, frozen, floor_scale=scale_eff)
    pop = _adapt_and_classify(cfg, pop, resid, solve_ok, strat, params_finite,
                              floor_scale=scale_eff)
    active_f = (~frozen).to(torch.float32)
    nact = torch.clamp_min(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).to(torch.float32) * active_f).sum() / nact,
        regress_frac=regress)


def _align(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Rows of ``new`` rotated in phase toward the rows of ``old``."""
    ph = torch.sum(new.conj() * old, dim=-1)
    ph = torch.where(ph.abs() > 1e-12, ph / ph.abs(), torch.ones_like(ph))
    return new * ph[:, None]


def step_svd(cfg: SolverConfig, A: torch.Tensor, pop: Population,
             strat: StrategyState) -> tuple[Population, StepStats]:
    """One SVD population step for an (M, N) operand A.

    ``cfg.orthogonalize`` (the default) runs the population as one block: a
    round of subspace iteration with a Rayleigh–Ritz rotation (two tall QRs
    and one small SVD), after which every active slot takes a damped step
    toward its slot-rank Ritz triplet and every converged slot toward the
    Ritz triplet it overlaps most (a slot-rank assignment would teleport it
    when two clustered Ritz values swap order). Otherwise each candidate runs
    the reference's alternating power iteration on its own. A candidate whose
    direction A annihilates (σ < 1e-8·‖A‖_F/√min(M, N)) has found a null
    triplet and is judged by ‖Av‖ alone. Converged candidates keep polishing
    their data (status frozen), except null triplets, whose data freezes.
    On a population placed over replica ranks every rank runs the block
    round on the whole block (its QRs and small SVD mix every candidate,
    and the Ritz slot of candidate k is k mod min(K, M, N) over the whole
    K); the damped steps and the residual products run on the rank's
    slots."""
    conv = pop.status == CandidateStatus.CONVERGED
    rdt = cfg.real_dtype
    tiny = torch.finfo(rdt).tiny
    K = pop.capacity
    # zero-singular-value detection, relative to the operand's scale
    fro_a = fro(A)
    a_scale = (fro_a / torch.sqrt(torch.tensor(
        float(min(A.shape)), dtype=fro_a.dtype, device=A.device))).to(rdt)
    reseeded = torch.zeros((K,), dtype=torch.bool, device=A.device)
    ritz = ()

    if cfg.orthogonalize:
        N = pop.v.shape[1]
        M = pop.u.shape[1]
        r = min(K, M, N)
        # reseed non-finite or collapsed directions (a slot draws only then)
        reseeded = ~_finite_rows(pop.v) | \
            (torch.linalg.vector_norm(pop.v, dim=-1) < 1e-12)
        V = pop.v
        slots = torch.nonzero(reseeded).flatten().tolist()
        if slots:
            V = V.clone()
            V[slots] = rng.normal_rows(pop.keys, slots, N, cfg.dtype, A.device,
                                      stream=_RESEED)
        pop = dataclasses.replace(pop, keys=rng.advance(pop.keys))

        # one block round: span{A·V} → Qu; project; QR; small SVD → Ritz
        with span("maus.svd.block_round"):
            Qu, _ = torch.linalg.qr(rows(A, V).T)               # (M, r)
            Z = left(A, Qu.mH)                                  # (r, N)
            Qv, Rz = torch.linalg.qr(Z.mH)                      # (N, r), (r, r)
            Us, _, Vsh = torch.linalg.svd(Rz.mH)
            U_ritz = Qu @ Us                                    # (M, r)
            V_ritz = Qv @ Vsh.mH                                # (N, r)

        slot_idx = torch.arange(K, device=A.device) % r
        ovl = (V.conj() @ V_ritz).abs()                         # (K, r)
        idx = torch.where(conv, torch.argmax(ovl, dim=-1), slot_idx)
        ritz = (V, V_ritz.T[idx], U_ritz.T[idx])

    def advance(p: Population, *ritz_rows):
        if cfg.orthogonalize:
            # damped step toward the Ritz triplet, α adapted per candidate
            V, v_ritz, u_ritz = ritz_rows
            alpha_c = p.alpha.to(cfg.dtype)[:, None]
            v_mix = (1.0 - alpha_c) * V + alpha_c * _align(v_ritz, V)
            v_new = v_mix / torch.clamp_min(
                torch.linalg.vector_norm(v_mix, dim=-1, keepdim=True), tiny)
            u_mix = (1.0 - alpha_c) * p.u + alpha_c * _align(u_ritz, p.u)
            u_new = u_mix / torch.clamp_min(
                torch.linalg.vector_norm(u_mix, dim=-1, keepdim=True), tiny)
            # σ of the mixed triplet: the phase-absorbed Rayleigh quotient uᴴAv
            Avm = rows(A, v_new)                                # (K, M)
            rq = torch.sum(u_new.conj() * Avm, dim=-1)
            rq_ph = torch.where(rq.abs() > 1e-30, rq / rq.abs(),
                                torch.ones_like(rq))
            u_new = u_new * rq_ph[:, None]      # uᴴAv real ≥ 0 ⇒ σ = |rq|
            sigma = rq.abs().to(rdt)
            s_u = torch.linalg.vector_norm(Avm, dim=-1).to(rdt)
            solve_ok = _finite_rows(u_new) & _finite_rows(v_new)
        else:
            # the reference's per-candidate alternating power iteration;
            # (Aᴴu)[n] = Σ_m conj(A[m, n]) u[m], a product with conj(A)
            Av = rows(A, p.v)                                   # (K, M)
            s_u = torch.linalg.vector_norm(Av, dim=-1)
            u_new = Av / torch.clamp_min(s_u, tiny)[:, None]
            AHu = rows_conj(A, u_new)                           # (K, N)
            s_v = torch.linalg.vector_norm(AHu, dim=-1)
            v_new = AHu / torch.clamp_min(s_v, tiny)[:, None]
            sigma = torch.maximum(s_u, s_v).to(rdt)
            solve_ok = _finite_rows(u_new) & _finite_rows(v_new) & (s_u > 1e-30)

        zero_sv = s_u < 1e-8 * torch.clamp_min(a_scale, tiny)
        sigma = torch.where(zero_sv, torch.zeros_like(sigma), sigma)
        # two-sided residual ‖Av − σu‖ + ‖Aᴴu − σv‖; for a null vector ‖Av‖
        # alone (u is arbitrary for σ = 0)
        sig_c = sigma[:, None].to(cfg.dtype)
        r1 = torch.linalg.vector_norm(rows(A, v_new) - sig_c * u_new, dim=-1)
        r2 = torch.linalg.vector_norm(rows_conj(A, u_new) - sig_c * v_new, dim=-1)
        resid = torch.where(zero_sv, r1.to(rdt), (r1 + r2).to(rdt))
        solve_ok = solve_ok | (zero_sv & _finite_rows(v_new))
        return (v_new, u_new, sigma, resid, solve_ok,
                _finite_rows(v_new) & _finite_rows(u_new))

    v_new, u_new, sigma, resid, solve_ok, params_finite = \
        on_slots(pop, advance, *ritz)

    retired = pop.status == CandidateStatus.RETIRED
    frozen = conv | retired
    null_conv = conv & (pop.lam.abs() == 0.0)
    keep = retired | ~solve_ok | null_conv
    # an SVD "attempt" is a failed or collapsed step: psi_level counts them
    failed_step = ~frozen & (reseeded | ~solve_ok)
    pop = dataclasses.replace(
        pop, v=torch.where(keep[:, None], pop.v, v_new),
        u=torch.where(keep[:, None], pop.u, u_new),
        lam=torch.where(keep, pop.lam, sigma.to(cfg.dtype)),
        psi_level=pop.psi_level + failed_step.to(torch.int32))
    # acceptance/regress scale: max(‖A‖_F/√min(M, N), max σ); every σ =
    # |uᴴAv| of unit vectors lower-bounds ‖A‖₂, and the Frobenius scale
    # understates the residual units of a low-rank spectrum
    lam_abs = pop.lam.abs()
    scale_eff = torch.maximum(
        a_scale, torch.max(torch.where(torch.isfinite(lam_abs), lam_abs,
                                       torch.zeros_like(lam_abs))).to(rdt))
    regress = _regress_frac(cfg, pop, resid, frozen, floor_scale=scale_eff)
    # polished converged candidates refresh their residual in place
    pop = dataclasses.replace(
        pop, residual=torch.where(conv & solve_ok & ~null_conv, resid,
                                  pop.residual))
    pop = _adapt_and_classify(cfg, pop, resid, solve_ok, strat, params_finite,
                              floor_scale=scale_eff)
    active_f = (~frozen).to(torch.float32)
    nact = torch.clamp_min(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).to(torch.float32) * active_f).sum() / nact,
        regress_frac=regress)
