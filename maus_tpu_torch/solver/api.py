"""User-facing API for linear systems: :class:`MausSolver` and :func:`solve`.

Counterpart of the linear part of ``maus_tpu/solver/api.py``. Construction
stages the operand on the requested device, diagnoses it and picks the
working dtype (complex128 on the CPU, complex64 on CUDA — as the JAX package
uses complex128 only off the accelerator); ``evolve`` runs the population
engine to the working dtype's floor, then certified refinement takes the
distinct solutions to the user's tolerance against the ORIGINAL operand.

Not carried over: the host-refactor driving (a TPU workaround) and
``_stage_operand``'s complex host-crossing workarounds (``utils/xfer.py``).
Checkpointing, metrics capture, ``update_problem``, eig and SVD wait for
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.types import (ProblemKnowledge, ProblemType, SolverConfig,
                          default_target_solutions)
from ..ops.batched_solve import shared_factor_qr
from ..ops.refine import refine_gmres, refine_split
from ..utils.precision import full_precision
from . import evolve as evolve_mod
from . import strategy as strat_mod
from .diagnose import _to_dense_numpy, diagnose

C128 = torch.complex128


@dataclasses.dataclass
class SolutionReport:
    """Distinct converged solutions plus run diagnostics; for linear
    systems each entry of ``solutions`` is ``(x,)`` with ``x`` a complex128
    numpy vector."""

    problem_type: ProblemType
    solutions: list
    residuals: list
    iterations: int
    num_distinct: int
    target_solutions: int
    landscape_energy: float
    knowledge: ProblemKnowledge

    @property
    def converged(self) -> bool:
        return self.num_distinct >= self.target_solutions

    def best(self):
        if not self.solutions:
            return None
        return self.solutions[int(np.argmin(self.residuals))]


def _resolve_device(obj, device) -> torch.device:
    """An explicit ``device`` wins; a tensor stays on its own device; any
    other input (numpy, scipy.sparse, lists) goes to the CPU."""
    if device is not None:
        return torch.device(device)
    if isinstance(obj, torch.Tensor):
        return obj.device
    return torch.device("cpu")


def _all_finite(t: torch.Tensor) -> bool:
    t = torch.view_as_real(t) if t.is_complex() else t
    return bool(torch.isfinite(t).all())


def _stage_operand(matrix, compute_dtype: torch.dtype, device: torch.device):
    """Put the operand on ``device``.

    Returns ``(A_host, A_work, A_true, exact)``: the host copy (``None`` for
    a tensor input, which never visits the host), the working-dtype copy,
    the operand that refinement certifies against, and whether the working
    copy carries every bit of the input (float32/complex64 inputs). The
    exactness decides what kernel K1 reads: the complex64 working copy
    itself when exact, else the complex128 original.
    """
    if isinstance(matrix, torch.Tensor):
        if matrix.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape "
                             f"{tuple(matrix.shape)}")
        exact = matrix.dtype in (torch.float32, torch.complex64)
        full = matrix.to(device)
        if not full.is_complex():
            full = full.to(torch.complex64 if exact else C128)
        A_host = None
    else:
        A_host = _to_dense_numpy(matrix)
        if A_host.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape {A_host.shape}")
        exact = A_host.dtype in (np.dtype(np.float32), np.dtype(np.complex64))
        A_host = A_host.astype(np.complex64 if exact else np.complex128)
        full = torch.from_numpy(A_host).to(device)
    if not _all_finite(full):
        raise ValueError("matrix contains non-finite entries")
    if full.shape[0] != full.shape[1]:
        raise ValueError(f"SOLVE_LINEAR_SYSTEM requires a square matrix, "
                         f"got {tuple(full.shape)}")
    A_work = full.to(compute_dtype).contiguous()
    A_true = A_work if (exact or compute_dtype == C128) else full.contiguous()
    return A_host, A_work, A_true, exact


def _stage_rhs(b_vector, n: int, compute_dtype: torch.dtype,
               device: torch.device):
    """(working-dtype b, complex128 b) on ``device``; refinement certifies
    against the complex128 copy, which carries the user's full precision."""
    if isinstance(b_vector, torch.Tensor):
        b_true = b_vector.to(device=device, dtype=C128)
    else:
        b_true = torch.from_numpy(np.asarray(b_vector).astype(np.complex128)
                                  ).to(device)
    if tuple(b_true.shape) != (n,):
        raise ValueError(f"b_vector shape {tuple(b_true.shape)} does not match "
                         f"matrix ({n},)")
    if not _all_finite(b_true):
        raise ValueError("b_vector contains non-finite entries")
    return b_true.to(compute_dtype).contiguous(), b_true.contiguous()


def convergence_floor(dtype: torch.dtype, cond: float) -> float:
    """In-loop convergence floor of the working dtype.

    complex128 gets 0. A complex64 solve's relative residual bottoms out
    near max(50, 2κ)·ε_f32; candidates count as converged there and the
    certified refinement takes them on to tol. This differs from the JAX
    package, which caps the floor at 1e-2: for κ ≳ 4e4 that cap sits below
    what a complex64 solve can reach, so no candidate ever converges and
    ``solve`` returns no solution (for a 600², κ = 1e6 complex64 system both
    packages stall at 1.4e-2 to 1.6e-2 on the CPU). The cap here is 1, the
    relative residual of x = 0: a higher floor would accept anything."""
    if dtype == C128:
        return 0.0
    eps32 = float(np.finfo(np.float32).eps)
    cond = cond if np.isfinite(cond) else 1e15
    return float(min(max(50.0, 2.0 * cond) * eps32, 1.0))


def _final_dedup(cfg: SolverConfig, solutions: list,
                 residuals: list) -> tuple[list, list]:
    """Deterministic host-side final dedup over the gathered leaders, with a
    hysteresis band (×1.25) around the device's similarity threshold so that
    rounding-level differences cannot move a pair across it. Processed in
    residual order, best first."""
    BAND = 1.25
    order = sorted(range(len(solutions)), key=lambda i: residuals[i])
    kept_s, kept_r = [], []
    for i in order:
        sol, res = solutions[i], residuals[i]
        dup = any(np.linalg.norm(sol[0] - ks[0]) < BAND * 100.0 * cfg.tol
                  for ks in kept_s)
        if not dup:
            kept_s.append(sol)
            kept_r.append(res)
    return kept_s, kept_r


class MausSolver:
    """Population-based meta-heuristic solver for Ax=b (PyTorch port)."""

    def __init__(self, matrix, problem_type: ProblemType, b_vector=None,
                 initial_num_candidates: Optional[int] = None,
                 global_convergence_tol: float = 1e-8,
                 config: Optional[SolverConfig] = None, seed: int = 0,
                 knowledge: Optional[ProblemKnowledge] = None,
                 target_solutions: Optional[int] = None, device=None):
        problem_type = ProblemType(problem_type)
        if problem_type != ProblemType.SOLVE_LINEAR_SYSTEM:
            raise NotImplementedError(
                f"{problem_type.name} is not ported to maus_tpu_torch yet")
        if b_vector is None:
            raise ValueError("SOLVE_LINEAR_SYSTEM requires b_vector")
        self.device = _resolve_device(matrix, device)
        compute_dtype = config.dtype if config is not None else \
            (C128 if self.device.type == "cpu" else torch.complex64)
        with full_precision():
            A_host, A_work, A_true, exact = _stage_operand(
                matrix, compute_dtype, self.device)
            self.knowledge = knowledge if knowledge is not None else diagnose(
                matrix if A_host is not None else None, problem_type,
                device_operand=A_work,
                device_full=A_true if A_true is not A_work else None,
                device_exact=exact)
        m, n = self.knowledge.shape

        if config is None:
            if initial_num_candidates is None:
                initial_num_candidates = min(3 * max(m, n), 64)
            config = SolverConfig(
                problem_type=problem_type,
                num_candidates=int(initial_num_candidates),
                tol=float(global_convergence_tol), dtype=compute_dtype,
                convergence_floor=convergence_floor(
                    compute_dtype, self.knowledge.cond_estimate))
        else:
            config = dataclasses.replace(
                config, problem_type=problem_type,
                tol=float(global_convergence_tol) if global_convergence_tol != 1e-8
                else config.tol)
            if initial_num_candidates is not None:
                config = dataclasses.replace(
                    config, num_candidates=int(initial_num_candidates))
        if target_solutions is not None:
            config = dataclasses.replace(config,
                                         target_num_solutions=int(target_solutions))
        self.config = config
        self.target_solutions = min(default_target_solutions(config, self.knowledge),
                                    config.num_candidates)
        self.A_host = A_host
        self.A = A_work
        self.A_true = A_true
        self.b, self.b_true = _stage_rhs(b_vector, n, config.dtype, self.device)
        self._seed = int(seed)
        self._fac_cache = None

    def evolve(self, max_iterations: int = 100) -> SolutionReport:
        """Run the evolution loop, then refine each distinct solution."""
        cfg, kn = self.config, self.knowledge
        with full_precision():
            carry = evolve_mod.evolve_while(cfg, kn, self.A, self.b, self._seed,
                                            max_iterations, self.target_solutions)
            self._maybe_reuse_factors(carry)
            pop, strat = carry.pop, carry.strat
            diag = strat_mod.compute_diagnostics(cfg, pop, strat,
                                                 self.target_solutions)
            leader = diag.distinct_leader.cpu().numpy()
            residual = pop.residual.cpu().numpy().astype(np.float64)
            order = np.argsort(np.where(np.isfinite(residual), residual, np.inf))
            solutions, residuals = [], []
            for k in (int(k) for k in order if leader[k]):
                xk, rel = pop.v[k], float(residual[k])
                if cfg.refine:
                    xk, rel = self._refine_linear(xk)
                solutions.append((xk.cpu().numpy(),))
                residuals.append(rel)
        solutions, residuals = _final_dedup(cfg, solutions, residuals)
        return SolutionReport(
            problem_type=cfg.problem_type, solutions=solutions,
            residuals=residuals, iterations=int(carry.iteration),
            num_distinct=len(solutions), target_solutions=self.target_solutions,
            landscape_energy=float(strat.landscape_energy), knowledge=kn)

    def _maybe_reuse_factors(self, carry) -> None:
        """Reuse the loop's carried factorization as refinement's
        preconditioner while its Ψ shift is provably harmless (ψ ≲ 1e-3·σ_min,
        no frustration rungs, every factor finite); otherwise refinement
        builds a fresh psi_base QR."""
        if self._fac_cache is not None or carry.fac is None:
            return
        cfg = self.config
        cond_k = self.knowledge.cond_estimate
        cond_k = float(cond_k) if np.isfinite(cond_k) else 1e15
        aggr_cap = max(1.5, 1e-3 / (cfg.psi_base * cond_k))
        if float(carry.strat.frustration) == 0.0 and \
                float(carry.strat.psi_aggression) <= aggr_cap and \
                all(_all_finite(t) for t in vars(carry.fac).values()
                    if isinstance(t, torch.Tensor)):
            self._fac_cache = carry.fac

    def _refine_linear(self, x: torch.Tensor) -> tuple[torch.Tensor, float]:
        """Certified refinement of a linear solution against the original
        operand; returns the complex128 iterate and its relative residual.
        Plain IR first; GMRES-IR when plain IR stalls above tol."""
        cfg = self.config
        if self._fac_cache is None:
            self._fac_cache = shared_factor_qr(self.A, cfg.psi_base)
        x = x.to(cfg.dtype)
        xs, rel = refine_split(self.A_true, self._fac_cache, self.b_true, x,
                               steps=cfg.max_refine_steps, tol=cfg.tol * 0.3)
        if rel > cfg.tol:
            xs2, rel2 = refine_gmres(self.A_true, self._fac_cache, self.b_true,
                                     xs.to(cfg.dtype), steps=cfg.max_refine_steps,
                                     tol=cfg.tol * 0.3)
            if rel2 < rel:
                xs, rel = xs2, rel2
        return xs, rel


def solve(A, b, tol: float = 1e-8, max_iterations: int = 100,
          num_candidates: Optional[int] = None, seed: int = 0,
          config: Optional[SolverConfig] = None, device=None) -> SolutionReport:
    """Solve Ax = b on ``device`` (default: the tensor's own device, or the
    CPU for numpy input)."""
    s = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed,
                   device=device)
    return s.evolve(max_iterations)
