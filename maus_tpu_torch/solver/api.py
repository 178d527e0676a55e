"""User-facing API: :class:`MausSolver`, :func:`solve`, :func:`eig` and
:func:`svd`.

Counterpart of the single-device parts of ``maus_tpu/solver/api.py``.
Construction stages the operand on the device
(the card unless the caller passes ``device="cpu"``), diagnoses it and picks
the working dtype (complex128 on the CPU, complex64 on CUDA — as the JAX
package uses complex128 only off the accelerator); ``evolve`` runs the
population engine to the working dtype's floor, then the finishers take the
distinct solutions to the user's tolerance against the ORIGINAL operand:
certified refinement for a linear system, the FP64 Newton finishers for
eigenpairs and singular triplets.

Not carried over: the host-refactor driving and the hoisted large-N
Hessenberg program (TPU workarounds), the TPU-QR halving of the finisher's
chunk, ``_stage_operand``'s complex host-crossing workarounds
(``utils/xfer.py``) and, in ``update_problem``, the host-refactor policy.
``evolve`` takes the JAX package's checkpoint and metrics arguments
(``utils/checkpoint.py``, ``evolve.evolve_metrics``).

The mesh half (``solve/eig/svd(mesh=)``, :class:`MeshSolver`) is the JAX
package's: every rank of a ``parallel.mesh.Mesh`` calls the same entry
point, holds its column shard of the operand, and runs the same engine with
the factorizations column-sharded, then the distributed finishers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.types import (CandidateStatus, ProblemKnowledge, ProblemType,
                          SolverConfig, default_target_solutions)
from ..ops.batched_solve import shared_factor_qr
from ..ops.refine import refine_gmres, refine_split
from ..ops.refine_eig import refine_eigenpairs, refine_svd_triplets
from ..parallel.dist_hessenberg import dist_hessenberg
from ..parallel.dist_qr import (panel_block, refine_distributed,
                                stage_A, stage_b, stage_operands)
from ..parallel.dist_refine import (dist_refine_eigenpairs, dist_refine_svd,
                                    stage_spectral)
from ..parallel.mesh import MODEL_AXIS
from ..parallel.placement import place_operands
from ..utils.checkpoint import load_state, save_state
from ..utils.metrics import span
from ..utils.precision import full_precision
from . import evolve as evolve_mod
from . import strategy as strat_mod
from .diagnose import _to_dense_numpy, diagnose

C128 = torch.complex128


@dataclasses.dataclass
class SolutionReport:
    """Distinct converged solutions plus run diagnostics. Each entry of
    ``solutions`` is ``(x,)`` for a linear system, with ``x`` a complex128
    numpy vector, ``(λ, v)`` for an eigenproblem, with λ a Python complex
    and ``v`` a numpy vector (complex128 once finished), and ``(σ, u, v)``
    for an SVD, with σ a Python float. ``timings``
    holds the host seconds of each phase of ``evolve`` (``setup_s``, the
    shared Hessenberg reduction or eigh; ``engine_s``, checkpoint loads and
    saves included; ``finish_s``), each phase ending in a device
    synchronisation. ``metrics``: with ``collect_metrics``, the stacked
    per-iteration :class:`~maus_tpu_torch.solver.evolve.Metrics` as numpy
    arrays by field name, else ``None``. ``shards``: on the mesh paths, the
    shape of every operand and factor shard this rank held in the run, by
    name (``None`` on one device)."""

    problem_type: ProblemType
    solutions: list
    residuals: list
    iterations: int
    num_distinct: int
    target_solutions: int
    landscape_energy: float
    knowledge: ProblemKnowledge
    timings: Optional[dict] = None
    metrics: Optional[dict] = None
    shards: Optional[dict] = None

    @property
    def converged(self) -> bool:
        return self.num_distinct >= self.target_solutions

    def best(self):
        if not self.solutions:
            return None
        return self.solutions[int(np.argmin(self.residuals))]


def _resolve_device(obj, device) -> torch.device:
    """An explicit ``device`` wins. Otherwise the card: a CUDA tensor stays
    on its own card, and any other input (numpy, scipy.sparse, lists, CPU
    tensors) goes to ``cuda``. The CPU runs only when asked for with
    ``device="cpu"``; without a card the default raises."""
    if device is not None:
        return torch.device(device)
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        return obj.device
    if not torch.cuda.is_available():
        raise RuntimeError('maus_tpu_torch runs on a CUDA card by default and '
                           'none is available; pass device="cpu" to run on '
                           'the CPU')
    return torch.device("cuda")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_finite(t: torch.Tensor) -> bool:
    t = torch.view_as_real(t) if t.is_complex() else t
    return bool(torch.isfinite(t).all())


def _stage_operand(matrix, compute_dtype: torch.dtype, device: torch.device,
                   problem_type: ProblemType = ProblemType.SOLVE_LINEAR_SYSTEM):
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
    if full.shape[0] != full.shape[1] and problem_type != ProblemType.SVD:
        raise ValueError(f"{problem_type.name} requires a square matrix, "
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


def eig_convergence_floor(dtype: torch.dtype, n: int) -> float:
    """In-loop floor of eigen residuals (relative to ‖A‖): 0 in complex128,
    min(max(50, √N)·ε₃₂, 1e-2) in complex64. The complex64 eigen residual
    floor is ~√N·ε·‖A‖, independent of κ; a κ-aware floor would accept
    crude vectors that the finisher then snaps onto shared eigenpairs."""
    if dtype == C128:
        return 0.0
    eps32 = float(np.finfo(np.float32).eps)
    return float(min(max(50.0, np.sqrt(n)) * eps32, 1e-2))


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0
    return abs(np.vdot(a, b)) / (na * nb)


def _final_dedup(cfg: SolverConfig, solutions: list,
                 residuals: list) -> tuple[list, list]:
    """Deterministic host-side final dedup over the gathered leaders, with a
    hysteresis band (×1.25) around the device's similarity threshold so that
    rounding-level differences cannot move a pair across it. Processed in
    residual order, best first; eigenpairs and triplets by the device's rules
    (value distance with the residual band, vector overlaps)."""
    BAND = 1.25
    vec_dup = 1.0 - BAND * (1.0 - cfg.vector_similarity_tol)
    order = sorted(range(len(solutions)), key=lambda i: residuals[i])
    kept_s, kept_r = [], []
    for i in order:
        sol, res = solutions[i], residuals[i]
        dup = False
        for ks, kr in zip(kept_s, kept_r):
            rband = 4.0 * (res + kr) if np.isfinite(res + kr) else 0.0
            if cfg.problem_type == ProblemType.EIGENVALUE:
                (lam, v), (lam2, v2) = sol, ks
                dup = (abs(lam - lam2) < BAND * (cfg.lambda_similarity_tol
                                                 + abs(lam2) * 1e-6) + rband
                       and _overlap(v, v2) > vec_dup)
            elif cfg.problem_type == ProblemType.SVD:
                (sig, u, v), (sig2, u2, v2) = sol, ks
                dup = (abs(sig - sig2) < BAND * (cfg.sigma_similarity_abs
                                                 + abs(sig2)
                                                 * cfg.sigma_similarity_rel)
                       + rband
                       and _overlap(u, u2) > vec_dup
                       and _overlap(v, v2) > vec_dup)
            else:
                dup = bool(np.linalg.norm(sol[0] - ks[0]) < BAND * 100.0 * cfg.tol)
            if dup:
                break
        if not dup:
            kept_s.append(sol)
            kept_r.append(res)
    return kept_s, kept_r


class MausSolver:
    """Population-based meta-heuristic solver for Ax=b, Ax=λx and the SVD
    (PyTorch port)."""

    # finisher chunk: each candidate factors its own (N, N) shifted system,
    # so bound the chunk's factorization workspace at about 2 GiB
    _REFINE_CHUNK = 8
    _REFINE_CHUNK_BYTES = 2 << 30

    def __init__(self, matrix, problem_type: ProblemType, b_vector=None,
                 initial_num_candidates: Optional[int] = None,
                 global_convergence_tol: float = 1e-8,
                 config: Optional[SolverConfig] = None, seed: int = 0,
                 knowledge: Optional[ProblemKnowledge] = None,
                 target_solutions: Optional[int] = None, device=None):
        with span("maus.entry"):
            problem_type = ProblemType(problem_type)
            linear = problem_type == ProblemType.SOLVE_LINEAR_SYSTEM
            if linear and b_vector is None:
                raise ValueError("SOLVE_LINEAR_SYSTEM requires b_vector")
            self.device = _resolve_device(matrix, device)
            compute_dtype = config.dtype if config is not None else \
                (C128 if self.device.type == "cpu" else torch.complex64)
            A_work = self._set_operand(matrix, compute_dtype, problem_type, knowledge)
            m, n = self.knowledge.shape

            if config is None:
                if initial_num_candidates is None:
                    initial_num_candidates = min(3 * max(m, n), 64)
                floor = convergence_floor(compute_dtype, self.knowledge.cond_estimate) \
                    if linear else eig_convergence_floor(compute_dtype, max(m, n))
                config = SolverConfig(
                    problem_type=problem_type,
                    num_candidates=int(initial_num_candidates),
                    tol=float(global_convergence_tol), dtype=compute_dtype,
                    convergence_floor=floor)
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
            self.target_solutions = min(
                default_target_solutions(config, self.knowledge), config.num_candidates)
            self.A = A_work if A_work.dtype == config.dtype else \
                self.A_true.to(config.dtype).contiguous()
            self.b = self.b_true = None
            if linear:
                self.b, self.b_true = _stage_rhs(b_vector, n, config.dtype, self.device)
            self._seed = int(seed)
            self._fac_cache = None
            self._A64 = None

    def _set_operand(self, matrix, compute_dtype: torch.dtype,
                     problem_type: ProblemType,
                     knowledge: Optional[ProblemKnowledge] = None) -> torch.Tensor:
        """Stage ``matrix`` on the solver's device and diagnose it (unless
        ``knowledge`` is given); sets ``A_host``, ``A_true`` and
        ``knowledge`` and returns the working-dtype copy."""
        with full_precision():
            A_host, A_work, A_true, exact = _stage_operand(
                matrix, compute_dtype, self.device, problem_type)
            self.knowledge = knowledge if knowledge is not None else diagnose(
                matrix if A_host is not None else None, problem_type,
                device_operand=A_work,
                device_full=A_true if A_true is not A_work else None,
                device_exact=exact)
        self.A_host, self.A_true = A_host, A_true
        return A_work

    def update_problem(self, matrix=None, b_vector=None) -> None:
        """Swap the operand and/or the right-hand side between runs (the
        reference's scenario 1 swaps both mid-run). A new matrix is staged
        and diagnosed exactly as the constructor does, so a swapped Hermitian
        operand takes the Hermitian path, and the target is re-derived; a
        b-only swap keeps the staged operand and its complex128 copy. A
        linear system's b must have the operand's length (ValueError); other
        problems take no b and ignore one. The cached factorization is
        dropped either way."""
        with span("maus.entry"):
            cfg = self.config
            if matrix is not None:
                self.A = self._set_operand(matrix, cfg.dtype, cfg.problem_type)
                self.target_solutions = min(
                    default_target_solutions(cfg, self.knowledge), cfg.num_candidates)
                self._A64 = None
            linear = cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM
            if b_vector is not None and linear:
                self.b, self.b_true = _stage_rhs(b_vector, self.knowledge.shape[-1],
                                                 cfg.dtype, self.device)
            self._fac_cache = None

    def evolve(self, max_iterations: int = 100, collect_metrics: bool = False,
               checkpoint_path: Optional[str] = None,
               resume_from: Optional[str] = None,
               checkpoint_every: Optional[int] = None,
               reopen: bool = False) -> SolutionReport:
        """Run the evolution loop, then take each distinct solution to tol
        with its finisher. ``max_iterations`` bounds the carry's total
        iteration count, a resumed one's included.

        ``collect_metrics``: return the per-iteration metrics in
        ``SolutionReport.metrics`` (one row per iteration up to
        ``max_iterations``, zero rows after the stop).
        ``resume_from``: continue from a carry saved by a run with
        ``checkpoint_path`` (same config and shapes).
        ``checkpoint_path``: save the carry there when the loop ends.
        ``checkpoint_every=k``: also save it every k iterations; the loop
        runs in chunks of k iterations of the same step, so a run resumed
        from any of these saves reproduces the uninterrupted run bit for
        bit.
        ``reopen``: the checkpoint was written before an
        ``update_problem`` swap; its convergence bookkeeping is reset and
        the carried factorization rebuilt against the current operand at
        the carried Ψ, so the population runs on against the new one."""
        if checkpoint_every is not None:
            if checkpoint_path is None:
                raise ValueError("checkpoint_every requires checkpoint_path")
            if int(checkpoint_every) < 1:
                raise ValueError(f"checkpoint_every must be >= 1, got "
                                 f"{checkpoint_every}")
        cfg, kn = self.config, self.knowledge
        timings = {}
        with full_precision():
            with span("maus.setup"):
                t0 = time.perf_counter()
                caches = evolve_mod._setup_caches(cfg, kn, self.A)
                _sync(self.device)
                timings["setup_s"] = time.perf_counter() - t0
            with span("maus.engine"):
                t0 = time.perf_counter()
                carry = None if resume_from is None else \
                    self._load_resume_carry(resume_from, reopen)
                every = max(max_iterations, 1) if checkpoint_every is None \
                    else int(checkpoint_every)
                carry, metrics = self._evolve_chunked(
                    max_iterations, collect_metrics, checkpoint_path, every, carry,
                    caches)
                del caches
                if checkpoint_path is not None:
                    save_state(checkpoint_path, carry)
                _sync(self.device)
                timings["engine_s"] = time.perf_counter() - t0
            with span("maus.finish"):
                t0 = time.perf_counter()
                pop, strat = carry.pop, carry.strat
                if cfg.problem_type == ProblemType.SVD:
                    # the run's last view of the effective rank, re-derived from
                    # the converged σ spectrum, supersedes the initial estimate
                    self.target_solutions = int(strat.target_dynamic)
                diag = strat_mod.compute_diagnostics(cfg, pop, strat,
                                                     self.target_solutions)
                leader = diag.distinct_leader.cpu().numpy()
                residual = pop.residual.cpu().numpy().astype(np.float64)
                order = np.argsort(np.where(np.isfinite(residual), residual, np.inf))
                leader_ks = [int(k) for k in order if leader[k]]
                solutions, residuals = [], []
                if cfg.problem_type == ProblemType.EIGENVALUE:
                    lam = pop.lam.cpu().numpy()
                    v = pop.v.cpu().numpy()
                    refined = self._refine_spectral(leader_ks, pop.lam, pop.v,
                                                    residual) \
                        if cfg.refine and leader_ks else {}
                    for k in leader_ks:
                        lam_k, v_k, r_k = refined.get(
                            k, (complex(lam[k]), v[k], float(residual[k])))
                        solutions.append((lam_k, v_k))
                        residuals.append(r_k)
                elif cfg.problem_type == ProblemType.SVD:
                    sig = pop.lam.real.cpu().numpy()
                    u, v = pop.u.cpu().numpy(), pop.v.cpu().numpy()
                    refined = self._refine_svd(leader_ks, pop, residual) \
                        if cfg.refine and leader_ks else {}
                    for k in leader_ks:
                        s_k, u_k, v_k, r_k = refined.get(
                            k, (float(sig[k]), u[k], v[k], float(residual[k])))
                        solutions.append((s_k, u_k, v_k))
                        residuals.append(r_k)
                else:
                    self._maybe_reuse_factors(carry)
                    for k in leader_ks:
                        xk, rel = pop.v[k], float(residual[k])
                        if cfg.refine:
                            xk, rel = self._refine_linear(xk)
                        solutions.append((xk.cpu().numpy(),))
                        residuals.append(rel)
                _sync(self.device)
                timings["finish_s"] = time.perf_counter() - t0
        solutions, residuals = _final_dedup(cfg, solutions, residuals)
        return SolutionReport(
            problem_type=cfg.problem_type, solutions=solutions,
            residuals=residuals, iterations=int(carry.iteration),
            num_distinct=len(solutions), target_solutions=self.target_solutions,
            landscape_energy=float(strat.landscape_energy), knowledge=kn,
            timings=timings, metrics=_metrics_dict(metrics))

    def _evolve_chunked(self, max_iterations: int, collect_metrics: bool,
                        checkpoint_path: str, every: int, carry, caches):
        """:func:`_drive_chunked` on this solver's problem."""
        return _drive_chunked(
            self.config, self.knowledge, self.A, self.b, self._seed,
            self.target_solutions, max_iterations, collect_metrics, every,
            carry, caches,
            lambda c: save_state(checkpoint_path, c))

    def _load_resume_carry(self, path: str, reopen: bool):
        """The carry saved at ``path``, loaded against a template of this
        solver's carry (no O(N³) factorization is computed for the
        template). With ``reopen``, :func:`_reopen_carry`, and the carried
        factorization, which belongs to the old operand, rebuilt against the
        current one at the carried Ψ."""
        cfg, kn = self.config, self.knowledge
        template = evolve_mod.init_carry(cfg, kn, self.A, self._seed, template=True)
        carry = load_state(path, template, device=self.device)
        if reopen:
            carry = _reopen_carry(cfg, carry)
            if carry.fac is not None:
                carry.fac = evolve_mod._refactor(kn, self.A, carry.psi_cached)
        return carry

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
            with span("maus.factor"):
                self._fac_cache = shared_factor_qr(self.A, cfg.psi_base)
        x = x.to(cfg.dtype)
        xs, rel = refine_split(self.A_true, self._fac_cache, self.b_true, x,
                               steps=cfg.max_refine_steps, tol=cfg.tol * 0.3)
        if rel > cfg.tol:
            with span("maus.refine.gmres"):
                xs2, rel2 = refine_gmres(self.A_true, self._fac_cache, self.b_true,
                                         xs.to(cfg.dtype), steps=cfg.max_refine_steps,
                                         tol=cfg.tol * 0.3)
            if rel2 < rel:
                xs, rel = xs2, rel2
        return xs, rel

    # -- eigenpair finisher ---------------------------------------------------
    def _refine_chunk(self, dtype: Optional[torch.dtype] = None) -> int:
        """Finisher batch size: the chunk's per-candidate (N, N) factors stay
        within ``_REFINE_CHUNK_BYTES``, at most ``_REFINE_CHUNK`` of them in
        the working dtype; a wider ``dtype``'s chunk holds no more bytes
        than that."""
        n = max(self.knowledge.shape)
        work = torch.empty((), dtype=self.config.dtype).element_size()
        wide = torch.empty((), dtype=dtype or self.config.dtype).element_size()
        chunk = max(1, min(self._REFINE_CHUNK,
                           self._REFINE_CHUNK_BYTES // (n * n * work)))
        return max(1, chunk * work // wide)

    def _get_A64(self) -> torch.Tensor:
        """The original operand in complex128 on the device, built once."""
        if self._A64 is None:
            self._A64 = self.A_true.to(C128)
        return self._A64

    def _refine_batch(self, ks: list, lam: torch.Tensor, V: torch.Tensor,
                      best: dict, psi_rel: Optional[float] = None,
                      dtype: Optional[torch.dtype] = None) -> None:
        """Run the finisher over the candidates ``ks`` (rows of ``lam``/``V``
        in the same order) in chunks, its factorizations in ``dtype``
        (default: the working dtype); a result replaces ``best[k]`` when its
        residual is finite and lower. ``best[k]`` is (λ, v, residual)."""
        kw = {} if psi_rel is None else {"psi_rel": psi_rel}
        dtype = dtype or self.config.dtype
        CH = self._refine_chunk(dtype)
        A64 = self._get_A64()
        for i in range(0, len(ks), CH):
            chunk = ks[i:i + CH]
            with span("maus.refine_eig.round"):
                lam_s, V_s, res = refine_eigenpairs(
                    A64, lam[i:i + CH].to(dtype), V[i:i + CH].to(dtype), steps=5,
                    **kw)
                lam_h, V_h, res_h = lam_s.cpu().numpy(), V_s.cpu().numpy(), \
                    res.cpu().numpy()
            for j, k in enumerate(chunk):
                if np.isfinite(res_h[j]) and res_h[j] < best[k][2]:
                    best[k] = (complex(lam_h[j]), V_h[j], float(res_h[j]))

    def _refine_svd(self, ks: list, pop, residual: np.ndarray) -> dict:
        """Finish the SVD leaders ``ks`` against the original operand in
        FP64, in chunks. Returns {slot: (σ, u, v, residual)} for the slots
        whose residual the finisher lowered."""
        out = {}
        CH = self._refine_chunk()
        A64 = self._get_A64()
        dt = self.config.dtype
        for i in range(0, len(ks), CH):
            chunk = ks[i:i + CH]
            idx = torch.tensor(chunk, device=pop.v.device)
            with span("maus.refine_svd.round"):
                sig, U, V, res = refine_svd_triplets(
                    A64, pop.lam[idx].to(dt), pop.u[idx].to(dt), pop.v[idx].to(dt),
                    steps=5)
                sig_h, U_h, V_h, res_h = (sig.cpu().numpy(), U.cpu().numpy(),
                                          V.cpu().numpy(), res.cpu().numpy())
            for j, k in enumerate(chunk):
                if np.isfinite(res_h[j]) and res_h[j] < residual[k]:
                    out[k] = (float(sig_h[j]), U_h[j], V_h[j], float(res_h[j]))
        return out

    def _refine_spectral(self, ks: list, lam: torch.Tensor, V: torch.Tensor,
                         residual: np.ndarray) -> dict:
        """Finish the eigenpair leaders ``ks`` against the original operand
        in FP64. Returns {slot: (λ, v, residual)} for the slots the finisher
        improved. Pairs still above tol after the standard rounds get a
        small-ψ escalation (``psi_rel`` = 1e-10): ψ perturbs the Newton
        Jacobian, which stalls pseudospectrally ill-conditioned pairs of
        non-normal operands. When that leaves fewer than the target at tol,
        the pairs still above it (stragglers, each counted by a
        ``maus.eig.straggler`` span) take one more small-ψ round whose
        factorizations are complex128: near some eigenvalues of a large
        operand the working-dtype LU's error alone keeps Newton from
        contracting (at 4096² it stalls at a few 1e-8), where in complex128
        it contracts quadratically."""
        idx = torch.tensor(ks, device=V.device)
        best = {k: (None, None, float(residual[k])) for k in ks}

        def above_tol():
            return [k for k in ks if not (np.isfinite(best[k][2])
                                          and best[k][2] <= max(self.config.tol, 0.0))]

        def rerun(fail, dtype=None):
            """The finisher again on ``fail`` from each one's best state."""
            lam_f = torch.stack([
                torch.tensor(best[k][0], dtype=C128) if best[k][0] is not None
                else lam[k].cpu().to(C128) for k in fail]).to(V.device)
            V_f = torch.stack([
                torch.from_numpy(best[k][1]) if best[k][1] is not None
                else V[k].cpu().to(C128) for k in fail]).to(V.device)
            self._refine_batch(fail, lam_f, V_f, best, psi_rel=1e-10, dtype=dtype)

        self._refine_batch(ks, lam[idx], V[idx], best)
        fail = above_tol()
        if fail:
            rerun(fail)
            fail = above_tol()
        if fail and len(ks) - len(fail) < self.target_solutions \
                and self.config.dtype != C128:
            for _ in fail:
                with span("maus.eig.straggler"):
                    pass
            rerun(fail, dtype=C128)
        return {k: b for k, b in best.items() if b[0] is not None}


def _drive_chunked(cfg: SolverConfig, kn: ProblemKnowledge, A, b, seed: int,
                   target: int, max_iterations: int, collect_metrics: bool,
                   every: int, carry, caches, save):
    """The loop from ``carry`` in chunks of ``every`` iterations (one chunk
    without ``checkpoint_every``), ``save(carry)`` at each chunk's end but
    the last (which the caller saves). The chunks stop where one loop
    stops: the same stop condition is read after each (an SVD's against its
    dynamic target). A ``carry`` of None starts a fresh one, which the first
    chunk's loop builds (``evolve._loop``). A run that reaches
    ``max_iterations`` with its stop condition unmet opens the count
    ``maus.engine.capped`` once. Returns ``(carry, stacked metrics or
    None)``."""
    def run(bound, with_metrics, carry0):
        args = (cfg, kn, A, b, seed, bound, target)
        kw = dict(carry0=carry0, caches=caches)
        if with_metrics:
            return evolve_mod.evolve_metrics(*args, **kw)
        return evolve_mod.evolve_while(*args, **kw), None

    chunks, bound = [], 0 if carry is None else int(carry.iteration)
    while carry is None or bound < max_iterations:
        # a chunk that did not stop early ends at its bound: the next begins there
        begin, bound = bound, min(bound + every, max_iterations)
        carry, m = run(bound, collect_metrics, carry)
        if m is not None:   # the rows of the iterations that ran
            ran = int(carry.iteration) - begin
            chunks.append(evolve_mod.map_metrics(lambda x: x[:ran], m))
        if bound >= max_iterations or bool(evolve_mod._stop_condition(
                cfg, target, carry)):
            break   # the caller saves the last carry
        save(carry)
    if int(carry.iteration) >= max_iterations and not bool(
            evolve_mod._stop_condition(cfg, target, carry)):
        with span("maus.engine.capped"):
            pass
    if not collect_metrics:
        return carry, None
    # then zero rows up to max_iterations, as one loop gives them
    chunks.append(run(max_iterations, True, carry)[1])
    return carry, evolve_mod.map_metrics(lambda *xs: torch.cat(xs), *chunks)


def _metrics_dict(metrics) -> Optional[dict]:
    """Stacked metrics as numpy arrays by field name (``None`` stays)."""
    if metrics is None:
        return None
    return {f.name: getattr(metrics, f.name).cpu().numpy()
            for f in dataclasses.fields(metrics)}


def _reopen_carry(cfg: SolverConfig, carry):
    """A restored carry reopened against a swapped operand (the reference's
    scenario-1 swap runs the same population on against the new system).
    Its convergence bookkeeping refers to the old operand: converged
    candidates drop to REFINING, keeping their iterates as warm starts, with
    α back at its initial value; the residuals, the distinct count and the
    stop counters reset."""
    pop = carry.pop
    conv = pop.status == int(CandidateStatus.CONVERGED)
    inf = torch.full_like(pop.residual, float("inf"))
    pop = dataclasses.replace(
        pop,
        status=torch.where(conv, torch.full_like(pop.status,
                                                 int(CandidateStatus.REFINING)),
                           pop.status),
        alpha=torch.where(conv, torch.full_like(pop.alpha, cfg.alpha_initial),
                          pop.alpha),
        residual=inf, prev_residual=inf.clone())
    strat = dataclasses.replace(
        carry.strat, num_distinct=torch.zeros_like(carry.strat.num_distinct))
    return dataclasses.replace(
        carry, pop=pop, strat=strat,
        best_residual=torch.full_like(carry.best_residual, float("inf")),
        stall_count=torch.zeros_like(carry.stall_count))


def _mesh_model_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(MODEL_AXIS)


def _one_device(device, mesh):
    """The device of a run without a model axis: the caller's, else a
    mesh's own (``None``: the default card)."""
    return device if device is not None or mesh is None else mesh.device


def solve(A, b, tol: float = 1e-8, max_iterations: int = 100,
          num_candidates: Optional[int] = None, seed: int = 0,
          config: Optional[SolverConfig] = None,
          checkpoint_path: Optional[str] = None,
          resume_from: Optional[str] = None,
          checkpoint_every: Optional[int] = None,
          device=None, mesh=None) -> SolutionReport:
    """Solve Ax = b on ``device`` (default: the card — a CUDA tensor's own,
    else ``cuda``; pass ``device="cpu"`` to run on the CPU).
    ``checkpoint_path``, ``resume_from``, ``checkpoint_every``: as in
    :meth:`MausSolver.evolve`.

    ``mesh``: a ``parallel.mesh.Mesh`` with a model axis of size > 1. Every
    rank calls ``solve`` with the same arguments (``parallel/launch.py``);
    the population engine then runs with the shared factorization
    column-sharded over the ranks (``dist_qr``), and refinement certifies
    with kernel K1 on each rank's shard. Every rank returns the report."""
    if _mesh_model_size(mesh) > 1:
        return _solve_mesh(A, b, mesh, tol, max_iterations, num_candidates,
                           seed, config, checkpoint_path=checkpoint_path,
                           resume_from=resume_from,
                           checkpoint_every=checkpoint_every)
    s = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed,
                   device=_one_device(device, mesh))
    return s.evolve(max_iterations, checkpoint_path=checkpoint_path,
                    resume_from=resume_from, checkpoint_every=checkpoint_every)


def eig(A, tol: float = 1e-8, max_iterations: int = 200,
        num_candidates: Optional[int] = None, seed: int = 0,
        config: Optional[SolverConfig] = None,
        target_solutions: Optional[int] = None,
        knowledge: Optional[ProblemKnowledge] = None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        device=None, mesh=None) -> SolutionReport:
    """Eigenpairs of a square A on ``device`` (default: the card, as for
    :func:`solve`). A general A runs against its shared Hessenberg form; a
    Hermitian A snaps to a shared eigh when dense and N ≤
    ``config.eigh_max_n``, else runs a deflated Lanczos per candidate.
    ``target_solutions``: how many distinct pairs to search for (default N,
    clamped to the number of candidates). ``knowledge``: a precomputed
    :class:`ProblemKnowledge`, which skips the diagnosis. The checkpoint
    arguments: as in :meth:`MausSolver.evolve`.

    ``mesh`` (model axis > 1, every rank calling): the engine runs with A
    and its Hessenberg form column-sharded, every shifted solve (Hermitian
    operands too) through ``dist_solve_shifted``, then the distributed FP64
    Newton finisher; ``knowledge`` is not used there."""
    if _mesh_model_size(mesh) > 1:
        return _eig_mesh(A, mesh, tol, max_iterations, num_candidates, seed,
                         config, checkpoint_path=checkpoint_path,
                         resume_from=resume_from,
                         checkpoint_every=checkpoint_every,
                         target_solutions=target_solutions)
    s = MausSolver(A, ProblemType.EIGENVALUE,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed,
                   target_solutions=target_solutions, knowledge=knowledge,
                   device=_one_device(device, mesh))
    return s.evolve(max_iterations, checkpoint_path=checkpoint_path,
                    resume_from=resume_from, checkpoint_every=checkpoint_every)


def svd(A, tol: float = 1e-6, max_iterations: int = 300,
        num_candidates: Optional[int] = None, seed: int = 0,
        config: Optional[SolverConfig] = None,
        target_solutions: Optional[int] = None,
        knowledge: Optional[ProblemKnowledge] = None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        device=None, mesh=None) -> SolutionReport:
    """Singular triplets (σ, u, v) of an (M, N) operand A on ``device``
    (default: the card, as for :func:`solve`). ``target_solutions``: how
    many distinct triplets to search for (default the diagnosed effective
    rank, clamped to the number of candidates); the run re-derives the
    target from the converged σ spectrum and reports its last value.
    ``knowledge``: a precomputed :class:`ProblemKnowledge`, which skips the
    diagnosis. The checkpoint arguments: as in :meth:`MausSolver.evolve`.

    ``mesh`` (model axis > 1, every rank calling): the engine runs with A
    column-sharded (N divisible by the model size), then the
    factorization-free distributed Newton finisher."""
    if _mesh_model_size(mesh) > 1:
        return _svd_mesh(A, mesh, tol, max_iterations, num_candidates, seed,
                         config, checkpoint_path=checkpoint_path,
                         resume_from=resume_from,
                         checkpoint_every=checkpoint_every,
                         target_solutions=target_solutions)
    s = MausSolver(A, ProblemType.SVD,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed,
                   target_solutions=target_solutions, knowledge=knowledge,
                   device=_one_device(device, mesh))
    return s.evolve(max_iterations, checkpoint_path=checkpoint_path,
                    resume_from=resume_from, checkpoint_every=checkpoint_every)


# ---------------------------------------------------------------------------
# The mesh paths: the same engine over a column-sharded operand
# ---------------------------------------------------------------------------

def _check_divisible(kind: str, n: int, mesh) -> None:
    m = _mesh_model_size(mesh)
    if n % m != 0:
        raise ValueError(f"distributed {kind} needs N divisible by the model "
                         f"axis: N={n}, model={m}")


def _mesh_config(config: Optional[SolverConfig], problem_type: ProblemType,
                 **defaults) -> SolverConfig:
    """The caller's config for ``problem_type``, else the mesh defaults."""
    if config is None:
        return SolverConfig(problem_type=problem_type, **defaults)
    return dataclasses.replace(config, problem_type=problem_type)


def mesh_convergence_floor(cdtype: torch.dtype) -> float:
    """In-loop floor of the mesh linear path: 50·ε of the working dtype,
    the JAX mesh rule (``maus_tpu/solver/api.py:1121``). It is not the
    single-device :func:`convergence_floor`: for a complex64 κ = 1e6 system
    that one is 2κ·ε₃₂ ≈ 0.24 and this one 6e-6, below what the working
    dtype reaches, so the mesh engine runs to its stall limit before
    refinement takes the best candidate on (ROADMAP Queue 3)."""
    return 50 * float(torch.finfo(cdtype.to_real()).eps)


def _spectral_floor(cdtype: torch.dtype, n: int) -> float:
    """In-loop floor of the mesh eig and SVD paths, relative to the operand
    scale: min(max(50, √N)·ε, 1e-2) of the working dtype (the JAX mesh
    rule; it is the port's ``eig_convergence_floor`` for complex64, and
    not 0 for complex128)."""
    eps_c = float(torch.finfo(cdtype.to_real()).eps)
    return float(min(max(50.0, np.sqrt(n)) * eps_c, 1e-2))


def _load_mesh_carry(cfg, kn, A_op, seed, path, reopen):
    """The mesh carry saved at ``path``, loaded against a template whose
    sharded factors are meta tensors of this rank's shard shapes. With
    ``reopen``, :func:`_reopen_carry` and the carried factorization rebuilt
    against the current operand at the carried Ψ."""
    template = evolve_mod.init_carry(cfg, kn, A_op, seed, template=True)
    carry = load_state(path, template, device=A_op.device, mesh=A_op.mesh)
    if reopen:
        carry = _reopen_carry(cfg, carry)
        if carry.fac is not None:
            carry.fac = evolve_mod._refactor(kn, A_op, carry.psi_cached)
    return carry


def _mesh_hosted_drive(cfg, kn, A_op, b, seed, max_iterations, target,
                       caches=None, checkpoint_path=None,
                       checkpoint_every=None, resume_from=None, reopen=False,
                       collect_metrics=False):
    """The mesh counterpart of :meth:`MausSolver.evolve`'s loop: the same
    chunks (:func:`_drive_chunked`) and resume protocol, the carry saved
    sharded (``utils/checkpoint``). ``max_iterations`` bounds the total
    iteration count; ``A_op`` is the column-sharded operand, which carries
    the mesh. Returns ``(carry, metrics, engine seconds)``."""
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every requires checkpoint_path")
        if int(checkpoint_every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{checkpoint_every}")
    mesh = A_op.mesh
    with span("maus.engine"):
        t0 = time.perf_counter()
        carry = _load_mesh_carry(cfg, kn, A_op, seed, resume_from, reopen) \
            if resume_from is not None else None
        every = max(max_iterations, 1) if checkpoint_every is None \
            else int(checkpoint_every)
        carry, metrics = _drive_chunked(
            cfg, kn, A_op, b, seed, target, max_iterations, collect_metrics, every,
            carry, caches, lambda c: save_state(checkpoint_path, c, mesh=mesh))
        if checkpoint_path is not None:
            save_state(checkpoint_path, carry, mesh=mesh)
        _sync(A_op.device)
        return carry, metrics, time.perf_counter() - t0


def _shapes(**tensors) -> dict:
    """The shapes of a mesh run's shards, by name, for its report."""
    return {k: tuple(t.shape) for k, t in tensors.items()}


def _leaders(cfg, carry, target):
    """Slots of the distinct leaders, best residual first, and the host
    copy of the residuals."""
    diag = strat_mod.compute_diagnostics(cfg, carry.pop, carry.strat, target)
    leader = diag.distinct_leader.cpu().numpy()
    residual = carry.pop.residual.cpu().numpy().astype(np.float64)
    order = np.argsort(np.where(np.isfinite(residual), residual, np.inf))
    return [int(k) for k in order if leader[k]], residual


def _solve_mesh(A, b, mesh, tol, max_iterations, num_candidates, seed,
                config, checkpoint_path=None, resume_from=None,
                checkpoint_every=None, reopen=False, staged=None,
                collect_metrics=False) -> SolutionReport:
    """Linear solve over the mesh: the engine with the column-sharded
    ``dist_qr`` factorization, then distributed refinement of the best
    candidate against the user's system (K1 on each rank's shard).
    ``staged``: ``(A_loc, b_work, A_true_loc, b_true)`` from
    ``dist_qr.stage_operands`` (``MeshSolver`` stages once)."""
    n = A.shape[0] if staged is None else staged[0].shape[0]
    _check_divisible("solve", n, mesh)
    with full_precision():
        if staged is None:
            staged = stage_operands(mesh, A, b,
                                    dtype=config.dtype if config else None)
        A_loc, b_work, A_true, b_true = staged
        block = panel_block(A_loc.shape[1])
        cdtype = A_loc.dtype
        cfg = _mesh_config(config, ProblemType.SOLVE_LINEAR_SYSTEM,
                           num_candidates=num_candidates or 16, tol=tol,
                           dtype=cdtype,
                           convergence_floor=mesh_convergence_floor(cdtype),
                           refine=True)
        kn = ProblemKnowledge(shape=(n, n))
        A_op = place_operands(mesh, A_loc)
        carry, metrics, engine_s = _mesh_hosted_drive(
            cfg, kn, A_op, b_work, seed, max_iterations, 1,
            checkpoint_path=checkpoint_path,
            resume_from=resume_from, checkpoint_every=checkpoint_every,
            reopen=reopen, collect_metrics=collect_metrics)
        t0 = time.perf_counter()
        res = carry.pop.residual
        x0 = carry.pop.v[int(torch.argmin(torch.where(
            torch.isfinite(res), res, torch.full_like(res, float("inf")))))]
        x, rel = refine_distributed(mesh, carry.fac, A_true, b_true, x0, block,
                                    cfg.max_refine_steps, tol * 0.3)
        x = x.cpu().numpy()
        finish_s = time.perf_counter() - t0
    return SolutionReport(
        problem_type=ProblemType.SOLVE_LINEAR_SYSTEM, solutions=[(x,)],
        residuals=[rel], iterations=int(carry.iteration),
        num_distinct=1 if rel <= tol else 0, target_solutions=1,
        landscape_energy=float(carry.strat.landscape_energy), knowledge=kn,
        timings=dict(setup_s=0.0, engine_s=engine_s, finish_s=finish_s),
        metrics=_metrics_dict(metrics),
        shards=_shapes(A=A_op.local, A_true=A_true, Q=carry.fac.q, R=carry.fac.r))


def _eig_mesh(A, mesh, tol, max_iterations, num_candidates, seed, config,
              checkpoint_path=None, resume_from=None, checkpoint_every=None,
              reopen=False, staged=None, hess=None, collect_metrics=False,
              target_solutions=None) -> SolutionReport:
    """eig over the mesh: the engine with every shifted solve through the
    column-sharded Hessenberg form (built once here unless ``hess`` is
    given), then the distributed Newton finisher on the distinct leaders.
    ``staged``: ``(A_loc, A64_loc)`` from ``dist_refine.stage_spectral``."""
    n = A.shape[0] if staged is None else staged[0].shape[0]
    _check_divisible("eig", n, mesh)
    with full_precision():
        if staged is None:
            staged = stage_spectral(mesh, A, dtype=config.dtype if config else None)
        A_loc, A64 = staged
        if A_loc.shape[0] != n or A_loc.shape[1] * _mesh_model_size(mesh) != n:
            raise ValueError(f"EIGENVALUE requires a square matrix, got "
                             f"({A_loc.shape[0]}, "
                             f"{A_loc.shape[1] * _mesh_model_size(mesh)})")
        cdtype = A_loc.dtype
        cfg = _mesh_config(config, ProblemType.EIGENVALUE,
                           num_candidates=num_candidates or
                           min(max(8, 2 * int(np.sqrt(n))), 32),
                           tol=tol, dtype=cdtype,
                           convergence_floor=_spectral_floor(cdtype, n))
        kn = ProblemKnowledge(shape=(n, n))
        target = min(n, cfg.num_candidates, target_solutions or n)
        t0 = time.perf_counter()
        if hess is None:
            hess = dist_hessenberg(mesh, A_loc)
        _sync(A_loc.device)
        setup_s = time.perf_counter() - t0
        A_op = place_operands(mesh, A_loc)
        carry, metrics, engine_s = _mesh_hosted_drive(
            cfg, kn, A_op, None, seed, max_iterations,
            target, caches=evolve_mod.Caches(hess=hess),
            checkpoint_path=checkpoint_path, resume_from=resume_from,
            checkpoint_every=checkpoint_every, reopen=reopen,
            collect_metrics=collect_metrics)
        t0 = time.perf_counter()
        pop = carry.pop
        leader_ks, residual = _leaders(cfg, carry, target)
        lam, v = pop.lam.cpu().numpy(), pop.v.cpu().numpy()
        solutions, residuals = [], []
        refined = None
        if leader_ks and cfg.refine:
            idx = torch.tensor(leader_ks, device=pop.v.device)
            refined = [t.cpu().numpy() for t in dist_refine_eigenpairs(
                mesh, hess, A64, pop.lam[idx], pop.v[idx], steps=5)]
        for j, k in enumerate(leader_ks):
            if refined is not None and np.isfinite(refined[2][j]) and \
                    refined[2][j] < residual[k]:
                solutions.append((complex(refined[0][j]), refined[1][j]))
                residuals.append(float(refined[2][j]))
            else:
                solutions.append((complex(lam[k]), v[k].astype(np.complex128)))
                residuals.append(float(residual[k]))
        finish_s = time.perf_counter() - t0
    solutions, residuals = _final_dedup(cfg, solutions, residuals)
    return SolutionReport(
        problem_type=ProblemType.EIGENVALUE, solutions=solutions,
        residuals=residuals, iterations=int(carry.iteration),
        num_distinct=len(solutions), target_solutions=target,
        landscape_energy=float(carry.strat.landscape_energy), knowledge=kn,
        timings=dict(setup_s=setup_s, engine_s=engine_s, finish_s=finish_s),
        metrics=_metrics_dict(metrics),
        shards=_shapes(A=A_op.local, A64=A64, H=hess.h, Q=hess.q))


def _svd_mesh(A, mesh, tol, max_iterations, num_candidates, seed, config,
              checkpoint_path=None, resume_from=None, checkpoint_every=None,
              reopen=False, staged=None, collect_metrics=False,
              target_solutions=None) -> SolutionReport:
    """SVD over the mesh: the engine with A column-sharded (the block
    round's products through the sharded operand), then the
    factorization-free distributed Newton finisher on the distinct
    leaders."""
    if staged is None:
        mr, n = A.shape[0], A.shape[1]
    else:
        mr, n = staged[0].shape[0], staged[0].shape[1] * _mesh_model_size(mesh)
    _check_divisible("svd", n, mesh)
    with full_precision():
        if staged is None:
            staged = stage_spectral(mesh, A, dtype=config.dtype if config else None)
        A_loc, A64 = staged
        cdtype = A_loc.dtype
        cfg = _mesh_config(config, ProblemType.SVD,
                           num_candidates=num_candidates or
                           min(max(4, min(mr, n) // 2), 16),
                           tol=tol, dtype=cdtype,
                           convergence_floor=_spectral_floor(cdtype, max(mr, n)))
        if target_solutions is not None:
            cfg = dataclasses.replace(cfg, target_num_solutions=int(target_solutions))
        kn = ProblemKnowledge(shape=(mr, n))
        target0 = min(default_target_solutions(cfg, kn), cfg.num_candidates)
        A_op = place_operands(mesh, A_loc)
        carry, metrics, engine_s = _mesh_hosted_drive(
            cfg, kn, A_op, None, seed, max_iterations,
            target0, checkpoint_path=checkpoint_path,
            resume_from=resume_from, checkpoint_every=checkpoint_every,
            reopen=reopen, collect_metrics=collect_metrics)
        t0 = time.perf_counter()
        pop = carry.pop
        # the run's last view of the effective rank supersedes the first
        target = min(int(carry.strat.target_dynamic), target0)
        leader_ks, residual = _leaders(cfg, carry, target)
        sig = pop.lam.real.cpu().numpy()
        u, v = pop.u.cpu().numpy(), pop.v.cpu().numpy()
        solutions, residuals = [], []
        refined = None
        if leader_ks and cfg.refine:
            idx = torch.tensor(leader_ks, device=pop.v.device)
            refined = [t.cpu().numpy() for t in dist_refine_svd(
                mesh, A_loc, A64, pop.lam[idx], pop.u[idx], pop.v[idx],
                steps=5)]
        for j, k in enumerate(leader_ks):
            if refined is not None and np.isfinite(refined[3][j]) and \
                    refined[3][j] < residual[k]:
                solutions.append((float(refined[0][j]), refined[1][j],
                                  refined[2][j]))
                residuals.append(float(refined[3][j]))
            else:
                solutions.append((float(sig[k]), u[k].astype(np.complex128),
                                  v[k].astype(np.complex128)))
                residuals.append(float(residual[k]))
        finish_s = time.perf_counter() - t0
    solutions, residuals = _final_dedup(cfg, solutions, residuals)
    return SolutionReport(
        problem_type=ProblemType.SVD, solutions=solutions,
        residuals=residuals, iterations=int(carry.iteration),
        num_distinct=len(solutions), target_solutions=target,
        landscape_energy=float(carry.strat.landscape_energy),
        knowledge=ProblemKnowledge(shape=(mr, n), effective_rank=target),
        timings=dict(setup_s=0.0, engine_s=engine_s, finish_s=finish_s),
        metrics=_metrics_dict(metrics), shards=_shapes(A=A_op.local, A64=A64))


class MeshSolver:
    """Stateful entry point of the mesh paths, the :class:`MausSolver` surface
    (``evolve`` with checkpoint/resume and metrics, ``update_problem``) for
    operands column-sharded over a mesh's model axis. Every rank constructs
    it and calls its methods with the same arguments. Operands are staged
    once, as shards, and reused by every ``evolve``; an eigenproblem's
    Hessenberg form is built on the first ``evolve`` and kept until the
    matrix changes.

    ``update_problem`` re-stages each changed operand from the user's data
    (the working copy and the full-precision one refinement certifies
    against). A resume of a checkpoint written before a swap reopens the
    carry (``_reopen_carry``) so the population runs on against the new
    system; a checkpoint written after the last swap resumes bit-exactly.
    """

    def __init__(self, matrix, problem_type: ProblemType, mesh,
                 b_vector=None, initial_num_candidates: Optional[int] = None,
                 global_convergence_tol: float = 1e-8,
                 config: Optional[SolverConfig] = None, seed: int = 0):
        self.problem_type = ProblemType(problem_type)
        if _mesh_model_size(mesh) <= 1:
            raise ValueError("MeshSolver needs a mesh with a 'model' axis "
                             "of size > 1 (use MausSolver otherwise)")
        if self.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM and \
                b_vector is None:
            raise ValueError("SOLVE_LINEAR_SYSTEM requires b_vector")
        self.mesh = mesh
        self.tol = float(global_convergence_tol)
        self.num_candidates = initial_num_candidates
        self.config = config
        self.seed = seed
        self._stA = self._stb = self._hess = None
        # operand epoch: bumped by every real swap; a checkpoint remembers
        # the epoch it was written under, so a resume reopens the carry iff
        # the operand changed since
        self._epoch = 0
        self._ckpt_epochs: dict = {}
        self.update_problem(matrix=matrix, b_vector=b_vector)
        self._epoch = 0          # constructor staging is not a swap

    def update_problem(self, matrix=None, b_vector=None) -> None:
        """Swap operands between runs (the reference's scenario 1): each
        changed operand is staged from the user's data as at construction;
        an unchanged one keeps its shards. ``b_vector`` applies only to a
        linear system (``ValueError`` otherwise)."""
        if self.problem_type != ProblemType.SOLVE_LINEAR_SYSTEM and \
                b_vector is not None:
            raise ValueError("b_vector only applies to SOLVE_LINEAR_SYSTEM "
                             "problems")
        dtype = self.config.dtype if self.config is not None else None
        changed = False
        if self.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
            if matrix is not None:
                _check_divisible("solve", matrix.shape[0], self.mesh)
                self._stA = stage_A(self.mesh, matrix, dtype)
                changed = True
            if b_vector is not None:
                self._stb = stage_b(self.mesh, b_vector,
                                    self._stA[0].shape[0], dtype)
                changed = True
        elif matrix is not None:
            _check_divisible(self.problem_type.name.lower(), matrix.shape[-1],
                             self.mesh)
            self._stA = stage_spectral(self.mesh, matrix, dtype)
            self._hess = None    # the cached reduction is of the old operand
            changed = True
        if changed:
            self._epoch += 1

    def evolve(self, max_iterations: int = 100, collect_metrics: bool = False,
               checkpoint_path: Optional[str] = None,
               resume_from: Optional[str] = None,
               checkpoint_every: Optional[int] = None,
               reopen: Optional[bool] = None) -> SolutionReport:
        """Run the mesh engine and the distributed finishers; the arguments
        of :meth:`MausSolver.evolve`. ``reopen=None`` decides from the
        operand epochs: a resumed checkpoint reopens iff ``update_problem``
        changed an operand since it was written (a checkpoint of another
        solver, whose epoch is unknown, reopens iff any swap happened)."""
        if reopen is None:
            saved = self._ckpt_epochs.get(resume_from)
            reopen = resume_from is not None and (
                self._epoch > 0 if saved is None else saved != self._epoch)
        kw = dict(checkpoint_path=checkpoint_path, resume_from=resume_from,
                  checkpoint_every=checkpoint_every,
                  collect_metrics=collect_metrics, reopen=reopen)
        common = (self.mesh, self.tol, max_iterations, self.num_candidates,
                  self.seed, self.config)
        if self.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
            (A_loc, A_true), (b_work, b_true) = self._stA, self._stb
            rep = _solve_mesh(None, None, *common,
                              staged=(A_loc, b_work, A_true, b_true), **kw)
        elif self.problem_type == ProblemType.EIGENVALUE:
            if self._hess is None:
                with full_precision():
                    self._hess = dist_hessenberg(self.mesh, self._stA[0])
            rep = _eig_mesh(None, *common, staged=self._stA, hess=self._hess,
                            **kw)
        else:
            rep = _svd_mesh(None, *common, staged=self._stA, **kw)
        if checkpoint_path is not None:
            self._ckpt_epochs[checkpoint_path] = self._epoch
        return rep
