"""Core types of the PyTorch port of MAUS.

Counterpart of ``maus_tpu/core/types.py``. The static configuration
(:class:`SolverConfig`) stays a frozen dataclass; the per-iteration state
(:class:`Population`, :class:`StrategyState`) is a dataclass of tensors over a
fixed-capacity candidate axis, so every per-candidate operation is one batched
tensor op. Every scalar of the strategy keeps the reference's dtype (float32 or
int32): the Ψ rung quantization (``solver/evolve.py``) rounds log10 of a
float32, and a wider scalar would move the rung on different iterations.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np
import torch


class ProblemType(enum.IntEnum):
    """Problem classes (reference ``ProblemType``)."""

    EIGENVALUE = 0
    SOLVE_LINEAR_SYSTEM = 1
    SVD = 2


class CandidateStatus(enum.IntEnum):
    """Candidate lifecycle states, stored as an int8 field of the population."""

    EXPLORING = 0
    REFINING = 1
    STUCK = 2
    CONVERGED = 3
    RETIRED = 4


class SolverPreference(enum.IntEnum):
    """Local-solver dispatch preference (int32 code in :class:`StrategyState`)."""

    DIRECT = 0
    GMRES = 1


class StabilityState(enum.IntEnum):
    """Global stability classification."""

    STABLE = 0
    FRAGILE = 1
    CRITICAL = 2


def as_torch_dtype(dtype) -> torch.dtype:
    """Accept a ``torch.dtype``, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


# effective-rank cut σ/σ_max: module-level so that the host-side rank probe
# (solver/diagnose.py, which runs before a config exists) and the config
# default cannot drift apart
RANK_REL_CUT = 1e-4


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration; defaults as in the JAX package.

    Only the fields the ported paths read are here. Not carried over:
    ``host_refactor``, which exists only for XLA:TPU's 16 MB scoped-VMEM
    cap on conditional branches (the port refactorizes in ordinary Python
    control flow at any size).
    One default differs: ``max_refine_steps`` (see its comment).
    """

    problem_type: ProblemType = ProblemType.SOLVE_LINEAR_SYSTEM
    num_candidates: int = 16
    tol: float = 1e-8
    # Ψ regularization, relative to the matrix scale ‖A‖_F/√N
    psi_base: float = 1e-18
    max_psi_attempts: int = 4        # batched Ψ-ladder depth per eig step
    # step-size adaptation
    alpha_initial: float = 0.7
    alpha_grow: float = 1.5
    alpha_shrink: float = 0.5
    alpha_decay: float = 0.98
    alpha_min: float = 1e-6
    improve_ratio: float = 0.9
    regress_ratio: float = 1.5
    # stuckness / retirement
    max_stuck_for_retirement: int = 8
    max_stuck_for_pruning: int = 4
    min_weight: float = 1e-10
    # distinct-solution similarity thresholds (eig)
    vector_similarity_tol: float = 0.999
    lambda_similarity_tol: float = 1e-5
    sigma_similarity_abs: float = 1e-6
    sigma_similarity_rel: float = 1e-4
    # σ/σ_max below this counts as outside the effective rank (its own knob:
    # the duplicate-σ tolerance must not move rank detection)
    rank_rel_cut: float = RANK_REL_CUT
    # numerics
    dtype: Any = torch.complex64     # working dtype: complex64 or complex128
    convergence_floor: float = 0.0   # dtype precision floor of the in-loop
                                     # convergence test; refinement closes
                                     # the gap to tol
    refine: bool = True
    max_refine_steps: int = 60       # refinement steps per solution. The JAX
                                     # package defaults to 3: at 16384²,
                                     # κ = 1e6 in complex64, 3 steps of IR
                                     # and 3 of GMRES-IR stop at 1.5e-8,
                                     # while 24 of IR reach 2.3e-10; the JAX
                                     # bench passes 60. The loop exits early
                                     # at tol or on a stall.
    eigh_max_n: int = 2048           # Hermitian eig: shared full eigh up to
                                     # this N; beyond it (or for sparse
                                     # input) per-candidate deflated Lanczos
    use_hessenberg: bool = True      # non-Hermitian eig: reduce A = Q H Qᴴ once
                                     # and run every shifted solve as an O(N²)
                                     # Givens QR on (H − λI), kernel K2;
                                     # otherwise one LU per candidate per step
    orthogonalize: bool = True       # SVD: run the population as one block
                                     # (subspace iteration with a Rayleigh–Ritz
                                     # rotation); otherwise per-candidate
                                     # alternating power iteration
    target_num_solutions: Optional[int] = None
    stall_limit: int = 10            # stop when the best residual has not
                                     # improved for this many iterations
    capture_history: bool = False    # collected metrics also carry each
                                     # candidate's residual, α and status
                                     # per iteration: O(iterations·K)
    capture_param_history: bool = False  # ... and each candidate's iterate
                                     # (pop.v) per iteration:
                                     # O(iterations·K·N); independent of
                                     # capture_history

    def __post_init__(self):
        object.__setattr__(self, "problem_type", ProblemType(self.problem_type))
        dtype = as_torch_dtype(self.dtype)
        if dtype not in (torch.complex64, torch.complex128):
            raise ValueError(f"dtype must be complex64 or complex128, got {dtype}")
        object.__setattr__(self, "dtype", dtype)

    @property
    def real_dtype(self) -> torch.dtype:
        return self.dtype.to_real()


@dataclasses.dataclass(frozen=True)
class ReplicaSlots:
    """The slots ``[lo, hi)`` of the candidate axis that this rank steps,
    on ``mesh`` (a ``parallel/mesh.Mesh`` whose replica axis splits K);
    set by ``parallel/placement.place_population``."""

    mesh: Any
    lo: int
    hi: int


@dataclasses.dataclass
class Population:
    """Struct-of-arrays candidate population of fixed capacity K.

    ``keys`` is a (K, 2) int64 tensor: a per-slot seed and a per-slot
    counter, which together seed the ``torch.Generator`` a slot draws from
    (``core/rng.py``). ``v`` is x for a linear system, the eigenvector, or
    the right singular vector; ``u`` is the SVD left vector (``None`` for
    the other problem types); ``lam`` holds λ (eig), σ (SVD, real part) or
    zeros (linear). ``slots`` is ``None`` unless the population was placed
    over replica ranks: then every rank still holds all K slots, and the
    candidate steps advance only the rank's :class:`ReplicaSlots`. It is
    placement, not state: checkpoints leave it out
    (``metadata["checkpoint"]``).
    """

    v: torch.Tensor              # (K, N) complex — x, eigenvector, or right
                                 # singular vector
    u: Optional[torch.Tensor]    # (K, M) complex — left singular vector (SVD)
    lam: torch.Tensor            # (K,) complex — λ (eig), σ (SVD), 0 (linear)
    weight: torch.Tensor         # (K,) real
    alpha: torch.Tensor          # (K,) real — local step size
    stuck: torch.Tensor          # (K,) int32
    status: torch.Tensor         # (K,) int8 — CandidateStatus code
    residual: torch.Tensor       # (K,) real — relative residual vs the operand
    prev_residual: torch.Tensor  # (K,) real
    psi_level: torch.Tensor      # (K,) int32
    keys: torch.Tensor           # (K, 2) int64 — (seed, counter) per slot
    retire_count: torch.Tensor   # (K,) int32
    slots: Optional[ReplicaSlots] = dataclasses.field(
        default=None, metadata={"checkpoint": False})

    @property
    def capacity(self) -> int:
        return self.v.shape[0]


@dataclasses.dataclass
class StrategyState:
    """Global adaptive strategy: 0-d tensors on the population's device,
    float32 or int32 as in the reference."""

    psi_aggression: torch.Tensor     # f32
    spawn_rate: torch.Tensor         # f32
    threshold: torch.Tensor          # f32
    solver_pref: torch.Tensor        # i32 (SolverPreference code)
    stability: torch.Tensor          # i32 (StabilityState code)
    landscape_energy: torch.Tensor   # f32
    avg_residual: torch.Tensor       # f32
    avg_stuckness: torch.Tensor      # f32
    num_distinct: torch.Tensor       # i32
    frustration: torch.Tensor        # f32 — population-level Ψ escalation rung
    pref_failures: torch.Tensor      # f32 — drives direct↔GMRES failover
    target_dynamic: torch.Tensor     # i32 — SVD: the effective-rank target,
                                     # re-derived every iteration from the
                                     # converged σ spectrum; otherwise the
                                     # static target


@dataclasses.dataclass(frozen=True)
class ProblemKnowledge:
    """Host-side diagnosis results, computed once by ``solver/diagnose.py``."""

    shape: tuple
    is_hermitian: bool = False
    is_complex_symmetric: bool = False
    is_sparse_input: bool = False
    is_positive_definite: bool = False
    density: float = 1.0
    cond_estimate: float = 1.0
    is_singular: bool = False
    effective_rank: Optional[int] = None   # SVD: from the host rank probe

    @property
    def stability(self) -> StabilityState:
        if self.is_singular or self.cond_estimate > 1e12:
            return StabilityState.CRITICAL
        if self.cond_estimate > 1e6:
            return StabilityState.FRAGILE
        return StabilityState.STABLE


def default_target_solutions(cfg: SolverConfig, knowledge: ProblemKnowledge) -> int:
    """How many distinct solutions the run is trying to find unless the
    config says otherwise: one for a linear system, N eigenpairs for an
    eigenproblem, the effective rank (else min(M, N)) for an SVD."""
    if cfg.target_num_solutions is not None:
        return int(cfg.target_num_solutions)
    m = int(knowledge.shape[0])
    n = int(knowledge.shape[1]) if len(knowledge.shape) > 1 else m
    if cfg.problem_type == ProblemType.EIGENVALUE:
        return n
    if cfg.problem_type == ProblemType.SVD:
        if knowledge.effective_rank is not None:
            return int(knowledge.effective_rank)
        return min(m, n)
    return 1


def initial_strategy(cfg: SolverConfig, knowledge: ProblemKnowledge,
                     device=None) -> StrategyState:
    """Initial :class:`StrategyState` from the static diagnosis (the
    reference's regime table; DIRECT is the default preference everywhere,
    the iterative path is reached through singularity or failover)."""
    stab = knowledge.stability
    if stab == StabilityState.CRITICAL:
        aggression, pref, thresh = 50.0, SolverPreference.DIRECT, max(cfg.tol, 1e-2)
    elif stab == StabilityState.FRAGILE:
        aggression, pref, thresh = 10.0, SolverPreference.DIRECT, max(cfg.tol, 1e-4)
    else:
        aggression, pref, thresh = 1.0, SolverPreference.DIRECT, cfg.tol
    if knowledge.is_singular and \
            cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        aggression, pref = max(aggression, 20.0), SolverPreference.GMRES
    if cfg.problem_type == ProblemType.SVD:
        aggression = max(aggression, 2.0)
        thresh = max(thresh, 1e-5)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return StrategyState(
        psi_aggression=f32(aggression),
        spawn_rate=f32(1.0),
        threshold=f32(thresh),
        solver_pref=i32(int(pref)),
        stability=i32(int(stab)),
        landscape_energy=f32(1.0),
        avg_residual=f32(float("inf")),
        avg_stuckness=f32(0.0),
        num_distinct=i32(0),
        frustration=f32(0.0),
        pref_failures=f32(0.0),
        target_dynamic=i32(min(default_target_solutions(cfg, knowledge),
                               cfg.num_candidates)),
    )
