"""The eig step's two branches on the card: counterpart of
``benchmarks/eig_paths.py``. The direct branch (the shared Hessenberg form,
every shifted solve through K2) against the matrix-free Jacobi–Davidson
branch (a projected GMRES correction a candidate), through one evolve: only
the initial carry's ``strat.solver_pref`` differs (the library reaches the
iterative branch through failover).

A = (G₁ + iG₂)/√N (``common.eig_operand``, seed 0), complex64, 16
candidates, target 6, tol 1e-4, floor 2e-6, 60 iterations, no finisher.
Each branch runs once to warm up, then once timed, on the host clock ending
in a synchronise; the Hessenberg reduction runs inside both evolves, as in
the JAX program.

Prints one JSON line with the JAX program's keys (``n``, ``cands``,
``target``, ``direct_hessenberg`` and ``jacobi_davidson_gmres`` each with
``s``, ``distinct``, ``iters``, ``min_res``, and ``jd_over_direct``), plus
each branch's kernel launches and the device.

    python -m maus_tpu_torch.benchmarks.eig_paths [--n 1024] [--cands 16]
        [--target 6] [--iters 60] [--cpu]
"""
from __future__ import annotations

import dataclasses
import json
import sys

import torch

from . import common

CARRY_SEED = 1


def config(n: int, cands: int, target: int):
    """The JAX program's SolverConfig and ProblemKnowledge."""
    from ..core.types import ProblemKnowledge, ProblemType, SolverConfig

    cfg = SolverConfig(problem_type=ProblemType.EIGENVALUE, num_candidates=cands,
                       tol=1e-4, dtype=torch.complex64, convergence_floor=2e-6,
                       refine=False, target_num_solutions=target)
    return cfg, ProblemKnowledge(shape=(n, n), cond_estimate=100.0)


def with_preference(carry, pref):
    """``carry`` with ``strat.solver_pref`` replaced by ``pref``, a 0-d
    int32 tensor on the carry's device (the JAX program's
    ``dataclasses.replace``)."""
    solver_pref = torch.tensor(int(pref), dtype=torch.int32,
                               device=carry.strat.solver_pref.device)
    return dataclasses.replace(
        carry, strat=dataclasses.replace(carry.strat, solver_pref=solver_pref))


def evolve_branch(cfg, kn, A, carry0, iters: int, target: int) -> dict:
    """One evolve from ``carry0``: the distinct count, iterations and the
    smallest finite residual of the last population."""
    from ..solver import evolve
    from ..utils.precision import full_precision

    with full_precision():
        carry = evolve.evolve_while(cfg, kn, A, None, CARRY_SEED, iters, target,
                                    carry0=carry0)
    res = carry.pop.residual
    min_res = torch.min(torch.where(torch.isfinite(res), res,
                                    torch.full_like(res, float("inf"))))
    return {"distinct": int(carry.strat.num_distinct),
            "iters": int(carry.iteration), "min_res": float(min_res)}


def main(argv=None, device=None) -> int:
    from ..core.types import SolverPreference
    from ..solver import evolve

    ap = common.arg_parser("eig_paths")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--cands", type=int, default=16)
    ap.add_argument("--target", type=int, default=6)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args(argv)
    device = common.run_device(args, device)
    n, k = args.n, args.cands
    A = common.eig_operand(n, 0, device)
    cfg, kn = config(n, k, args.target)

    def run(pref):
        def once():
            carry0 = with_preference(evolve.init_carry(cfg, kn, A, CARRY_SEED), pref)
            return common.host_seconds(
                lambda: evolve_branch(cfg, kn, A, carry0, args.iters, args.target),
                device)
        once()
        before = common.launch_counts()
        out, dt = once()
        out = {"s": dt, **out, "launches": common.launches_since(before)}
        return out

    direct = run(SolverPreference.DIRECT)
    jd = run(SolverPreference.GMRES)
    print(json.dumps({
        "n": n, "cands": k, "target": args.target,
        "direct_hessenberg": direct, "jacobi_davidson_gmres": jd,
        "jd_over_direct": jd["s"] / max(direct["s"], 1e-9),
        "device": common.device_record(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
