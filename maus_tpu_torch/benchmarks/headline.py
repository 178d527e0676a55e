"""The north-star metric on the card: counterpart of ``bench.py:87-277``.

    time-to-tol ‖Ax−b‖/‖b‖ ≤ 1e-8 on a 4096² ill-conditioned dense complex64
    system (κ = 1e6), a population of 16 candidates.

The solve is ``bench.py``'s ``_solve_fused`` (``bench.py:173-189``) as the
port runs it: ``evolve.init_carry`` (the shared QR) and
``evolve.evolve_while`` under ``utils/precision.full_precision``, the best
finite candidate, then ``ops/refine.refine_split`` on the complex64 operand
(the counterpart of ``refine_split_c64exact``: kernel K1 reads A in its own
dtype, no widened copy). One warm-up, then the best of 3 on the host clock
ending in a synchronise, as ``bench.py:245-260`` times it. The convergence
floor is ``bench.py``'s max(50·ε, 2·ε·κ) with 60 refinement steps and 50
iterations. ``bench.py``'s ``host_mode`` (the TPU's scoped-VMEM cap at N ≥
12288) is a TPU workaround: every N runs this one path.

Prints ONE JSON line with ``bench.py:267-277``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline``, ``solves_per_s``; ``MISS`` in the
metric when the run misses tol), plus ``iterations``, ``achieved_rel``,
``k1_launches`` (K1 launches of one solve), ``peak_gib``, ``layers`` (the
best run's ``init_s``, ``engine_s`` and ``refine_s`` from CUDA events, and
``other_s``, the rest of ``value``), ``runs_s``, the scipy model's inputs
and the device; and, unless ``--quick`` or ``--no-mfu``, the scorecard
(``scorecard.py``) under ``mfu``, as ``bench.py:278`` embeds its own.

``vs_baseline`` keeps ``bench.py``'s model: one LAPACK complex128 solve
(``scipy.linalg.solve``) × K candidates × our iterations. The solve is
measured live on this host at min(1024, N) and scaled by N³
(``bench.py:68-79``'s own fallback), so the ratio depends on the host CPU,
named in ``host_cpu``, and is not comparable with the JAX package's, whose
table was measured on another host.

    python -m maus_tpu_torch bench [--quick] [--n N]
    python -m maus_tpu_torch.benchmarks.headline [--quick] [--n N] [--cands K]
        [--cond C] [--tol T] [--no-mfu] [--cpu]

Exit code 0 when the run reaches tol, else 1 (``bench.py:359``).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from . import common

SEED = 0                 # the operand's generator
CARRY_SEED = 1           # the population's (bench.py: PRNGKey(1))
MAX_ITERS = 50
REFINE_STEPS = 60


def config(n: int, cands: int, cond: float, tol: float):
    """``bench.py:129-150``'s SolverConfig and ProblemKnowledge."""
    from ..core.types import ProblemKnowledge, ProblemType, SolverConfig

    eps = float(np.finfo(np.float32).eps)
    cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                       num_candidates=cands, tol=tol, dtype=torch.complex64,
                       convergence_floor=max(50 * eps, 2 * eps * cond),
                       refine=True, max_refine_steps=REFINE_STEPS)
    return cfg, ProblemKnowledge(shape=(n, n), cond_estimate=cond)


def solve(cfg, kn, A: torch.Tensor, b: torch.Tensor, carry0=None) -> dict:
    """The whole solve (``bench.py:_solve_fused``): evolve to the complex64
    floor, the best finite candidate, certified refinement. ``carry0``: an
    initial carry in place of ``init_carry``'s (the tests inject the JAX
    package's). Returns x (complex128), the certified relative residual,
    the iteration count and the phases' seconds."""
    from ..ops.refine import refine_split
    from ..solver import evolve
    from ..utils.precision import full_precision

    stamps = common.Stamps(A.device)
    with full_precision():
        stamps.mark()
        if carry0 is None:
            carry0 = evolve.init_carry(cfg, kn, A, CARRY_SEED)
        stamps.mark()
        carry = evolve.evolve_while(cfg, kn, A, b, CARRY_SEED, MAX_ITERS, 1,
                                    carry0=carry0)
        stamps.mark()
        res = carry.pop.residual
        best = torch.argmin(torch.where(torch.isfinite(res), res,
                                        torch.full_like(res, float("inf"))))
        x, rel = refine_split(A, carry.fac, b, carry.pop.v[best],
                              steps=cfg.max_refine_steps, tol=cfg.tol * 0.3)
        stamps.mark()
    init_s, engine_s, refine_s = stamps.seconds()
    return dict(x=x, rel=rel, iterations=int(carry.iteration),
                layers=dict(init_s=init_s, engine_s=engine_s, refine_s=refine_s))


def scipy_solve_s(n_model: int, n_target: int) -> float:
    """One LAPACK complex128 solve at ``n_target``, measured live at
    ``n_model`` (mean of 3 after one warm-up) and scaled by N³."""
    import scipy.linalg as sla

    rng = np.random.default_rng(0)
    A = rng.standard_normal((n_model, n_model)) + 1j * rng.standard_normal((n_model, n_model))
    b = rng.standard_normal(n_model) + 0j
    sla.solve(A, b)
    t0 = time.perf_counter()
    for _ in range(3):
        sla.solve(A, b)
    return (time.perf_counter() - t0) / 3 * (n_target / n_model) ** 3


def measure(n: int, cands: int, cond: float, tol: float, device: torch.device,
            reps: int = 3) -> dict:
    """One warm-up, then ``reps`` timed solves of the generated system; the
    fastest run's numbers, every run's seconds, K1's launches a solve and
    the peak device memory of the timed runs."""
    from ..ops.kernels import residual

    A, b = common.make_system(n, cond, SEED, device)
    cfg, kn = config(n, cands, cond, tol)
    solve(cfg, kn, A, b)
    common.reset_peak(device)
    runs = []
    for _ in range(reps):
        k1 = residual.LAUNCHES
        out, dt = common.host_seconds(lambda: solve(cfg, kn, A, b), device)
        out.update(value=dt, k1_launches=residual.LAUNCHES - k1)
        runs.append(out)
    best = min(runs, key=lambda r: r["value"])
    best["runs_s"] = [r["value"] for r in runs]
    best["peak_gib"] = common.peak_gib(device)
    best["layers"]["other_s"] = best["value"] - sum(best["layers"].values())
    return best


def metric(n: int, cands: int, cond: float, tol: float, rel: float) -> str:
    """``bench.py``'s metric name, with ``MISS`` when ``rel`` misses tol."""
    return (f"time_to_tol({tol:g}) N={n} illcond(k={cond:g}) pop={cands} "
            f"[achieved_rel={rel:.2e}{'' if rel <= tol else ' MISS'}]")


def result_line(run: dict, n: int, cands: int, cond: float, tol: float,
                device_rec: dict) -> dict:
    """``bench.py:267-277``'s keys, then the port's."""
    rel, iters, elapsed = run["rel"], run["iterations"], run["value"]
    n_model = min(1024, n)
    t_solve = scipy_solve_s(n_model, n)
    return {
        "metric": metric(n, cands, cond, tol, rel),
        "value": elapsed, "unit": "s",
        "vs_baseline": t_solve * cands * max(iters, 1) / elapsed,
        "solves_per_s": cands * max(iters, 1) / elapsed,
        "iterations": iters, "achieved_rel": rel,
        "k1_launches": run["k1_launches"], "peak_gib": run["peak_gib"],
        "layers": run["layers"], "runs_s": run["runs_s"],
        "scipy_solve_s": t_solve, "scipy_measured_n": n_model,
        "host_cpu": common.host_cpu(), "device": device_rec,
    }


def main(argv=None, device=None) -> int:
    ap = common.arg_parser("headline")
    ap.add_argument("--quick", action="store_true", help="N=512 smoke config")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--cands", type=int, default=16)
    ap.add_argument("--cond", type=float, default=1e6)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--no-mfu", action="store_true",
                    help="skip the per-kernel scorecard")
    args = ap.parse_args(argv)
    device = common.run_device(args, device)
    n = args.n or (512 if args.quick else 4096)
    rec = common.device_record(device)
    run = measure(n, args.cands, args.cond, args.tol, device)
    line = result_line(run, n, args.cands, args.cond, args.tol, rec)
    if not args.no_mfu and not args.quick:
        from .scorecard import scorecard

        sc = scorecard(device)
        line["mfu"] = {"device": sc["device"], "peaks": sc["peaks"],
                       "kernels": sc["kernels"]}
    print(json.dumps(line), flush=True)
    return 0 if run["rel"] <= args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
