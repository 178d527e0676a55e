"""KAIROSAGE and the scenario suite on the card: counterpart of
``benchmarks/age_probe.py``. Three rows, one JSON line each, with the JAX
program's keys, plus the device:

1. ``age 5x20`` — the reference-parity workload (5 genesis cycles × 20
   expression candidates, diffusion grid 50×50; ``AgeConfig()``'s
   defaults, seed 0), stage III on the card. Reference: under 240 s on one
   CPU core.
2. ``age stageIII throughput`` — stage III alone (the tape interpreter and
   the diffusion simulation, ``age/diffusion.population_fitness``) over a
   batch of woven candidates, in simulations and cell-steps a second (mean
   of 5 calls after one warm-up, each ending in a synchronise). The host
   stages (weaving, sympy novelty) are left out, as in the JAX program.
3. ``scenario suite`` — the reference's 4-scenario demo through the public
   API on the device (1/1, 8/8, 8/8, 2/2 to pass), timed warm.

    python -m maus_tpu_torch.benchmarks.age [--stage3-cands 4096]
        [--skip-scenarios] [--cpu]
"""
from __future__ import annotations

import json
import sys

import torch

from . import common


def row_age_reference_parity(device, rec) -> dict:
    from ..age import AgeConfig, GenesisEngine

    eng = GenesisEngine(AgeConfig(), seed=0, verbose=False, device=device)
    summaries, dt = common.host_seconds(lambda: eng.run(5), device)
    out = {"metric": "age 5x20 cycles (reference parity)", "time_s": dt,
           "vs_reference_240s": 240.0 / dt,
           "best_fitness": max(s["best_fitness"] for s in summaries),
           "library": summaries[-1]["library_size"], "device": rec}
    print(json.dumps(out), flush=True)
    return out


def row_stage3_throughput(n_cands: int, device, rec) -> dict:
    from ..age import AgeConfig, GenesisEngine, diffusion
    from ..age.tape import compile_tree, stack_tapes

    c = AgeConfig()
    eng = GenesisEngine(c, seed=1, verbose=False, device=device)
    genomes = []
    while len(genomes) < n_cands:            # weave in reference-sized waves
        genomes.extend(eng.stage_II_weave())
    tapes = stack_tapes([compile_tree(g.tree, c.variables) for g in genomes[:n_cands]])
    kern = torch.tensor(c.base_kernel, dtype=torch.float32, device=device)

    def run():
        return diffusion.population_fitness(tapes, c.diffusion_n, c.diffusion_t, kern)

    run()                                    # warm-up
    reps = 5

    def loop():
        for _ in range(reps):
            fit = run()
            common.sync(device)
        return fit

    fit, dt = common.host_seconds(loop, device)
    dt /= reps
    out = {"metric": f"age stageIII throughput ({n_cands} cands, "
                     f"{c.diffusion_n}x{c.diffusion_t} grid)",
           "time_s": dt, "sims_per_s": n_cands / dt,
           "cell_steps_per_s": n_cands * c.diffusion_n * c.diffusion_t / dt,
           "mean_fitness": float(fit.mean()), "device": rec}
    print(json.dumps(out), flush=True)
    return out


def row_scenarios(device, rec) -> dict:
    from ..problems import generators as gen
    from ..solver.api import eig, solve, svd

    def suite():
        ok = []
        A, b = gen.dynamic_solve_system(5, t_step=19, time_max_iter=20)
        rep = solve(A, b, tol=1e-7, max_iterations=50, num_candidates=15,
                    device=device)
        ok.append(rep.num_distinct >= 1)
        A = gen.laplace_like_complex(8, make_hermitian=False)
        rep = eig(A, tol=1e-7, max_iterations=80, num_candidates=30, device=device)
        ok.append(rep.num_distinct == 8)
        A = gen.laplace_like_complex(8, make_hermitian=True)
        rep = eig(A, tol=1e-7, max_iterations=50, num_candidates=30, device=device)
        ok.append(rep.num_distinct == 8)
        A = gen.low_rank_svd_matrix(5, 4, target_rank=2)
        rep = svd(A, tol=1e-6, max_iterations=100, num_candidates=25, device=device)
        ok.append(rep.num_distinct >= 2)
        return ok

    suite()                                  # warm-up
    ok, dt = common.host_seconds(suite, device)
    out = {"metric": "4-scenario demo suite (warm)", "time_s": dt,
           "vs_reference_6.2s": 6.2 / dt, "passed": f"{sum(ok)}/4",
           "scenario_ok": ok, "device": rec}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device=None) -> int:
    ap = common.arg_parser("age")
    ap.add_argument("--stage3-cands", type=int, default=4096)
    ap.add_argument("--skip-scenarios", action="store_true")
    args = ap.parse_args(argv)
    device = common.run_device(args, device)
    rec = common.device_record(device)
    row_age_reference_parity(device, rec)
    row_stage3_throughput(args.stage3_cands, device, rec)
    if not args.skip_scenarios:
        row_scenarios(device, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
