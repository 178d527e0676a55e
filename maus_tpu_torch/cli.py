"""Command-line interface of the port (counterpart of ``maus_tpu/cli.py``):
the reference's demo scenarios, generated solve, eig and SVD runs (with
checkpoint and resume) and KAIROSAGE's genesis cycles, with the same
arguments, defaults, output lines and exit codes.

    python -m maus_tpu_torch scenarios          # the reference's 4 scenarios
    python -m maus_tpu_torch solve --n 64       # generated Ax=b
    python -m maus_tpu_torch eig --n 8 --hermitian
    python -m maus_tpu_torch svd --rows 5 --cols 4
    python -m maus_tpu_torch solve --checkpoint c.npz --checkpoint-every 2
    python -m maus_tpu_torch solve --resume-from c.npz
    python -m maus_tpu_torch age --cycles 5     # KAIROSAGE genesis cycles
    python -m maus_tpu_torch bench              # the headline solve, 4096²
    python -m maus_tpu_torch --cpu bench --quick --n 64
    python -m maus_tpu_torch solve --n 256 --mesh-model 2   # over 2 ranks
    python -m maus_tpu_torch --cpu --cpu-devices 2 solve --mesh-model 2

Runs go on the CUDA card; ``--cpu`` runs them on the CPU (complex128).
``--mesh-model M`` runs ``solve``/``eig``/``svd`` over a (1, M) mesh of M
ranks started from this process (``parallel/launch.py``), the operand
column-sharded: NCCL with a card per rank, or ``--backend gloo`` for ranks
that share a card. ``--cpu --cpu-devices N`` runs N ranks on the CPU over
gloo (a (N/M, M) mesh). No backend is chosen for the caller: ``--cpu
--mesh-model M`` without ``--cpu-devices`` or ``--backend gloo`` raises the
library's ``ValueError``. ``bench`` runs the port's headline benchmark
(``benchmarks/headline.py``, the counterpart of the repo's ``bench.py``: the
4096² κ = 1e6 complex64 solve to 1e-8 with the kernel scorecard; ``--quick``
at 512² without it) and prints its JSON line; with ``--cpu`` it runs on the
CPU, still in complex64. Every solver subcommand and ``bench`` exit 0 when
the run reached its target, else 1; ``age`` exits 0.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _report_lines(rep, check=None):
    yield (f"{rep.problem_type.name}: {rep.num_distinct}/{rep.target_solutions} "
           f"distinct solutions in {rep.iterations} iterations "
           f"(energy {rep.landscape_energy:.3f})")
    for sol, res in zip(rep.solutions, rep.residuals):
        if rep.problem_type.name == "EIGENVALUE":
            yield f"  λ = {sol[0]:.6g}   residual {res:.3e}"
        elif rep.problem_type.name == "SVD":
            yield f"  σ = {sol[0]:.6g}   residual {res:.3e}"
        else:
            yield f"  ‖x‖ = {np.linalg.norm(sol[0]):.6g}   rel residual {res:.3e}"
    if check is not None:
        yield (f"  vs LAPACK truth: matched {check.matched}/{check.total_found}, "
               f"max err {check.max_abs_error:.3e}")


def _ckpt_kwargs(args):
    return dict(checkpoint_path=args.checkpoint, resume_from=args.resume_from,
                checkpoint_every=args.checkpoint_every)


def _mesh_rank(mesh, kind: str, A, b, kw: dict):
    """One rank of a ``--mesh-model`` run: the entry point with the mesh."""
    from .solver import api

    operands = (A,) if b is None else (A, b)
    return getattr(api, kind)(*operands, mesh=mesh, **kw)


def _run(args, kind: str, A, b=None):
    """The subcommand's solver call: on this process's device, or over
    ``--mesh-model`` ranks, whose rank 0 report comes back."""
    from .solver import api

    kw = dict(tol=args.tol, max_iterations=args.iters,
              num_candidates=args.cands, seed=args.seed, **_ckpt_kwargs(args))
    m = args.mesh_model
    if m <= 1:
        operands = (A,) if b is None else (A, b)
        return getattr(api, kind)(*operands, device=args.device, **kw)
    world = args.cpu_devices or m
    if world % m:
        raise ValueError(f"--cpu-devices {world} is not a multiple of "
                         f"--mesh-model {m}")
    from .parallel import launch

    return launch.run(_mesh_rank, world, kind, A, b, kw, backend=args.backend,
                      device=args.device, replica=world // m, model=m)


def _finish(rep, args, A, b=None):
    from .utils import truth

    check = truth.compare(rep, A, b) if args.check else None
    print("\n".join(_report_lines(rep, check)))
    return 0 if rep.converged else 1


def cmd_solve(args):
    from .problems import generators as gen

    if args.ill_conditioned:
        A, b = gen.ill_conditioned_system(args.n, cond=args.cond, seed=args.seed)
    else:
        A, b = gen.well_conditioned_system(args.n, seed=args.seed)
    return _finish(_run(args, "solve", A, b), args, A, b)


def cmd_eig(args):
    from .problems import generators as gen

    A = gen.laplace_like_complex(args.n, make_hermitian=args.hermitian,
                                 seed=args.seed)
    return _finish(_run(args, "eig", A), args, A)


def cmd_svd(args):
    from .problems import generators as gen

    A = gen.low_rank_svd_matrix(args.rows, args.cols, target_rank=args.rank,
                                seed=args.seed)
    return _finish(_run(args, "svd", A), args, A)


def cmd_scenarios(args):
    """The reference's 4-scenario demo suite with pass/fail."""
    from . import eig, solve, svd
    from .problems import generators as gen

    dev = args.device
    results = []

    A, b = gen.dynamic_solve_system(5, t_step=19, time_max_iter=20)
    rep = solve(A, b, tol=1e-7, max_iterations=50, num_candidates=15, device=dev)
    results.append(("1: N=5 dynamic Ax=b", rep.num_distinct >= 1, rep))

    A = gen.laplace_like_complex(8, make_hermitian=False)
    rep = eig(A, tol=1e-7, max_iterations=80, num_candidates=30, device=dev)
    results.append(("2A: N=8 general eig", rep.num_distinct == 8, rep))

    A = gen.laplace_like_complex(8, make_hermitian=True)
    rep = eig(A, tol=1e-7, max_iterations=50, num_candidates=30, device=dev)
    results.append(("2B: N=8 Hermitian eig", rep.num_distinct == 8, rep))

    A = gen.low_rank_svd_matrix(5, 4, target_rank=2)
    rep = svd(A, tol=1e-6, max_iterations=100, num_candidates=25, device=dev)
    results.append(("3: 5x4 rank-2 SVD", rep.num_distinct >= 2, rep))

    ok_all = True
    for name, ok, rep in results:
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] scenario {name}: {rep.num_distinct}/"
              f"{rep.target_solutions} distinct in {rep.iterations} iters")
        ok_all &= ok
    return 0 if ok_all else 1


def cmd_bench(args):
    """The headline benchmark, on the card or with ``--cpu`` on the CPU."""
    from .benchmarks import headline

    argv = ["--quick"] if args.quick else []
    if args.n is not None:
        argv += ["--n", str(args.n)]
    return headline.main(argv, device=args.device)


def cmd_age(args):
    from .age import AgeConfig, GenesisEngine, IslandAGE

    conf = AgeConfig(candidates_per_cycle=args.cands)
    if args.islands > 1:
        isl = IslandAGE(n_islands=args.islands, config=conf, seed=args.seed,
                        verbose=not args.json, device=args.device)
        summaries = isl.run(args.cycles)
        if args.json:
            for s in summaries:
                print(json.dumps(s))
        else:
            best = max(s["best_fitness"] for s in summaries)
            print(f"best fitness {best:.3f} across {args.islands} islands, "
                  f"library {summaries[-1]['library_total']}")
        return 0
    eng = GenesisEngine(conf, seed=args.seed, verbose=not args.json,
                        device=args.device)
    summaries = eng.run(args.cycles)
    if args.json:
        for s in summaries:
            print(json.dumps(s))
    else:
        best = max(s["best_fitness"] for s in summaries)
        print(f"best fitness {best:.3f}, library {len(eng.harmonic_library)}")
        for g in eng.harmonic_library[:5]:
            print(f"  fit={g.stability:.3f}  {g.tree.to_string()[:70]}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="maus_tpu_torch",
                                 description="MAUS solver on PyTorch and CUDA")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (complex128) instead of the CUDA card")
    ap.add_argument("--cpu-devices", type=int, default=None, metavar="N",
                    help="with --cpu: run a --mesh-model run over N gloo "
                         "ranks on the CPU")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend of a --mesh-model run on the "
                         "card (default nccl, a card per rank; gloo lets "
                         "ranks share a card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--tol", type=float, default=1e-8)
    common.add_argument("--iters", type=int, default=100)
    common.add_argument("--cands", type=int, default=None)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--check", action="store_true",
                        help="compare against LAPACK truth")
    common.add_argument("--mesh-model", type=int, default=0, metavar="M",
                        help="run distributed over a (1, M) mesh of M ranks "
                             "(column-sharded operand, full engine)")
    common.add_argument("--checkpoint", default=None, metavar="PATH",
                        help="save the solver carry to PATH")
    common.add_argument("--checkpoint-every", type=int, default=None,
                        metavar="K", help="save every K iterations")
    common.add_argument("--resume-from", default=None, metavar="PATH",
                        help="resume from a carry saved by --checkpoint")

    p = sub.add_parser("solve", parents=[common])
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--ill-conditioned", action="store_true")
    p.add_argument("--cond", type=float, default=1e6)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("eig", parents=[common])
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--hermitian", action="store_true")
    p.set_defaults(fn=cmd_eig)

    p = sub.add_parser("svd", parents=[common])
    p.add_argument("--rows", type=int, default=5)
    p.add_argument("--cols", type=int, default=4)
    p.add_argument("--rank", type=int, default=2)
    p.set_defaults(fn=cmd_svd)

    p = sub.add_parser("scenarios")
    p.set_defaults(fn=cmd_scenarios)

    p = sub.add_parser("bench")
    p.add_argument("--quick", action="store_true",
                   help="N=512, without the kernel scorecard")
    p.add_argument("--n", type=int, default=None)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("age")
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--cands", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--islands", type=int, default=1,
                   help="island-model run: N independent populations, one "
                        "batched device evaluation, ring migration")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_age)

    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else None
    if args.cpu_devices is not None:
        if not args.cpu:
            ap.error("--cpu-devices needs --cpu")
        if args.backend == "nccl":
            ap.error("--cpu-devices runs gloo ranks; NCCL needs CUDA cards")
        args.backend = "gloo"
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
