"""Large-N end-to-end ``eig``/``svd`` rows on the card: counterpart of
``benchmarks/spectral_large_probe.py``. The public API (``maus_tpu_torch.eig``
and ``svd``: diagnosis, engine and finishers) at N = 4096 and 8192 for eig,
general and Hermitian, and a 4096×2048 SVD.

Operands are built on the card from a seeded ``torch.Generator``
(``common.eig_operand``, ``hermitian_operand``, ``svd_operand``; seed 0,
the operands of ``chip_smoke.py``) and passed as CUDA tensors. Each row runs
twice and is timed the second time, on the host clock ending in a
synchronise. Candidates oversubscribe the target 2× (the JAX program's
rule). The JAX program's N ≥ 12288 ``knowledge`` shortcut (the TPU's HBM
cap on the condition probe) is not needed on an 80 GB card.

Prints one JSON line a row, with the JAX program's keys (``metric``,
``time_s``, ``num_distinct``, ``target``, ``n_at_tol``, ``iterations``,
``max_resid``, ``resid_top_target``, ``hbm_peak_gb``: the peak device
memory of the timed run, GiB), plus ``timings`` (``SolutionReport.timings``:
setup, engine, finisher), the kernels' launches in the timed run and the
device. This program runs K2, K3, P3 and P4 on the card.

    python -m maus_tpu_torch.benchmarks.spectral_large [--sizes 4096,8192]
        [--cands 16] [--svd-shape 4096x2048] [--kinds general,hermitian]
        [--no-svd] [--tol 1e-8] [--iters 100] [--cpu]
"""
from __future__ import annotations

import json
import sys

from . import common

SEED = 0


def _row(fn, metric: str, tol: float, device, rec: dict) -> dict:
    fn()                                       # first run, then the timed one
    common.reset_peak(device)
    before = common.launch_counts()
    rep, dt = common.host_seconds(fn, device)
    launches = common.launches_since(before)
    # an oversubscribed run returns more distinct solutions than its target:
    # report the worst residual overall and within the best ``target``
    rs = sorted(rep.residuals)
    out = {"metric": metric, "time_s": dt,
           "num_distinct": rep.num_distinct,
           "target": rep.target_solutions,
           "n_at_tol": sum(1 for r in rs if r <= tol),
           "iterations": rep.iterations,
           "max_resid": rs[-1] if rs else None,
           "resid_top_target": rs[min(rep.target_solutions, len(rs)) - 1]
           if rs else None,
           "hbm_peak_gb": common.peak_gib(device),
           "timings": rep.timings, "launches": launches, "device": rec}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device=None) -> int:
    from ..solver.api import eig, svd

    ap = common.arg_parser("spectral_large")
    ap.add_argument("--sizes", default="4096,8192")
    ap.add_argument("--cands", type=int, default=16)
    ap.add_argument("--svd-shape", default="4096x2048")
    ap.add_argument("--kinds", default="general,hermitian",
                    help="eig operand kinds; pass 'none' to skip eig rows")
    ap.add_argument("--no-svd", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    device = common.run_device(args, device)
    rec = common.device_record(device)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    make = {"general": common.eig_operand, "hermitian": common.hermitian_operand}
    kinds = [k for k in args.kinds.split(",") if k and k != "none"]
    for n in sizes:
        for kind in kinds:
            A = make[kind](n, SEED, device)
            _row(lambda: eig(A, tol=args.tol, max_iterations=args.iters,
                             num_candidates=2 * args.cands,
                             target_solutions=args.cands, device=device),
                 f"eig N={n} {kind}", args.tol, device, rec)
            del A
    if args.no_svd:
        return 0
    m, n = (int(x) for x in args.svd_shape.split("x"))
    B, _ = common.svd_operand(m, n, args.cands, SEED, device)
    tol = max(args.tol, 1e-6)
    _row(lambda: svd(B, tol=tol, max_iterations=args.iters,
                     num_candidates=2 * args.cands, target_solutions=args.cands,
                     device=device),
         f"svd {m}x{n}", tol, device, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
