"""The headline solve at 16384² on the card: counterpart of
``benchmarks/solve16k_probe.py``. ``headline.py``'s path (evolve to the
complex64 floor, certified refinement through K1) on the 16384² system,
without the scorecard, with its peak device memory. One warm-up, then one
timed run.

The JAX program needs a host-refactor handoff and factors as f32 planes to
fit its 16 GB chip (``SolverConfig.host_refactor``, ``fac_to_planes``):
TPU workarounds, not ported. The same path runs at every N, so the line has
no ``host_refactors``; the other keys are the JAX program's (``metric``,
``value``, ``unit``, ``vs_baseline``, ``iters``,
``scipy_per_solve_modeled_s``), plus ``achieved_rel``, ``k1_launches``,
``peak_gib``, ``layers`` and the device.

    python -m maus_tpu_torch.benchmarks.solve16k [--n 16384] [--cands 16]
        [--cond 1e6] [--tol 1e-8] [--cpu]
"""
from __future__ import annotations

import json
import sys

from . import common, headline


def main(argv=None, device=None) -> int:
    ap = common.arg_parser("solve16k")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--cands", type=int, default=16)
    ap.add_argument("--cond", type=float, default=1e6)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args(argv)
    device = common.run_device(args, device)
    n, K, tol = args.n, args.cands, args.tol
    run = headline.measure(n, K, args.cond, tol, device, reps=1)
    rel, iters, elapsed = run["rel"], run["iterations"], run["value"]
    t_solve = headline.scipy_solve_s(min(1024, n), n)
    print(json.dumps({
        "metric": headline.metric(n, K, args.cond, tol, rel),
        "value": elapsed, "unit": "s",
        "vs_baseline": t_solve * K * max(iters, 1) / elapsed,
        "iters": iters, "scipy_per_solve_modeled_s": t_solve,
        "achieved_rel": rel, "k1_launches": run["k1_launches"],
        "peak_gib": run["peak_gib"], "layers": run["layers"],
        "host_cpu": common.host_cpu(), "device": common.device_record(device),
    }), flush=True)
    return 0 if rel <= tol else 1


if __name__ == "__main__":
    sys.exit(main())
