"""Candidate-population shifted solves a second on the card: counterpart of
``benchmarks/throughput.py``. How many Ψ-regularised shifted
factorize-and-solve operations a second ``ops/batched_solve.
batched_shifted_solve`` sustains (one LU a candidate, through P4), against
one LAPACK complex128 ``scipy.linalg.solve`` at the same N, measured live
on this host (named in ``host_cpu``).

The JAX program's line (``metric``, ``value``, ``unit``, ``vs_baseline``),
plus the scipy rate, the LU kernel's launches a call and the device.

    python -m maus_tpu_torch.benchmarks.throughput [--n 256] [--cands 32]
        [--reps 10] [--cpu]
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from . import common


def main(argv=None, device=None) -> int:
    from ..ops.batched_solve import batched_shifted_solve
    from ..utils.precision import full_precision

    ap = common.arg_parser("throughput")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--cands", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = common.run_device(args, device)
    n, K = args.n, args.cands

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    A = common.cnormal(gen, (n, n), torch.complex64, device)
    lams = common.cnormal(gen, (K,), torch.complex64, device)
    B = common.cnormal(gen, (K, n), torch.complex64, device)
    stuck = torch.zeros(K, dtype=torch.int32, device=device)

    def f():
        return batched_shifted_solve(A, lams, stuck, 1e-12, 1.0, B)[0]

    with full_precision():
        f()
        before = common.launch_counts()

        def loop():
            for _ in range(args.reps):
                f()

        _, dt = common.host_seconds(loop, device)
    launches = common.launches_since(before)
    dt /= args.reps
    solves_per_sec = K / dt

    # the scipy floor: one LAPACK solve per candidate (the reference's inner loop)
    import scipy.linalg as sla

    rng = np.random.default_rng(0)
    Ah = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    bh = rng.standard_normal(n) + 0j
    sla.solve(Ah, bh)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        sla.solve(Ah, bh)
    scipy_rate = reps / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": f"candidate_shifted_solves_per_sec N={n} pop={K}",
        "value": solves_per_sec, "unit": "solves/s",
        "vs_baseline": solves_per_sec / scipy_rate,
        "call_s": dt, "scipy_solves_per_s": scipy_rate,
        "lu_launches_per_call": launches["P4"] / args.reps,
        "host_cpu": common.host_cpu(), "device": common.device_record(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
