"""Per-kernel scorecard on the card: counterpart of ``benchmarks/mfu.py``'s
``scorecard()`` (``mfu.py:293-437``), with its rows and its ``kernels``
layout (``shape``, ``time_s``, ``gflops``, ``mfu``, ``sol_frac``), measured
live with CUDA events (:func:`common.time_ms`).

- ``mfu``: achieved operations a second over the published peak of the unit
  that does them, named in the row's ``unit`` (``common.UNITS``).
- ``sol_frac``: the bound over the time, where the bound is the larger of
  the row's bytes over the HBM rate and its operations over that unit's
  peak (``common.bound_ms``): the share of the card's speed of light.

Rows: a complex64 GEMM at 4096³ through ``torch.matmul`` at full FP32
precision (the measured compute ceiling), a 256 MB HBM stream, the linear
path's shared QR (R⁻¹ and the reflectors, as ``ops/batched_solve.factor_qr``
builds it), ``batched_shifted_solve`` at K = 32, n = 256 (one LU a
candidate, through P4), K2 at (32, 256) and at the eig path's (32, 4096),
the population matvec at 16 × 4096, and K1 at 4096² complex64 in place of
the TPU-only ``sliced_f64_residual``/``fused_slice_residual`` rows. The
matvec and K1 operands (134 MB) exceed the card's 50 MB L2, so repeated
calls read them from HBM. The cached artifact and the canary suite of the
JAX scorecard (``bench.py:283-356``) are not ported: they exist because a
TPU scorecard cost about 8 minutes of compiles.

On the CPU (``device="cpu"``) the rows are host-clocked and ``mfu`` and
``sol_frac`` are None: the peaks are the card's.

    python -m maus_tpu_torch.benchmarks.scorecard [--n-gemm 4096] [--n-qr 4096]
        [--k-lu 32] [--n-lu 256] [--k-mv 16] [--n-mv 4096] [--cpu]
"""
from __future__ import annotations

import json
import sys
import time

import torch

from . import common


def _row(rows, name, shape, ms, flops, nbytes, unit, on_card):
    """One ``kernels`` entry; ``unit`` is a key of ``common.UNITS``, or
    None for a row that only moves bytes."""
    t = ms / 1e3
    out = {"shape": shape, "time_s": t}
    if unit is None:
        out.update(gbs=nbytes / t / 1e9, unit="HBM",
                   sol_frac=nbytes / common.HBM_BYTES_PER_S / t if on_card else None)
    else:
        label, peak = common.UNITS[unit]
        b_ms, b_by = common.bound_ms(nbytes, flops, peak)
        out.update(gflops=flops / t / 1e9, unit=label,
                   mfu=flops / t / peak if on_card else None,
                   sol_frac=b_ms / ms if on_card else None, bound_by=b_by,
                   bound_s=b_ms / 1e3)
    rows[name] = out


def scorecard(device=None, n_gemm: int = 4096, n_qr: int = 4096, k_lu: int = 32,
              n_lu: int = 256, k_mv: int = 16, n_mv: int = 4096) -> dict:
    """The rows (``mfu.py:scorecard``'s shape arguments), measured on
    ``device`` (default: the card). K2 runs at (k_lu, n_lu) and at the eig
    path's (k_lu, n_mv); K1 at n_mv²."""
    from ..ops.batched_solve import batched_shifted_solve, factor_qr
    from ..ops.kernels import hess_solve, residual
    from ..utils.precision import full_precision

    device = common.resolve_device(device)
    rec = common.device_record(device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    c64 = torch.complex64

    def cn(*shape, dtype=c64):
        return common.cnormal(gen, shape, dtype, device)

    def ms(fn, reps):
        return common.time_ms(fn, reps=reps, device=device)

    rows = {}
    with full_precision():
        # ---- the measured compute ceiling: a c64 GEMM on the FP32 cores ----
        a, b = cn(n_gemm, n_gemm), cn(n_gemm, n_gemm)
        c = torch.empty_like(a)
        _row(rows, "cgemm_calibration", f"{n_gemm}^3 c64 torch.matmul, FP32",
             ms(lambda: torch.matmul(a, b, out=c), 10), 8.0 * n_gemm ** 3,
             3 * 8 * n_gemm ** 2, "fp32", on_card)
        del a, b, c

        # ---- HBM stream: read and write 256 MB of float32 ------------------
        x = torch.randn(64 * 2**20, generator=gen, device=device)
        y = torch.empty_like(x)
        _row(rows, "hbm_stream", "256MB f32 y = 1.0000001·x",
             ms(lambda: torch.mul(x, 1.0000001, out=y), 20), 0, 2 * x.numel() * 4,
             None, on_card)
        del x, y

        # ---- the linear path's shared factorization -------------------------
        Aq = cn(n_qr, n_qr)
        # complex Householder QR 16/3·n³, the triangular inverse 4/3·n³; A
        # read, V and R⁻¹ written (Q is never formed)
        _row(rows, "shared_qr_factor", f"{n_qr}x{n_qr} c64 + R^-1, Q implicit",
             ms(lambda: factor_qr(Aq), 3), (16.0 / 3.0 + 4.0 / 3.0) * n_qr ** 3,
             3 * 8 * n_qr ** 2, "fp32", on_card)
        del Aq

        # ---- batched shifted LU solve: one LU a candidate (P4) --------------
        Al = cn(n_lu, n_lu)
        lams = cn(k_lu) * 0.1
        Bv = cn(k_lu, n_lu)
        stuck = torch.zeros(k_lu, dtype=torch.int32, device=device)
        _row(rows, "batched_shifted_lu_solve", f"K={k_lu} n={n_lu} c64",
             ms(lambda: batched_shifted_solve(Al, lams, stuck, 1e-12, 1.0, Bv,
                                              max_attempts=1), 10),
             k_lu * ((8.0 / 3.0) * n_lu ** 3 + 8.0 * n_lu ** 2),
             k_lu * 2 * 8 * n_lu ** 2, "tf32x3", on_card)

        # ---- K2 at the JAX row's shape and at the eig path's ----------------
        for name, n in (("hessenberg_shifted_solve", n_lu),
                        ("hessenberg_shifted_solve_eig_path", n_mv)):
            H = (torch.triu(cn(n, n), diagonal=-1) / n ** 0.5).contiguous()
            s = (cn(k_lu) * 0.7).contiguous()
            B = cn(k_lu, n)
            nbytes, flops = common.k2_work(k_lu, n)
            _row(rows, name, f"K={k_lu} n={n} c64 (K2)",
                 ms(lambda: hess_solve.hess_solve(H, s, B), 10), flops, nbytes,
                 "fp32", on_card)
            del H, B

        # ---- the population matvec ------------------------------------------
        Am = cn(n_mv, n_mv)
        Xm = cn(k_mv, n_mv)
        _row(rows, "population_matvec", f"K={k_mv} N={n_mv} c64",
             ms(lambda: torch.matmul(Xm, Am.T), 20), 8.0 * k_mv * n_mv ** 2,
             8 * n_mv ** 2 + 2 * 8 * k_mv * n_mv, "fp32", on_card)
        del Xm

        # ---- K1: refinement's certification kernel --------------------------
        x64 = cn(n_mv, dtype=torch.complex128)
        b64 = cn(n_mv, dtype=torch.complex128)
        nbytes, flops = common.k1_work(n_mv, n_mv, c64)
        _row(rows, "true_residual", f"N={n_mv} A c64, x, b c128 (K1)",
             ms(lambda: residual.true_residual(Am, x64, b64), 20), flops, nbytes,
             "fp64", on_card)
    return {"device": rec, "peaks": common.peaks(rec),
            "measured_at": time.strftime("%Y-%m-%d"), "kernels": rows}


def main(argv=None, device=None) -> int:
    ap = common.arg_parser("scorecard")
    ap.add_argument("--n-gemm", type=int, default=4096)
    ap.add_argument("--n-qr", type=int, default=4096)
    ap.add_argument("--k-lu", type=int, default=32)
    ap.add_argument("--n-lu", type=int, default=256)
    ap.add_argument("--k-mv", type=int, default=16)
    ap.add_argument("--n-mv", type=int, default=4096)
    args = ap.parse_args(argv)
    print(json.dumps(scorecard(common.run_device(args, device), args.n_gemm,
                               args.n_qr, args.k_lu, args.n_lu, args.k_mv,
                               args.n_mv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
