#!/usr/bin/env python3
"""A/B of P1 and P2 (the batched shifted Hessenberg solves that keep R) on
one NVIDIA GPU: the redesigned kernels (csrc/hess_stream.cuh) beside the
row-loop body, their first CUDA form (csrc/hess_blocked.cuh), K2 and its QR form, on chip_smoke.py's phase-5
inputs (H from the 4096² eig operand's reduction, 32 shifts drawn as the
engine draws its first ones, standard-normal right-hand sides).

    python3 tools/hess_blocked_ab.py [--large] [--ptxas]

Prints, for each design at (32, 4096) complex64: the whole solve, the sweep
alone and the back substitution alone (the row-loop body: the whole solve less
its sweep-only run), each the median of CUDA-event-timed calls in one
process, with the bound of the function's work and the R-traffic floor of a
design that keeps R (R written once and read once). Every redesigned kernel
is first held to its plain version at small and ragged shapes, in each home
of the carried row and at each cluster size (chip_smoke.check_k2's bars).
--large adds one call of each design at (32, 16384) with the device memory
it adds; --ptxas prints the new kernels' registers and spills; --scan times
the redesign's back substitution by cluster size (with the card's
cudaOccupancyMaxActiveClusters) and both of its kernels by batch size. Exits
non-zero if a check fails or there is no card.
"""
import argparse
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def ptxas_report(build):
    """Registers, spills and shared memory of the redesign's kernels, as
    nvcc -Xptxas -v prints them."""
    for src in ("hess_stream_v2.cu", "hess_stream_v3.cu"):
        out = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.devnull, os.path.join(build.CSRC, src)],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(out.stdout + out.stderr)
        lines = out.stdout.splitlines() + out.stderr.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
                kind = "sweep" if "sweep" in name else "back"
                info = " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                  if "Used" in x or "spill" in x)
                print(f"[ptxas] {src} {kind} {name[:60]}...: {info}", flush=True)


def r_floor_ms(K, N, tiled, esz):
    """R written once and read once, at the HBM rate."""
    from maus_tpu_torch.ops.kernels import hess_solve as hs

    return 2 * K * hs.r_elems(N, tiled) * esz / cs.HBM_BYTES_PER_S * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hess_blocked_ab: no CUDA card")
    from maus_tpu_torch.ops import hessenberg
    from maus_tpu_torch.ops.kernels import build
    from maus_tpu_torch.ops.kernels import hess_solve as hs

    print(cs.card_line(), flush=True)
    build.library()
    if args.ptxas:
        ptxas_report(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    new = {"P1": (hs.hess_solve_v2, hs.hess_solve_v2_plain, False),
           "P2": (hs.hess_solve_v3, hs.hess_solve_v3_plain, True)}
    old = {"P1": hs.hess_solve_v2_rowloop, "P2": hs.hess_solve_v3_rowloop}

    # (32, 4096) complex64 on the phase-5 inputs
    K, N = cs.EIG_CANDIDATES, cs.EIG_N
    A = cs.eig_operand(N, cs.SEED, dev)
    H = hessenberg.reduce_hessenberg_auto(A).h
    del A
    spread = float(torch.linalg.vector_norm(H)) / math.sqrt(N)
    lam = torch.complex(torch.randn(K, generator=gen, device=dev),
                        torch.randn(K, generator=gen, device=dev)) * (spread / math.sqrt(2.0))
    shifts = (-lam).contiguous()
    B = torch.complex(torch.randn(K, N, generator=gen, device=dev),
                      torch.randn(K, N, generator=gen, device=dev))
    # the row-loop body first: the whole solve and its sweep alone
    pr4 = {}
    for name in old:
        pr4[name] = (cs.time_ms(lambda: old[name](H, shifts, B), reps=5),
                     cs.time_ms(lambda: old[name](H, shifts, B, sweep_only=True), reps=5))
        print(f"[pr4] {name} ({K}, {N}) complex64: whole {pr4[name][0]:.3f} ms, sweep "
              f"alone {pr4[name][1]:.3f} ms, back substitution by difference "
              f"{pr4[name][0] - pr4[name][1]:.3f} ms", flush=True)
    # the redesign against its plain version: ragged shapes, both dtypes,
    # each home of the carried row, each cluster size
    def reduced(k, n, dtype):
        rdt = dtype.to_real()
        A = cs.cnormal(gen, (n, n), dtype, dev) / math.sqrt(2 * n)
        H = hessenberg.reduce_hessenberg_auto(A).h
        s = torch.complex(torch.randn(k, generator=gen, dtype=rdt, device=dev),
                          torch.randn(k, generator=gen, dtype=rdt, device=dev)) * 0.3
        return H, s, cs.cnormal(gen, (k, n), dtype, dev)

    for (k, n, dtype) in ((1, 1, torch.complex64), (1, 2, torch.complex64),
                          (7, 129, torch.complex64), (3, 1000, torch.complex64),
                          (2, 64, torch.complex64), (4, 512, torch.complex128),
                          (3, 600, torch.complex128), (2, 6000, torch.complex64),
                          (2, 3000, torch.complex128)):
        H_, s_, B_ = reduced(k, n, dtype)
        for name, (solve, plain, tiled) in new.items():
            r = cs.check_k2(solve, plain, H_, s_, B_, f"{name} ({k}, {n}) {dtype}")
            plan = hs.card_plan(k, n, dtype, tiled)
            print(f"[check] {name} ({k}, {n}) {str(dtype)[6:]}, carried row "
                  f"{plan['home']}, cluster {plan['cluster']}: residual "
                  f"{r['resid']:.3e} (plain {r['plain_resid']:.3e}, bar {r['bar']:g}), "
                  f"max|Δ| {r['max_abs_err']:.3e}", flush=True)
            sizes = (2, 3, 8) if n > 128 else (1, 2, 3, 8)
            for C in sizes:
                cs.check_k2(lambda h, s0, b0: solve(h, s0, b0, cluster=C), plain,
                            H_, s_, B_, f"{name} ({k}, {n}) cluster {C}")
            print(f"[check] {name} ({k}, {n}) at clusters {sizes}: held", flush=True)
        del H_, B_
    # the carried row in global memory (3I plus a small Hessenberg part)
    for n, dtype in ((16673, torch.complex128),):
        H_ = torch.triu(cs.cnormal(gen, (n, n), dtype, dev), diagonal=-1) / n \
            + 3.0 * torch.eye(n, dtype=dtype, device=dev)
        s_ = torch.full((1,), 0.5 + 0.5j, dtype=dtype, device=dev)
        B_ = cs.cnormal(gen, (1, n), dtype, dev)
        for name, (solve, plain, _) in new.items():
            r = cs.check_k2(solve, plain, H_, s_, B_, f"{name} (1, {n}) {dtype}")
            print(f"[check] {name} (1, {n}) {str(dtype)[6:]}, carried row "
                  f"{hs.blocked_plan(1, n, dtype)['home']}: residual {r['resid']:.3e} "
                  f"(bar {r['bar']:g})", flush=True)
        del H_, B_
        torch.cuda.empty_cache()

    for name, (solve, plain, _) in new.items():
        r = cs.check_k2(solve, plain, H, shifts, B, f"{name} ({K}, {N})")
        print(f"[check] {name} ({K}, {N}) complex64: residual {r['resid']:.3e} (plain "
              f"{r['plain_resid']:.3e}), backward error {r['berr']:.3e} (bar {r['bar']:g})",
              flush=True)
        del r
    bound, by = cs.bound_ms((N * (N + 1) // 2 + N - 1 + K + 2 * K * N) * 8,
                            14 * K * N ** 2, cs.FP32_FLOPS)
    t = {}
    for turn in range(2):
        for name, (solve, _, tiled) in new.items():
            t.setdefault((name, "rowloop"), []).append(
                cs.time_ms(lambda: old[name](H, shifts, B), reps=5))
            t.setdefault((name, "rowloop sweep"), []).append(
                cs.time_ms(lambda: old[name](H, shifts, B, sweep_only=True), reps=5))
            t.setdefault((name, "new"), []).append(
                cs.time_ms(lambda: solve(H, shifts, B), reps=10))
            R, Y = hs.blocked_sweep(H, shifts, B, tiled)
            t.setdefault((name, "new sweep"), []).append(
                cs.time_ms(lambda: hs.blocked_sweep(H, shifts, B, tiled), reps=10))
            t.setdefault((name, "new back"), []).append(
                cs.time_ms(lambda: hs.blocked_back(R, Y, tiled), reps=10))
            del R, Y
        t.setdefault(("K2", "rq"), []).append(
            cs.time_ms(lambda: hs.hess_solve(H, shifts, B), reps=10))
        t.setdefault(("K2", "qr"), []).append(
            cs.time_ms(lambda: hs.hess_solve_qr(H, shifts, B), reps=5))
    for name, (_, _, tiled) in new.items():
        old_back = [a - b for a, b in zip(t[(name, "rowloop")], t[(name, "rowloop sweep")])]
        print(f"[time] {name} ({K}, {N}) complex64, two turns: redesign "
              f"{[round(x, 4) for x in t[(name, 'new')]]} ms (sweep "
              f"{[round(x, 4) for x in t[(name, 'new sweep')]]}, back substitution "
              f"{[round(x, 4) for x in t[(name, 'new back')]]}); the row-loop body "
              f"{[round(x, 3) for x in t[(name, 'rowloop')]]} ms (sweep "
              f"{[round(x, 3) for x in t[(name, 'rowloop sweep')]]}, back substitution "
              f"by difference {[round(x, 3) for x in old_back]}); speed-up "
              f"{min(t[(name, 'rowloop')]) / max(t[(name, 'new')]):.2f}×; bound "
              f"{bound:.4f} ms ({by}), R-traffic floor "
              f"{r_floor_ms(K, N, tiled, 8):.3f} ms", flush=True)
    print(f"[time] K2 ({K}, {N}) complex64: RQ {[round(x, 4) for x in t[('K2', 'rq')]]} ms, "
          f"QR form {[round(x, 3) for x in t[('K2', 'qr')]]} ms", flush=True)
    if args.scan:
        for name, (_, _, tiled) in new.items():
            R, Y = hs.blocked_sweep(H, shifts, B, tiled)
            for C in range(2, hs.BLOCKED_MAX_CLUSTER + 1):
                ms = cs.time_ms(lambda: hs.blocked_back(R, Y, tiled, cluster=C), reps=5)
                print(f"[scan] {name} back substitution ({K}, {N}) at cluster {C}: "
                      f"{ms:.4f} ms; active clusters "
                      f"{hs.back_occupancy(C, B.dtype, tiled)}", flush=True)
            del R, Y
            for k in (1, 4, 8, 16, 24, 28, 32):
                Hk, sk, Bk = H, shifts[:k].contiguous(), B[:k].contiguous()
                sw = cs.time_ms(lambda: hs.blocked_sweep(Hk, sk, Bk, tiled), reps=5)
                R, Y = hs.blocked_sweep(Hk, sk, Bk, tiled)
                bk = cs.time_ms(lambda: hs.blocked_back(R, Y, tiled), reps=5)
                print(f"[scan] {name} K = {k}: sweep {sw:.4f} ms, back substitution "
                      f"{bk:.4f} ms (cluster {hs.card_plan(k, N, B.dtype, tiled)['cluster']})",
                      flush=True)
                del R, Y
    # drift between candidates: the redesign at K = 1
    for name, (solve, _, _) in new.items():
        one = cs.time_ms(lambda: solve(H, shifts[:1], B[:1].contiguous()), reps=10)
        print(f"[time] {name} (1, {N}) complex64: {one:.4f} ms", flush=True)
    del H, B
    torch.cuda.empty_cache()

    if args.large:
        n = cs.LARGE_N
        g16 = torch.Generator(device=dev)
        g16.manual_seed(cs.SEED + 2)
        Hb = torch.triu(cs.cnormal(g16, (n, n), torch.complex64, dev), diagonal=-1) / n \
            + 3.0 * torch.eye(n, dtype=torch.complex64, device=dev)
        Bb = cs.cnormal(g16, (K, n), torch.complex64, dev)
        for label, fn in (("P1", hs.hess_solve_v2), ("P2", hs.hess_solve_v3),
                          ("P1 rowloop", hs.hess_solve_v2_rowloop),
                          ("P2 rowloop", hs.hess_solve_v3_rowloop), ("K2", hs.hess_solve)):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            W = fn(Hb, shifts, Bb)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            res = float(cs.shifted_residual(Hb, shifts, W, Bb).max())
            del W
            ms = cs.time_ms(lambda: fn(Hb, shifts, Bb), reps=1)
            print(f"[large] {label} ({K}, {n}) complex64: {ms:.3f} ms, extra device "
                  f"memory {extra / 2**30:.3f} GiB, residual {res:.3e}", flush=True)


if __name__ == "__main__":
    main()
