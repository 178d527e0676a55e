#!/usr/bin/env python3
"""Smoke run of maus_tpu_torch on one NVIDIA GPU: the quickest proof that the
port builds, that its kernel agrees with its plain version, and that the main
path — a dense, ill-conditioned complex64 Ax=b at 4096², κ = 1e6, solved to
1e-8 — runs on the card through that kernel.

    python3 chip_smoke.py

Phases, each printing its own line:
  0. the card, as nvidia-smi names it, with its power limit;
  1. build kernel K1 (the true-FP64 residual) from maus_tpu_torch/csrc/;
  2. K1 against its plain PyTorch version at the main path's shapes and a few
     ragged ones, within 1e-15·‖A‖_F·‖x‖, and the median time of each;
  3. maus_tpu_torch.solve at 4096², κ = 1e6, tol 1e-8, 16 candidates, checked
     by an independent FP64 residual, with K1's launch count;
  4. the same at 16384², one timed run.
Then a JSON line with the kernel table, and as the last line
{"ok": true, "device": {...}}. Any failed phase raises, so the script exits
non-zero and prints no result line; so does a machine without CUDA.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

HEADLINE_N = 4096
LARGE_N = 16384
COND = 1e6
TOL = 1e-8
CANDIDATES = 16
MAX_ITERATIONS = 50
SEED = 0


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def make_system(n, cond, seed, device):
    """A = Q₁·diag(logspace(0, −log10 κ))·Q₂ᴴ with Haar Q₁, Q₂, and a random
    b, built on the card in complex64 from a seeded torch.Generator."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def cnormal(*shape):
        re = torch.randn(*shape, generator=g, dtype=torch.float32, device=device)
        im = torch.randn(*shape, generator=g, dtype=torch.float32, device=device)
        return torch.complex(re, im)

    def haar():
        q, r = torch.linalg.qr(cnormal(n, n))
        d = torch.diagonal(r)
        return q * (d / d.abs())[None, :]

    q1 = haar()
    q2 = haar()
    s = torch.logspace(0.0, -math.log10(cond), n,
                       dtype=torch.float32, device=device).to(torch.complex64)
    A = (q1 * s[None, :]) @ q2.mH
    del q1, q2
    return A.contiguous(), cnormal(n)


def time_ms(fn, reps=20):
    """Median device time of ``reps`` synchronised calls, timed with CUDA
    events. Before each call the card is kept busy for about a millisecond
    (``torch.cuda._sleep``), so that the host's launch overhead is spent
    while the card is busy and the events bracket device work only."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def check_kernel(residual, shape, dtype, device, gen):
    """K1 vs plain on random operands; returns (max_abs_err, bar)."""
    import torch

    m, n = shape
    rdt = dtype.to_real()
    A = torch.complex(torch.randn(m, n, generator=gen, dtype=rdt, device=device),
                      torch.randn(m, n, generator=gen, dtype=rdt, device=device))
    x = torch.complex(torch.randn(n, generator=gen, dtype=torch.float64, device=device),
                      torch.randn(n, generator=gen, dtype=torch.float64, device=device))
    b = torch.complex(torch.randn(m, generator=gen, dtype=torch.float64, device=device),
                      torch.randn(m, generator=gen, dtype=torch.float64, device=device))
    r_k = residual.true_residual(A, x, b)
    r_p = residual.true_residual_plain(A, x, b)
    torch.cuda.synchronize()
    err = float((r_k - r_p).abs().max())
    bar = 1e-15 * float(torch.linalg.vector_norm(A.to(torch.complex128))) * \
        float(torch.linalg.vector_norm(x))
    if not err <= bar:
        raise AssertionError(f"K1 disagrees with plain at {shape} {dtype}: "
                             f"{err:.3e} > {bar:.3e}")
    x_inf = x.clone()
    x_inf[n // 2] = complex(float("inf"), 0.0)
    r_inf = residual.true_residual(A, x_inf, b)
    if bool(torch.isfinite(torch.view_as_real(r_inf)).all(dim=-1).any()):
        raise AssertionError(f"an inf in x gave a finite residual row at {shape}")
    return err, bar, (A, x, b)


def solve_and_check(maus_tpu_torch, residual, A, b, label):
    """One maus_tpu_torch.solve, held to the contract; returns the numbers."""
    import torch

    launches0 = residual.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = maus_tpu_torch.solve(A, b, tol=TOL, num_candidates=CANDIDATES,
                               max_iterations=MAX_ITERATIONS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = residual.LAUNCHES - launches0
    if not rep.converged:
        raise AssertionError(f"{label}: not converged ({rep.num_distinct}/"
                             f"{rep.target_solutions})")
    x = rep.best()[0]
    reported = min(rep.residuals)
    b64 = b.to(torch.complex128)
    r = residual.true_residual_plain(A, torch.from_numpy(x).to(A.device), b64)
    independent = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
    if not (reported <= TOL and independent <= TOL):
        raise AssertionError(f"{label}: residual reported {reported:.3e}, "
                             f"independent {independent:.3e} > {TOL}")
    if x.shape != (A.shape[1],) or not bool(torch.isfinite(
            torch.from_numpy(x).abs()).all()):
        raise AssertionError(f"{label}: solution has shape {x.shape} or is not finite")
    if launches <= 0:
        raise AssertionError(f"{label}: the solve launched K1 {launches} times")
    return dict(wall_s=wall, iterations=rep.iterations,
                num_distinct=rep.num_distinct, reported=reported,
                independent=independent, launches=launches,
                cond_estimate=rep.knowledge.cond_estimate)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import maus_tpu_torch
    from maus_tpu_torch.ops.kernels import build, residual

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    say(0, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = build.build(force=True)
    say(1, f"built K1 in {time.perf_counter() - t0:.2f} s -> "
           f"{os.path.relpath(lib_path)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernel_rows = {}
    for shape, dtype in (((HEADLINE_N, HEADLINE_N), torch.complex64),
                         ((HEADLINE_N, HEADLINE_N), torch.complex128),
                         ((4097, 4097), torch.complex64),
                         ((1000, 777), torch.complex64),
                         ((1, 513), torch.complex64)):
        err, bar, ops = check_kernel(residual, shape, dtype, dev, gen)
        line = f"K1 vs plain {shape} {str(dtype)[6:]}: max|Δ| {err:.3e} <= {bar:.3e}"
        if shape == (HEADLINE_N, HEADLINE_N):
            A, x, b = ops
            ms = time_ms(lambda: residual.true_residual(A, x, b))
            plain_ms = time_ms(lambda: residual.true_residual_plain(A, x, b))
            nbytes = A.numel() * A.element_size() + (x.numel() + 2 * b.numel()) * 16
            line += (f"; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
                     f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s)")
            kernel_rows[dtype] = dict(err=err, ms=ms, plain_ms=plain_ms)
        say(2, line)
        del ops
    torch.cuda.empty_cache()

    A, b = make_system(HEADLINE_N, COND, SEED, dev)
    torch.cuda.synchronize()
    residual.LAUNCHES = 0
    first = solve_and_check(maus_tpu_torch, residual, A, b, "4096² solve")
    main_path_launches = residual.LAUNCHES
    say(3, f"first solve {HEADLINE_N}²: {first}")
    runs = [solve_and_check(maus_tpu_torch, residual, A, b, "4096² solve")
            for _ in range(3)]
    best = min(runs, key=lambda r: r["wall_s"])
    say(3, f"{HEADLINE_N}² κ={COND:g} converged; iterations {best['iterations']}, "
           f"refinement certifications (K1 launches) {best['launches']}, "
           f"residual {best['reported']:.3e} (independent {best['independent']:.3e}), "
           f"warm wall {best['wall_s']:.4f} s (best of 3 after one warm-up; "
           f"all {[round(r['wall_s'], 4) for r in runs]})")
    del A, b
    torch.cuda.empty_cache()

    A, b = make_system(LARGE_N, COND, SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    big = solve_and_check(maus_tpu_torch, residual, A, b, "16384² solve")
    say(4, f"{LARGE_N}² κ={COND:g} converged; iterations {big['iterations']}, "
           f"K1 launches {big['launches']}, residual {big['reported']:.3e} "
           f"(independent {big['independent']:.3e}), wall {big['wall_s']:.3f} s "
           f"(one run), peak device memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del A, b

    k64 = kernel_rows[torch.complex64]
    print(json.dumps({"kernels": [{
        "name": "true_residual", "route": "cuda",
        "source": "maus_tpu_torch/csrc/true_residual.cu",
        "replaces": "maus_tpu/ops/pallas/slice_residual.py:212",
        "launches": main_path_launches, "max_abs_err": k64["err"],
        "ms": k64["ms"], "plain_ms": k64["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
