#!/usr/bin/env python3
"""Smoke run of maus_tpu_torch on one NVIDIA GPU: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that its
two main paths run on the card through those kernels: a dense,
ill-conditioned complex64 Ax=b at 4096², κ = 1e6, solved to 1e-8 (kernel
K1), and 16 eigenpairs of a general complex64 4096² operand to 1e-8 (kernel
K2).

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. the card, as nvidia-smi names it, with its power limit;
  1. build kernels K1 and K2 from maus_tpu_torch/csrc/ (one nvcc per source);
  2. K1 (the true-FP64 residual) against its plain PyTorch version at the
     main path's shapes and a few ragged ones, within 1e-15·‖A‖_F·‖x‖, and
     the median time of each and of torch.addmv at complex128;
  3. maus_tpu_torch.solve at 4096², κ = 1e6, tol 1e-8, 16 candidates, checked
     by an independent FP64 residual, with K1's launch count;
  4. the same at 16384², one timed run;
  5. K2 (the batched shifted Hessenberg solve) against its plain version at
     the eig slice shape (32 candidates, 4096², complex64, H from the eig
     operand's reduction) and ragged shapes, by the relative residual
     ‖(H + s_k I)w_k − b_k‖/‖b_k‖ and the normwise backward error, with
     the zero-pivot contract and the global-memory carried row (N = 10241,
     complex128), and the median times of the kernel, the plain version and
     torch.linalg.solve (dense batched LU) at the slice shape;
  6. maus_tpu_torch.eig of A = (G₁ + iG₂)/√N at 4096², complex64, 32
     candidates, 16 targets, tol 1e-8: ≥ 16 distinct pairs, the best 16 each
     at ≤ 1e-8 by an independent complex128 residual and pairwise distinct,
     with K2's launch count; one first run, then one timed warm run.
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
EIG_N = 4096
EIG_CANDIDATES = 32
EIG_TARGETS = 16
EIG_MAX_ITERATIONS = 100
# the smallest complex128 N whose carried row leaves K2's shared memory
# (maus_tpu_torch/ops/kernels/hess_solve.py, _SHARED_ROW_BYTES)
K2_GLOBAL_ROW_N = 10241
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the FP32 and FP64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12


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


def bound_ms(nbytes, flops, peak_flops):
    """The least time of the work on the card: the larger of its bytes over
    the HBM rate and its operations over the peak rate; and which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def eig_operand(n, seed, device):
    """A = (G₁ + iG₂)/√N with G₁, G₂ standard normal, complex64, built on the
    card from a seeded torch.Generator: the JAX package's general eig probe
    operand (benchmarks/spectral_large_probe.py, _device_operand)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    re = torch.randn(n, n, generator=g, dtype=torch.float32, device=device)
    im = torch.randn(n, n, generator=g, dtype=torch.float32, device=device)
    return (torch.complex(re, im) / math.sqrt(n)).contiguous()


def shifted_residual(H, shifts, W, B):
    """Per-row ‖(H + s_k I) w_k − b_k‖ / ‖b_k‖, with H's entries below the
    subdiagonal taken as zero."""
    import torch

    Hh = torch.triu(H, diagonal=-1)
    R = W @ Hh.T + shifts[:, None] * W - B
    return torch.linalg.vector_norm(R, dim=-1) / torch.linalg.vector_norm(B, dim=-1)


def backward_error(H, shifts, W, B):
    """Per-row normwise backward error ‖r_k‖ / (‖H + s_k I‖_F·‖w_k‖ + ‖b_k‖)
    of the shifted solves: free of the systems' conditioning, which sets
    the relative residual once a shift lies near an eigenvalue."""
    import torch

    Hh = torch.triu(H, diagonal=-1)
    r = torch.linalg.vector_norm(W @ Hh.T + shifts[:, None] * W - B, dim=-1)
    d = torch.diagonal(Hh)
    off2 = torch.linalg.vector_norm(Hh) ** 2 - torch.linalg.vector_norm(d) ** 2
    hnorm = torch.sqrt(off2 + torch.linalg.vector_norm(
        d[None, :] + shifts[:, None], dim=-1) ** 2)
    return r / (hnorm * torch.linalg.vector_norm(W, dim=-1)
                + torch.linalg.vector_norm(B, dim=-1))


def check_k2(hess_solve, H, shifts, B, label):
    """K2 against its plain version on the same inputs. Each is held to the
    relative-residual bar (5e-5 in complex64, 1e-12 in complex128, the JAX
    package's Pallas-kernel bar); where the systems are so ill-conditioned
    that the plain version itself misses it, the kernel must stay within 2×
    the plain version's residual, and its normwise backward error must stay
    under the same bar. Returns the numbers."""
    import torch

    bar = 5e-5 if B.dtype == torch.complex64 else 1e-12
    Wk = hess_solve.hess_solve(H, shifts, B)
    Wp = hess_solve.hess_solve_plain(H, shifts, B)
    torch.cuda.synchronize()
    rk = float(shifted_residual(H, shifts, Wk, B).max())
    rp = float(shifted_residual(H, shifts, Wp, B).max())
    bk = float(backward_error(H, shifts, Wk, B).max())
    bp = float(backward_error(H, shifts, Wp, B).max())
    err = float((Wk - Wp).abs().max())
    rel_err = err / float(Wp.abs().max())
    if not (rk <= max(bar, 2.0 * rp) and bk <= bar and bool(torch.isfinite(
            torch.view_as_real(Wk)).all())):
        raise AssertionError(f"K2 {label}: kernel residual {rk:.3e} vs plain "
                             f"{rp:.3e}, backward error {bk:.3e} (bar {bar:g})")
    return dict(resid=rk, plain_resid=rp, berr=bk, plain_berr=bp,
                max_abs_err=err, rel_err=rel_err, bar=bar)


def eig_and_check(maus_tpu_torch, hess_solve, A, label):
    """One maus_tpu_torch.eig at the slice settings, held to the contract;
    returns the numbers."""
    import numpy as np
    import torch

    launches0 = hess_solve.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = maus_tpu_torch.eig(A, tol=TOL, num_candidates=EIG_CANDIDATES,
                             target_solutions=EIG_TARGETS,
                             max_iterations=EIG_MAX_ITERATIONS, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hess_solve.LAUNCHES - launches0
    if rep.num_distinct < EIG_TARGETS:
        raise AssertionError(f"{label}: {rep.num_distinct} distinct pairs < "
                             f"{EIG_TARGETS}")
    order = np.argsort(rep.residuals)[:EIG_TARGETS]
    A128 = A.to(torch.complex128)
    indep, lams, vecs = [], [], []
    for i in order:
        lam, v = rep.solutions[i]
        vt = torch.from_numpy(np.asarray(v, np.complex128)).to(A.device)
        if vt.shape != (A.shape[0],) or not bool(torch.isfinite(
                torch.view_as_real(vt)).all()):
            raise AssertionError(f"{label}: eigenvector of shape "
                                 f"{tuple(vt.shape)} or not finite")
        r = float(torch.linalg.vector_norm(A128 @ vt - lam * vt)
                  / torch.linalg.vector_norm(vt))
        indep.append(r)
        lams.append(lam)
        vecs.append(vt / torch.linalg.vector_norm(vt))
    if not max(indep) <= TOL:
        raise AssertionError(f"{label}: independent residuals {max(indep):.3e} "
                             f"> {TOL}")
    # pairwise distinct by the reference rule: |Δλ| ≥ 1e-5 + 1e-6·|λ| or
    # |⟨v_i, v_j⟩| ≤ 0.999
    V = torch.stack(vecs)
    overlap = (V.conj() @ V.T).abs().cpu().numpy()
    for i in range(len(lams)):
        for j in range(i):
            if abs(lams[i] - lams[j]) < 1e-5 + 1e-6 * abs(lams[j]) and \
                    overlap[i, j] > 0.999:
                raise AssertionError(f"{label}: pairs {i}, {j} are one "
                                     f"eigenpair (λ {lams[i]}, {lams[j]})")
    if launches <= 0:
        raise AssertionError(f"{label}: the eig launched K2 {launches} times")
    return dict(wall_s=wall, iterations=rep.iterations,
                num_distinct=rep.num_distinct, worst_of_best=max(indep),
                worst_reported=max(rep.residuals[i] for i in order),
                launches=launches, **rep.timings)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import maus_tpu_torch
    from maus_tpu_torch.ops import hessenberg
    from maus_tpu_torch.ops.kernels import build, hess_solve, residual

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    say(0, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = build.build(force=True)
    say(1, f"built K1 and K2 in {time.perf_counter() - t0:.2f} s -> "
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
            b_ms, b_by = bound_ms(nbytes, 8 * A.numel(), FP64_FLOPS)
            line += (f"; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
                     f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s), "
                     f"bound {b_ms:.4f} ms ({b_by})")
            library_ms = None
            if dtype == torch.complex128:
                library_ms = time_ms(lambda: torch.addmv(b, A, x, alpha=-1))
                line += f", torch.addmv {library_ms:.4f} ms"
            kernel_rows[dtype] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, nbytes=nbytes,
                                      flops=8 * A.numel())
        say(2, line)
        del ops
    torch.cuda.empty_cache()

    A, b = make_system(HEADLINE_N, COND, SEED, dev)
    torch.cuda.synchronize()
    residual.LAUNCHES = hess_solve.LAUNCHES = 0
    first = solve_and_check(maus_tpu_torch, residual, A, b, "4096² solve")
    main_path_launches = residual.LAUNCHES
    say(3, f"launches on the linear path: K1 {residual.LAUNCHES}, "
           f"K2 {hess_solve.LAUNCHES}")
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
    torch.cuda.empty_cache()

    # ---- phase 5: K2 against its plain version -----------------------------
    A = eig_operand(EIG_N, SEED, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = hessenberg.reduce_hessenberg_auto(A).h
    torch.cuda.synchronize()
    say(5, f"Hessenberg reduction of the {EIG_N}² eig operand: "
           f"{time.perf_counter() - t0:.3f} s")
    del A
    K = EIG_CANDIDATES
    # shifts −λ with λ drawn as the engine draws its first shifts (the
    # spectrum's centroid and RMS spread), right-hand sides standard normal
    spread = float(torch.linalg.vector_norm(H)) / math.sqrt(EIG_N)
    lam = torch.complex(torch.randn(K, generator=gen, device=dev),
                        torch.randn(K, generator=gen, device=dev)) \
        * (spread / math.sqrt(2.0))
    shifts = (-lam).contiguous()
    B = torch.complex(torch.randn(K, EIG_N, generator=gen, device=dev),
                      torch.randn(K, EIG_N, generator=gen, device=dev))
    k2 = check_k2(hess_solve, H, shifts, B, f"({K}, {EIG_N}) complex64")
    say(5, f"K2 vs plain ({K}, {EIG_N}) complex64: residual kernel "
           f"{k2['resid']:.3e}, plain {k2['plain_resid']:.3e}; backward error "
           f"kernel {k2['berr']:.3e}, plain {k2['plain_berr']:.3e} (bar "
           f"{k2['bar']:g}); max|Δ| {k2['max_abs_err']:.3e} "
           f"({k2['rel_err']:.3e} of max|w|)")
    for (k, n, dtype) in ((1, 1, torch.complex64), (7, 129, torch.complex64),
                          (3, 1000, torch.complex64), (4, 512, torch.complex128)):
        rdt = dtype.to_real()
        An = torch.complex(torch.randn(n, n, generator=gen, dtype=rdt, device=dev),
                           torch.randn(n, n, generator=gen, dtype=rdt, device=dev)
                           ) / math.sqrt(2 * n)
        Hn = hessenberg.reduce_hessenberg_auto(An).h
        sn = torch.complex(torch.randn(k, generator=gen, dtype=rdt, device=dev),
                           torch.randn(k, generator=gen, dtype=rdt, device=dev)) * 0.3
        Bn = torch.complex(torch.randn(k, n, generator=gen, dtype=rdt, device=dev),
                           torch.randn(k, n, generator=gen, dtype=rdt, device=dev))
        r = check_k2(hess_solve, Hn, sn, Bn, f"({k}, {n}) {dtype}")
        say(5, f"K2 vs plain ({k}, {n}) {str(dtype)[6:]}: residual kernel "
               f"{r['resid']:.3e}, plain {r['plain_resid']:.3e} (bar "
               f"{r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
        del An, Hn, Bn
    # past the kernel's shared-memory budget the carried row lives in a
    # global scratch row: N = 10241 in complex128, on 3I plus a random
    # Hessenberg part of Frobenius norm ≈ 0.7 (well conditioned without a
    # reduction)
    n = K2_GLOBAL_ROW_N
    Hg = torch.triu(torch.randn(n, n, generator=gen, dtype=torch.complex128,
                                device=dev), diagonal=-1) / n \
        + 3.0 * torch.eye(n, dtype=torch.complex128, device=dev)
    sg = torch.full((1,), 0.5 + 0.5j, dtype=torch.complex128, device=dev)
    Bg = torch.randn(1, n, generator=gen, dtype=torch.complex128, device=dev)
    r = check_k2(hess_solve, Hg, sg, Bg, f"(1, {n}) complex128")
    say(5, f"K2 vs plain (1, {n}) complex128, carried row in global memory: "
           f"residual kernel {r['resid']:.3e}, plain {r['plain_resid']:.3e} "
           f"(bar {r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
    del Hg, Bg
    torch.cuda.empty_cache()
    Hz = torch.zeros(5, 5, dtype=torch.complex64, device=dev)
    Hz[0, 1] = 1.0
    Wz = hess_solve.hess_solve(Hz, torch.zeros(2, dtype=torch.complex64, device=dev),
                               torch.ones(2, 5, dtype=torch.complex64, device=dev))
    if bool(torch.isfinite(torch.view_as_real(Wz)).all(dim=-1).all(dim=-1).any()):
        raise AssertionError("K2: an exact-zero pivot gave a finite row")
    say(5, "K2 zero-pivot contract: every row of a singular shifted H non-finite")
    k2_ms = time_ms(lambda: hess_solve.hess_solve(H, shifts, B), reps=10)
    k2_plain_ms = time_ms(lambda: hess_solve.hess_solve_plain(H, shifts, B), reps=2)
    Hd = H[None] + torch.diag_embed(shifts[:, None].expand(K, EIG_N))
    k2_lib_ms = time_ms(lambda: torch.linalg.solve(Hd, B[..., None]), reps=3)
    del Hd
    # the function's least work: read H's upper Hessenberg part, shifts and
    # B once, write W once; ~14·N² flops per candidate (10·N² in the sweep,
    # 4·N² in the back substitution)
    k2_bytes = (EIG_N * (EIG_N + 1) // 2 + EIG_N - 1 + K + 2 * K * EIG_N) * 8
    k2_flops = 14 * K * EIG_N ** 2
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops, FP32_FLOPS)
    k2_bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    r_roundtrip_ms = 2 * K * EIG_N * (EIG_N + 1) // 2 * 8 / HBM_BYTES_PER_S * 1e3
    say(5, f"K2 at ({K}, {EIG_N}) complex64: kernel {k2_ms:.3f} ms, plain "
           f"{k2_plain_ms:.1f} ms, torch.linalg.solve (dense batched LU) "
           f"{k2_lib_ms:.1f} ms; bound {k2_bound:.4f} ms ({k2_by}; bytes "
           f"alone {k2_bytes_ms:.4f} ms); the "
           f"packed R round trip's floor {r_roundtrip_ms:.3f} ms is "
           f"{100 * r_roundtrip_ms / k2_ms:.1f}% of the kernel's time")
    del H, B, shifts
    torch.cuda.empty_cache()

    # ---- phase 6: maus_tpu_torch.eig on the card ---------------------------
    A = eig_operand(EIG_N, SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    residual.LAUNCHES = hess_solve.LAUNCHES = 0
    first = eig_and_check(maus_tpu_torch, hess_solve, A, "4096² eig")
    eig_launches = hess_solve.LAUNCHES
    say(6, f"launches on the eig path: K1 {residual.LAUNCHES}, K2 {eig_launches}")
    say(6, f"first eig {EIG_N}²: {first}; peak device memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    warm = eig_and_check(maus_tpu_torch, hess_solve, A, "4096² eig")
    say(6, f"{EIG_N}² general eig: {warm['num_distinct']} distinct pairs "
           f"(target {EIG_TARGETS}) in {warm['iterations']} iterations, K2 "
           f"launches {warm['launches']}; best {EIG_TARGETS} at ≤ "
           f"{warm['worst_of_best']:.3e} (independent complex128), reported ≤ "
           f"{warm['worst_reported']:.3e}; Hessenberg reduction "
           f"{warm['setup_s']:.3f} s, engine {warm['engine_s']:.3f} s, "
           f"finisher {warm['finish_s']:.3f} s; warm wall {warm['wall_s']:.3f} s "
           f"(one run after one first run)")
    del A

    k64 = kernel_rows[torch.complex64]
    k1_bound, k1_by = bound_ms(k64["nbytes"], k64["flops"], FP64_FLOPS)
    print(json.dumps({"kernels": [{
        "name": "true_residual", "route": "cuda",
        "source": "maus_tpu_torch/csrc/true_residual.cu",
        "replaces": "maus_tpu/ops/pallas/slice_residual.py:212",
        "launches": main_path_launches, "max_abs_err": k64["err"],
        "ms": k64["ms"], "plain_ms": k64["plain_ms"], "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": None}, {
        "name": "hess_solve", "route": "cuda",
        "source": "maus_tpu_torch/csrc/hess_solve.cu",
        "replaces": "maus_tpu/ops/pallas/hess_solve.py:158",
        "launches": eig_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
        "bound_by": k2_by, "library_ms": k2_lib_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
