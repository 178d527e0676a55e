#!/usr/bin/env python3
"""Smoke run of maus_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, that its kernels agree with their plain versions, and that
its main paths run on the card through those kernels: a dense,
ill-conditioned complex64 Ax=b at 4096², κ = 1e6, solved to 1e-8 (kernel
K1); 16 eigenpairs of a general complex64 4096² operand to 1e-8 (kernel K2, and the
blocked LU P3/P4 with the complex GEMM K3 in its finisher); 16 singular
triplets of a 4096×2048 operand to 1e-6 (P3, P4 and K3 in its finisher);
K2's RQ kernel beside its QR form and the QR form's two blocked variants P1
and P2, which the JAX package's probes run as an A/B; 16 eigenpairs of a
Hermitian complex64 operand at 4096² (deflated Lanczos) and 2048² (shared
eigh), both finished through P4; and the reference's four scenarios through
the CLI.

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. the card, as nvidia-smi names it, with its power limit;
  1. build kernels K1, K2 (and its QR form), P1, P2, K3, P3 and P4 from
     maus_tpu_torch/csrc/ (one nvcc per source, all started together);
  2. K1 (the true-FP64 residual) against its plain PyTorch version at the
     main path's shapes and a few ragged ones, within 1e-15·‖A‖_F·‖x‖, and
     the median time of each and of torch.addmv at complex128;
  3. maus_tpu_torch.solve at 4096², κ = 1e6, tol 1e-8, 16 candidates, checked
     by an independent FP64 residual, with K1's launch count;
  4. the same at 16384², one timed run;
  5. K2 (the batched shifted Hessenberg solve, the RQ kernel) against its
     plain version at the eig slice shape (32 candidates, 4096², complex64,
     H from the eig operand's reduction) at each block size, at ragged
     shapes and at each home of the state past the register fit (shared
     memory, global memory at N = 10241 complex128 and N = 17857 complex64),
     by the relative residual ‖(H + s_k I)w_k − b_k‖/‖b_k‖ and the normwise
     backward error, with the zero-pivot contract; K2's QR kernel (its first
     form), P1 and P2 (the QR kernel with a blocked back substitution; P2
     also divide-free, with R in column tiles) held the same way on the same
     inputs and shapes; the median times at the slice shape of the RQ kernel
     by block size, its step's latency floor, the plain version,
     torch.linalg.solve (dense batched LU) and the call's extra device
     memory; the A/B of the QR kernel, P1 and P2 beside it as the JAX probes
     run it (the QR-vs-P1/P2 differences, each kernel's and plain version's
     time); and one call of each design at (32, 16384), with its time and
     the device memory it adds;
  6. maus_tpu_torch.eig of A = (G₁ + iG₂)/√N at 4096², complex64, 32
     candidates, 16 targets, tol 1e-8: ≥ 16 distinct pairs, the best 16 each
     at ≤ 1e-8 by an independent complex128 residual and pairwise distinct,
     every shifted solve through the RQ kernel (none through the QR kernel,
     P1 or P2), with the launch counts of K2, P3, P4 and K3 and the peak
     device memory; one first run, then one timed warm run;
  7. K3 (the complex GEMM; complex64 on the tensor cores with split-TF32
     products, complex128 on PR 3's CUDA-core body) against its plain
     version at 4096³, at the blocked LU's first trailing updates at
     (8, 2048) and (8, 4096), at two of its last ones (M = 64, 192) and at
     ragged shapes, within
     4·K·ε·max|a|·max|b|, PR 3's body for complex64 (cgemm_simt) beside
     it; the kernel's registers, spills, CTAs a SM and shared memory; the
     times of K3, PR 3's body and torch.matmul (torch.baddbmm for the
     updates) in turns, of the plain version, and both bounds (split-TF32
     on the tensor cores, FP32 FMAs);
  8. P3/P4 (the batched LU) against the plain version: the cluster panel
     kernel's cudaOccupancyMaxActiveClusters by cluster size and the size
     chosen at (8, 2048) and (8, 4096), and the time of one cluster barrier;
     shifted Gram systems of the SVD operand at (8, 2048), shifted eig
     matrices at (8, 4096), (16, 256), ragged shapes and complex128, by the
     normwise backward error ‖P·H − L·U‖_F/‖H‖_F ≤ 10·√N·ε, the normwise
     backward error of torch.linalg.lu_solve on the kernel's factors, the
     pivots, and the zero-pivot contract; the panel [0, 64) of (8, 4096) on
     the cluster kernel and on the one-block kernel, each with the plain
     version's pivots; with the times of the kernels (P4 beside PR 5's),
     the plain versions and torch.linalg.lu_factor, kernel and library in
     turns, and P4's device time by kernel;
  9. maus_tpu_torch.svd of A = U·diag(σ)·Vᴴ at 4096×2048 (σ = 0.8^k for
     k < 16, then logspace(−2, −4)), 32 candidates, 16 targets, tol 1e-6:
     ≥ 16 distinct triplets, the 16 largest σ within 1e-8 of 0.8^k and at
     ≤ 1e-6 by an independent complex128 residual, with the launch counts of
     P3, P4 and K3; one first run, then one timed warm run;
 10. maus_tpu_torch.eig of the Hermitian A = (G + Gᴴ)/2, G = (G₁ + iG₂)/√N,
     at 4096², complex64, 32 candidates, 16 targets, tol 1e-8 (N past
     eigh_max_n: the deflated-Lanczos branch): diagnosed Hermitian, ≥ 16
     distinct pairs, the best 16 each at ≤ 1e-8 by an independent
     complex128 residual and within 1e-8·‖A‖₂ of torch.linalg.eigvalsh of
     the complex128 operand, P4 launched by the finisher; one first run,
     then one timed warm run;
 11. the same at 2048², one run: the shared-eigh branch (no Lanczos call);
 12. maus_tpu_torch.cli.main(["scenarios"]) on the card: exit code 0 and the
     reference's four scenarios passed at 1/1, 8/8, 8/8 and 2/2.
On every solver path K3 launches once for each trailing update of the
path's LUs, and PR 3's CUDA-core body never (checked).
Then a JSON line with the kernel table, and as the last line
{"ok": true, "device": {...}}. Any failed phase raises, so the script exits
non-zero and prints no result line; so does a machine without CUDA.
"""
import contextlib
import ctypes
import io
import json
import math
import os
import re
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
SVD_M, SVD_N = 4096, 2048
SVD_TOP = 16                 # σ = 0.8^k above the logspace(−2, −4) tail
SVD_CANDIDATES = 32
SVD_TOL = 1e-6
SVD_MAX_ITERATIONS = 100
LU_BATCH = 8                 # the finishers' chunk of per-candidate systems
# PR 2's eig finisher on the same card type (PERF.md §5): the 4096² eig's
# finish_s with torch.linalg.lu_factor, first smoke run and final run
PR2_FINISH_S = (1.880, 2.094)
# P4 at (8, 2048) and (8, 4096) in PR 5's first full smoke run (PERF.md §6),
# its trailing updates on K3's CUDA-core body
PR5_P4_MS = {2048: 12.714, 4096: 60.693}
# the smallest complex128 N whose carried row leaves the QR kernel's shared
# memory (maus_tpu_torch/ops/kernels/hess_solve.py, _SHARED_ROW_BYTES), past
# which the RQ kernel's rows beyond the register fit also leave shared
# memory (rq_plan, 512 threads); the smallest complex64 N past which the RQ
# kernel's do; and that of P1 and P2's carried row
# (_SHARED_ROW_BYTES_BLOCKED)
K2_GLOBAL_ROW_N = 10241
K2_GLOBAL_ROW_N_C64 = 17857
BLOCKED_GLOBAL_ROW_N = 8193
# the 4096² eig with K2's QR kernel (PERF.md §5): iterations, distinct pairs
QR_EIG = (6, 21)
HERM_SMALL_N = 2048          # the shared-eigh branch (SolverConfig.eigh_max_n)
# the reference's scenario counts (README.md, "Results vs the reference")
SCENARIO_COUNTS = ["1/1", "8/8", "8/8", "2/2"]
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the FP32 and FP64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
# the dense TF32 tensor-core rate, which K3's split-TF32 products use
TF32_FLOPS = 495e12


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


def check_k2(solve, plain, H, shifts, B, label):
    """A shifted Hessenberg solve kernel (K2, P1 or P2: ``solve``) against
    its plain version on the same inputs. Each is held to the
    relative-residual bar (5e-5 in complex64, 1e-12 in complex128, the JAX
    package's Pallas-kernel bar); where the systems are so ill-conditioned
    that the plain version itself misses it, the kernel must stay within 2×
    the plain version's residual, and its normwise backward error must stay
    under the same bar. Returns the numbers and the kernel's solution."""
    import torch

    bar = 5e-5 if B.dtype == torch.complex64 else 1e-12
    Wk = solve(H, shifts, B)
    Wp = plain(H, shifts, B)
    torch.cuda.synchronize()
    rk = float(shifted_residual(H, shifts, Wk, B).max())
    rp = float(shifted_residual(H, shifts, Wp, B).max())
    bk = float(backward_error(H, shifts, Wk, B).max())
    bp = float(backward_error(H, shifts, Wp, B).max())
    err = float((Wk - Wp).abs().max())
    rel_err = err / float(Wp.abs().max())
    if not (rk <= max(bar, 2.0 * rp) and bk <= bar and bool(torch.isfinite(
            torch.view_as_real(Wk)).all())):
        raise AssertionError(f"{label}: kernel residual {rk:.3e} vs plain "
                             f"{rp:.3e}, backward error {bk:.3e} (bar {bar:g})")
    return dict(resid=rk, plain_resid=rp, berr=bk, plain_berr=bp,
                max_abs_err=err, rel_err=rel_err, bar=bar, W=Wk)


def eig_and_check(maus_tpu_torch, hess_solve, A, label, hermitian=False):
    """One maus_tpu_torch.eig at the slice settings, held to the contract;
    returns the numbers. A general A must have gone through K2; a Hermitian
    A must be diagnosed Hermitian, and each of the best pairs' λ must lie
    within TOL·‖A‖₂ of an eigenvalue of torch.linalg.eigvalsh of the
    complex128 operand."""
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
    out = dict(wall_s=wall, iterations=rep.iterations,
               num_distinct=rep.num_distinct, worst_of_best=max(indep),
               worst_reported=max(rep.residuals[i] for i in order),
               launches=launches, **rep.timings)
    if hermitian:
        w = torch.linalg.eigvalsh(A128).cpu().numpy()
        lam_err = max(float(np.min(np.abs(w - lam))) for lam in lams)
        bar = TOL * float(np.abs(w).max())
        if not (rep.knowledge.is_hermitian and lam_err <= bar):
            raise AssertionError(f"{label}: Hermitian {rep.knowledge.is_hermitian}, "
                                 f"λ off eigvalsh by {lam_err:.3e} > {bar:.3e}")
        out["lam_err"] = lam_err
    elif launches <= 0:
        raise AssertionError(f"{label}: the eig launched K2 {launches} times")
    return out


def hermitian_operand(n, seed, device):
    """A = (G + Gᴴ)/2 with G = (G₁ + iG₂)/√N (eig_operand), complex64: the
    JAX package's Hermitian eig probe operand
    (benchmarks/spectral_large_probe.py, _device_operand, kind hermitian)."""
    G = eig_operand(n, seed, device)
    return ((G + G.mH) / 2).contiguous()


def cnormal(gen, shape, dtype, device):
    """Standard complex normal entries (unit variance per plane) drawn from
    ``gen`` on the card."""
    import torch

    rdt = dtype.to_real()
    return torch.complex(torch.randn(*shape, generator=gen, dtype=rdt, device=device),
                         torch.randn(*shape, generator=gen, dtype=rdt, device=device))


def check_cgemm(fn, cgemm, a, b, label):
    """A K3 kernel (``fn``: cgemm.cgemm, or PR 3's body cgemm.cgemm_simt)
    against its plain version: max|Δ| ≤ 4·K·ε·max|a|·max|b| (one rounding
    per FMA along K, c = 4 for the four real products of the complex
    product; the split-TF32 products of the tensor-core kernel keep within
    it, csrc/cgemm_tc.cu). Returns (max|Δ|, bar)."""
    import torch

    got = fn(a, b)
    want = cgemm.cgemm_plain(a, b)
    torch.cuda.synchronize()
    eps = torch.finfo(a.real.dtype).eps
    bar = 4 * a.shape[1] * eps * float(a.abs().max()) * float(b.abs().max())
    err = float((got - want).abs().max())
    if not (err <= bar and bool(torch.isfinite(torch.view_as_real(got)).all())):
        raise AssertionError(f"K3 {label}: max|Δ| {err:.3e} > {bar:.3e}")
    return err, bar


def lu_backward_error(H, lu, piv):
    """max over the batch of ‖P·H − L·U‖_F/‖H‖_F in complex128, P from the
    1-based sequential interchanges ``piv``."""
    import numpy as np
    import torch

    N = H.shape[-1]
    eye = torch.eye(N, dtype=torch.complex128, device=H.device)
    worst = 0.0
    for b, p in enumerate(piv.cpu().numpy() - 1):
        perm = np.arange(N)
        for i, j in enumerate(p):
            perm[[i, j]] = perm[[j, i]]
        Hb = H[b].to(torch.complex128)
        f = lu[b].to(torch.complex128)
        r = Hb[torch.from_numpy(perm).to(H.device)] - \
            (torch.tril(f, -1) + eye) @ torch.triu(f)
        worst = max(worst, float(torch.linalg.matrix_norm(r)
                                 / torch.linalg.matrix_norm(Hb)))
        del Hb, f, r
    return worst


def solve_backward_error(H, lu, piv, gen):
    """max over the batch of the normwise backward error
    ‖H·x − b‖/(‖H‖_F·‖x‖ + ‖b‖) of torch.linalg.lu_solve on the factors,
    in complex128, for a random right-hand side."""
    import torch

    b = cnormal(gen, H.shape[:2], H.dtype, H.device)
    x = torch.linalg.lu_solve(lu, piv, b[..., None])[..., 0]
    worst = 0.0
    for k in range(H.shape[0]):
        Hk = H[k].to(torch.complex128)
        xk, bk = x[k].to(torch.complex128), b[k].to(torch.complex128)
        r = torch.linalg.vector_norm(Hk @ xk - bk)
        worst = max(worst, float(r / (torch.linalg.matrix_norm(Hk)
                                      * torch.linalg.vector_norm(xk)
                                      + torch.linalg.vector_norm(bk))))
    return worst


def check_lu(lu, H, gen, label, c=10.0):
    """P4 (with P3 and K3 inside) against its plain version on one batch:
    both normwise backward errors ≤ c·√N·ε, finite factors, and the pivots
    compared. They agree but for rounding ties: where two candidates' |a|²
    lie within rounding of each other the two versions may pick different
    rows, and from that column on their trailing matrices, and so all later
    pivots, differ; hence the first differing column of each matrix.
    Returns the numbers."""
    import torch

    lu_k, piv_k = lu.lu_factor(H)
    lu_p, piv_p = lu.lu_factor_plain(H)
    torch.cuda.synchronize()
    N = H.shape[-1]
    differ = (piv_k != piv_p).cpu()
    first = [int(row.nonzero()[0]) if bool(row.any()) else None for row in differ]
    bar = c * math.sqrt(N) * torch.finfo(H.real.dtype).eps
    out = dict(berr=lu_backward_error(H, lu_k, piv_k),
               plain_berr=lu_backward_error(H, lu_p, piv_p),
               solve_berr=solve_backward_error(H, lu_k, piv_k, gen),
               piv_mismatch=int(differ.sum()), first_mismatch=first,
               max_abs_err=float((lu_k - lu_p).abs().max()), bar=bar)
    if not (out["berr"] <= bar and out["solve_berr"] <= bar and
            bool(torch.isfinite(torch.view_as_real(lu_k)).all())):
        raise AssertionError(f"P4 {label}: backward error {out['berr']:.3e}, "
                             f"solve {out['solve_berr']:.3e} > {bar:.3e}")
    return out


def p4_breakdown(lu, H):
    """The device time of one lu.lu_factor(H) by kernel name, in ms, from
    torch.profiler's trace of the card; "not measured" where the trace
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lu.lu_factor(H)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lu.lu_factor(H)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        m = re.search(r"(\w+_kernel)\b", ev.key)
        if us > 0 and m:
            out[m.group(1)] = round(out.get(m.group(1), 0.0) + us / 1e3, 4)
    return out or "not measured"


def svd_operand(m, n, top, seed, device):
    """A = U·diag(σ)·Vᴴ with U (m×n) and V (n×n) Haar (QR of complex
    Gaussians with the phases of R's diagonal fixed), σ = 0.8^k for k < top
    and logspace(−2, −4) for the rest: the JAX package's SVD probe operand
    (benchmarks/spectral_large_probe.py, _svd_operand). Built in complex128
    on the card from a seeded torch.Generator, so that σ is known to FP64;
    the solver runs on its complex64 working copy. Returns (A, σ)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def haar(rows, cols):
        q, r = torch.linalg.qr(cnormal(g, (rows, cols), torch.complex128, device))
        d = torch.diagonal(r)
        return q * (d / d.abs())[None, :]

    U = haar(m, n)
    V = haar(n, n)
    sig = torch.cat([0.8 ** torch.arange(top, dtype=torch.float64, device=device),
                     torch.logspace(-2.0, -4.0, n - top, dtype=torch.float64,
                                    device=device)])
    A = (U * sig[None, :]) @ V.mH
    del U, V
    return A.contiguous(), sig


def svd_and_check(maus_tpu_torch, A, sig, label):
    """One maus_tpu_torch.svd at the slice settings, held to the contract:
    ≥ SVD_TOP distinct triplets; the SVD_TOP largest σ within 1e-8 relative
    of 0.8^k and each at ≤ SVD_TOL by an independent complex128 two-sided
    residual ‖Av − σu‖ + ‖Aᴴu − σv‖; so is each of the SVD_TOP best by the
    reported residual. Returns the numbers."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = maus_tpu_torch.svd(A, tol=SVD_TOL, max_iterations=SVD_MAX_ITERATIONS,
                             num_candidates=SVD_CANDIDATES,
                             target_solutions=SVD_TOP, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rep.num_distinct < SVD_TOP:
        raise AssertionError(f"{label}: {rep.num_distinct} distinct triplets < "
                             f"{SVD_TOP}")

    def indep(i):
        s_, u_, v_ = rep.solutions[i]
        u = torch.from_numpy(np.asarray(u_, np.complex128)).to(A.device)
        v = torch.from_numpy(np.asarray(v_, np.complex128)).to(A.device)
        if u.shape != (A.shape[0],) or v.shape != (A.shape[1],) or not bool(
                torch.isfinite(torch.view_as_real(torch.cat([u, v]))).all()):
            raise AssertionError(f"{label}: triplet {i} has vectors of shape "
                                 f"{tuple(u.shape)}, {tuple(v.shape)} or not finite")
        return float(torch.linalg.vector_norm(A @ v - s_ * u)
                     + torch.linalg.vector_norm(A.mH @ u - s_ * v))

    top = sorted(range(rep.num_distinct), key=lambda i: -rep.solutions[i][0])[:SVD_TOP]
    best = list(np.argsort(rep.residuals)[:SVD_TOP])
    sig_h = sig[:SVD_TOP].cpu().numpy()
    sig_err = max(abs(rep.solutions[i][0] - sig_h[j]) / sig_h[j]
                  for j, i in enumerate(top))
    worst_top = max(indep(i) for i in top)
    worst_best = max(indep(int(i)) for i in best)
    if not (sig_err <= 1e-8 and worst_top <= SVD_TOL and worst_best <= SVD_TOL):
        raise AssertionError(f"{label}: σ off 0.8^k by {sig_err:.3e} (relative), "
                             f"independent residuals {worst_top:.3e} (top "
                             f"{SVD_TOP}), {worst_best:.3e} (best {SVD_TOP})")
    t = rep.timings
    return dict(wall_s=wall, iterations=rep.iterations,
                num_distinct=rep.num_distinct, target=rep.target_solutions,
                converged=rep.converged, sigma_rel_err=sig_err,
                worst_top=worst_top, worst_best=worst_best,
                construct_s=wall - t["setup_s"] - t["engine_s"] - t["finish_s"],
                **t)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import maus_tpu_torch
    from maus_tpu_torch import cli
    from maus_tpu_torch.ops import hessenberg, lanczos
    from maus_tpu_torch.ops.kernels import build, cgemm, hess_solve, lu, residual

    def reset_counts():
        residual.LAUNCHES = hess_solve.LAUNCHES = cgemm.LAUNCHES = 0
        cgemm.LAUNCHES_SIMT = 0
        hess_solve.LAUNCHES_QR = 0
        hess_solve.LAUNCHES_V2 = hess_solve.LAUNCHES_V3 = 0
        lu.LAUNCHES = lu.PANEL_LAUNCHES = lu.CLUSTER_PANEL_LAUNCHES = 0
        lanczos.CALLS = 0

    def counts():
        return dict(K1=residual.LAUNCHES, K2=hess_solve.LAUNCHES,
                    K2_QR=hess_solve.LAUNCHES_QR, P1=hess_solve.LAUNCHES_V2,
                    P2=hess_solve.LAUNCHES_V3,
                    P3_panel=lu.PANEL_LAUNCHES, P3_cluster=lu.CLUSTER_PANEL_LAUNCHES,
                    P4_blocked=lu.LAUNCHES,
                    K3=cgemm.LAUNCHES, K3_simt=cgemm.LAUNCHES_SIMT,
                    lanczos_calls=lanczos.CALLS)

    def check_k3_counts(c, n, label):
        """Every trailing update of the path's LUs (⌈n/64⌉ − 1 a
        factorization of order n) went through K3, none through PR 3's
        body."""
        want = c["P4_blocked"] * (-(-n // lu.NB) - 1)
        if c["K3"] != want or c["K3_simt"] != 0:
            raise AssertionError(f"{label}: K3 launched {c['K3']} times (want "
                                 f"{want}), PR 3's body {c['K3_simt']} times")

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    say(0, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = build.build(force=True)
    say(1, f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.2f} s -> "
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
    reset_counts()
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
    k2 = check_k2(hess_solve.hess_solve, hess_solve.hess_solve_rq_plain, H,
                  shifts, B, f"K2 ({K}, {EIG_N}) complex64")
    say(5, f"K2 (RQ kernel, {hess_solve.RQ_THREADS} threads, "
           f"{hess_solve.rq_plan(EIG_N, B.dtype)['home']}) vs plain ({K}, {EIG_N}) "
           f"complex64: residual kernel {k2['resid']:.3e}, plain "
           f"{k2['plain_resid']:.3e}; backward error kernel {k2['berr']:.3e}, plain "
           f"{k2['plain_berr']:.3e} (bar {k2['bar']:g}); max|Δ| "
           f"{k2['max_abs_err']:.3e} ({k2['rel_err']:.3e} of max|w|)")
    # the other block sizes of the RQ kernel, held the same way
    other_threads = sorted(t for (d, t) in hess_solve.RQ_ROWS
                           if d == B.dtype and t != hess_solve.RQ_THREADS)
    for T in other_threads:
        r = check_k2(lambda H_, s_, B_: hess_solve.hess_solve(H_, s_, B_, threads=T),
                     hess_solve.hess_solve_rq_plain, H, shifts, B,
                     f"K2 {T} threads ({K}, {EIG_N}) complex64")
        say(5, f"K2 (RQ kernel, {T} threads) vs plain ({K}, {EIG_N}) complex64: "
               f"residual kernel {r['resid']:.3e}, backward error {r['berr']:.3e} "
               f"(bar {r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
        del r
    # K2's QR kernel, and P1 and P2 (its function with a blocked back
    # substitution), on the same inputs and held to the same bars (the JAX
    # package's A/B probes, benchmarks/hess_v2_probe.py and hess_v3_probe.py,
    # run P1 and P2 so)
    variants = {"QR": (hess_solve.hess_solve_qr, hess_solve.hess_solve_plain),
                "P1": (hess_solve.hess_solve_v2, hess_solve.hess_solve_v2_plain),
                "P2": (hess_solve.hess_solve_v3, hess_solve.hess_solve_v3_plain)}
    pv = {}
    for name, (solve, plain) in variants.items():
        pv[name] = check_k2(solve, plain, H, shifts, B,
                            f"{name} ({K}, {EIG_N}) complex64")
        r = pv[name]
        say(5, f"{name} vs plain ({K}, {EIG_N}) complex64: residual kernel "
               f"{r['resid']:.3e}, plain {r['plain_resid']:.3e}; backward error "
               f"kernel {r['berr']:.3e}, plain {r['plain_berr']:.3e} (bar "
               f"{r['bar']:g}); max|Δ| {r['max_abs_err']:.3e} "
               f"({r['rel_err']:.3e} of max|w|)")
    # edge shapes (each state home of the RQ kernel: registers; rows past
    # the register fit in shared memory at (2, 6000) complex64 and (2, 3000)
    # complex128)
    for (k, n, dtype) in ((1, 1, torch.complex64), (7, 129, torch.complex64),
                          (3, 1000, torch.complex64), (4, 512, torch.complex128),
                          (2, 6000, torch.complex64), (2, 3000, torch.complex128)):
        rdt = dtype.to_real()
        An = torch.complex(torch.randn(n, n, generator=gen, dtype=rdt, device=dev),
                           torch.randn(n, n, generator=gen, dtype=rdt, device=dev)
                           ) / math.sqrt(2 * n)
        Hn = hessenberg.reduce_hessenberg_auto(An).h
        sn = torch.complex(torch.randn(k, generator=gen, dtype=rdt, device=dev),
                           torch.randn(k, generator=gen, dtype=rdt, device=dev)) * 0.3
        Bn = torch.complex(torch.randn(k, n, generator=gen, dtype=rdt, device=dev),
                           torch.randn(k, n, generator=gen, dtype=rdt, device=dev))
        r = check_k2(hess_solve.hess_solve, hess_solve.hess_solve_rq_plain, Hn, sn,
                     Bn, f"K2 ({k}, {n}) {dtype}")
        say(5, f"K2 vs plain ({k}, {n}) {str(dtype)[6:]}, state "
               f"{hess_solve.rq_plan(n, dtype)['home']}: residual kernel "
               f"{r['resid']:.3e}, plain {r['plain_resid']:.3e} (bar "
               f"{r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
        for name, (solve, plain) in variants.items():
            r = check_k2(solve, plain, Hn, sn, Bn, f"{name} ({k}, {n}) {dtype}")
            say(5, f"{name} vs plain ({k}, {n}) {str(dtype)[6:]}: residual kernel "
                   f"{r['resid']:.3e}, plain {r['plain_resid']:.3e} (bar "
                   f"{r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
        del An, Hn, Bn
    # rows past the shared-memory fit: the RQ kernel's state and the QR
    # kernel's carried row in a global scratch, N = 10241 in complex128 (and
    # the RQ kernel's at K2_GLOBAL_ROW_N_C64 in complex64), on 3I plus a
    # random Hessenberg part of Frobenius norm ≈ 0.7 (well conditioned
    # without a reduction)
    for n, dtype, solvers in (
            (K2_GLOBAL_ROW_N, torch.complex128,
             (("K2", hess_solve.hess_solve, hess_solve.hess_solve_rq_plain),
              ("QR", hess_solve.hess_solve_qr, hess_solve.hess_solve_plain))),
            (K2_GLOBAL_ROW_N_C64, torch.complex64,
             (("K2", hess_solve.hess_solve, hess_solve.hess_solve_rq_plain),))):
        Hg = torch.triu(torch.randn(n, n, generator=gen, dtype=dtype,
                                    device=dev), diagonal=-1) / n \
            + 3.0 * torch.eye(n, dtype=dtype, device=dev)
        sg = torch.full((1,), 0.5 + 0.5j, dtype=dtype, device=dev)
        Bg = torch.randn(1, n, generator=gen, dtype=dtype, device=dev)
        for name, solve, plain in solvers:
            r = check_k2(solve, plain, Hg, sg, Bg, f"{name} (1, {n}) {dtype}")
            where = (f"state {hess_solve.rq_plan(n, dtype)['home']}" if name == "K2"
                     else "carried row in global memory")
            say(5, f"{name} vs plain (1, {n}) {str(dtype)[6:]}, {where}: residual "
                   f"kernel {r['resid']:.3e}, plain {r['plain_resid']:.3e} (bar "
                   f"{r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
        del Hg, Bg, r
        torch.cuda.empty_cache()
    Hz = torch.zeros(5, 5, dtype=torch.complex64, device=dev)
    Hz[0, 1] = 1.0
    for name, solve in (("K2", hess_solve.hess_solve),
                        *((name, solve) for name, (solve, _) in variants.items())):
        Wz = solve(Hz, torch.zeros(2, dtype=torch.complex64, device=dev),
                   torch.ones(2, 5, dtype=torch.complex64, device=dev))
        if bool(torch.isfinite(torch.view_as_real(Wz)).all(dim=-1).all(dim=-1).any()):
            raise AssertionError(f"{name}: an exact-zero pivot gave a finite row")
    say(5, "K2, QR, P1, P2 zero-pivot contract: every row of a singular shifted "
           "H non-finite")
    # P1's and P2's carried row in global memory (past their 128 KB budget),
    # drawn from a generator of its own so that the later phases' draws stay
    # those of earlier slices
    gen_pv = torch.Generator(device=dev)
    gen_pv.manual_seed(SEED + 1)
    n = BLOCKED_GLOBAL_ROW_N
    Hg = torch.triu(torch.randn(n, n, generator=gen_pv, dtype=torch.complex128,
                                device=dev), diagonal=-1) / n \
        + 3.0 * torch.eye(n, dtype=torch.complex128, device=dev)
    sg = torch.full((1,), 0.5 + 0.5j, dtype=torch.complex128, device=dev)
    Bg = torch.randn(1, n, generator=gen_pv, dtype=torch.complex128, device=dev)
    for name in ("P1", "P2"):
        solve, plain = variants[name]
        r = check_k2(solve, plain, Hg, sg, Bg, f"{name} (1, {n}) complex128")
        say(5, f"{name} vs plain (1, {n}) complex128, carried row in global "
               f"memory: residual kernel {r['resid']:.3e}, plain "
               f"{r['plain_resid']:.3e} (bar {r['bar']:g}); max|Δ| "
               f"{r['max_abs_err']:.3e}")
    del Hg, Bg, r
    torch.cuda.empty_cache()
    # times at the eig slice shape: the RQ kernel at each block size, the
    # latency floor of its step, the plain version and the library call;
    # then K2's QR kernel, P1 and P2 beside it (the A/B of the JAX probes,
    # with the v1-vs-vX difference against the QR kernel), their launches
    # counted from here
    k2_ms = time_ms(lambda: hess_solve.hess_solve(H, shifts, B), reps=10)
    by_threads = {T: time_ms(lambda: hess_solve.hess_solve(H, shifts, B, threads=T),
                             reps=10) for T in other_threads}
    by_threads[hess_solve.RQ_THREADS] = k2_ms
    # the latency floor of a step: the kernel that runs only a step's chain
    # (slot read, the owner's row and pivot, slot write, one barrier), in K
    # blocks of the RQ kernel's size
    lib = build.library()
    floor_iters = 20000
    floor_out = torch.empty(K, dtype=torch.float64, device=dev)

    def floor_steps():
        err = lib.maus_hess_rq_step_floor(
            0, hess_solve.RQ_THREADS, K, floor_iters,
            ctypes.c_void_p(floor_out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"step-floor kernel launch failed: CUDA error {err}")

    floor_us = time_ms(floor_steps, reps=5) * 1e3 / floor_iters
    k2_plain_ms = time_ms(lambda: hess_solve.hess_solve_rq_plain(H, shifts, B),
                          reps=2)
    Hd = H[None] + torch.diag_embed(shifts[:, None].expand(K, EIG_N))
    k2_lib_ms = time_ms(lambda: torch.linalg.solve(Hd, B[..., None]), reps=3)
    del Hd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hess_solve.hess_solve(H, shifts, B)
    torch.cuda.synchronize()
    k2_extra = torch.cuda.max_memory_allocated() - base
    # the function's least work: read H's upper Hessenberg part, shifts and
    # B once, write W once; ~14·N² flops per candidate (10·N² in the sweep,
    # 4·N² in the back substitution)
    k2_bytes = (EIG_N * (EIG_N + 1) // 2 + EIG_N - 1 + K + 2 * K * EIG_N) * 8
    k2_flops = 14 * K * EIG_N ** 2
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops, FP32_FLOPS)
    k2_bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    floor_ms = floor_us * (EIG_N - 1) / 1e3
    say(5, f"K2 (RQ kernel) at ({K}, {EIG_N}) complex64: kernel {k2_ms:.4f} ms "
           f"({1e3 * k2_ms / (EIG_N - 1):.4f} µs a step), by block size "
           f"{ {T: round(t, 4) for T, t in sorted(by_threads.items())} } ms; "
           f"latency floor {floor_us:.4f} µs a step ({K} blocks of "
           f"{hess_solve.RQ_THREADS} threads; {floor_ms:.4f} ms for {EIG_N - 1} "
           f"steps, {100 * floor_ms / k2_ms:.1f}% of the kernel's time); plain "
           f"{k2_plain_ms:.1f} ms, torch.linalg.solve (dense batched LU) "
           f"{k2_lib_ms:.1f} ms; bound {k2_bound:.4f} ms ({k2_by}; bytes alone "
           f"{k2_bytes_ms:.4f} ms); the call's extra device memory "
           f"{k2_extra / 2**20:.1f} MiB")
    hess_solve.LAUNCHES_QR = 0
    hess_solve.LAUNCHES_V2 = hess_solve.LAUNCHES_V3 = 0
    W1 = pv["QR"]["W"]
    for name, (solve, plain) in variants.items():
        r = pv[name]
        Wv = solve(H, shifts, B)
        if name != "QR":
            r["v1_rel_diff"] = float((W1 - Wv).abs().max()) / max(
                float(W1.abs().max()), 1e-30)
        del Wv
        r["ms"] = time_ms(lambda: solve(H, shifts, B), reps=10)
        r["plain_ms"] = time_ms(lambda: plain(H, shifts, B), reps=2)
    pv["QR"]["launches"] = hess_solve.LAUNCHES_QR
    pv["P1"]["launches"] = hess_solve.LAUNCHES_V2
    pv["P2"]["launches"] = hess_solve.LAUNCHES_V3
    k2_again_ms = time_ms(lambda: hess_solve.hess_solve(H, shifts, B), reps=10)
    k2_vs_qr = float((W1 - k2["W"]).abs().max()) / float(W1.abs().max())
    for name, r in pv.items():
        say(5, f"{name} at ({K}, {EIG_N}) complex64: kernel {r['ms']:.3f} ms "
               f"({r['ms'] / k2_ms:.2f}× the RQ kernel's {k2_ms:.4f} ms; RQ again "
               f"after all three: {k2_again_ms:.4f} ms), plain {r['plain_ms']:.1f} "
               f"ms, torch.linalg.solve {k2_lib_ms:.1f} ms, bound {k2_bound:.4f} ms "
               f"({k2_by}, the work of K2); "
               + (f"QR-vs-{name} rel diff {r['v1_rel_diff']:.3e}; "
                  if "v1_rel_diff" in r else "")
               + f"launches {r['launches']}")
    say(5, f"RQ-vs-QR rel diff at ({K}, {EIG_N}) complex64: {k2_vs_qr:.3e} of "
           f"max|w| (two complex64 orders of the same solve; both within the bars "
           f"above)")
    for r in (k2, *pv.values()):
        r.pop("W", None)
    del H, B, W1
    torch.cuda.empty_cache()
    # the future 16384² eig's shape: one call of each design at (32, 16384)
    # complex64 (H = 3I plus a random Hessenberg part; the RQ kernel's rows
    # past 4096 in shared memory), its time and the device memory the call
    # adds; the RQ kernel also held to its plain version
    n = LARGE_N
    gen16 = torch.Generator(device=dev)
    gen16.manual_seed(SEED + 2)
    Hb = torch.triu(cnormal(gen16, (n, n), torch.complex64, dev), diagonal=-1) / n \
        + 3.0 * torch.eye(n, dtype=torch.complex64, device=dev)
    Bb = cnormal(gen16, (K, n), torch.complex64, dev)
    big = check_k2(hess_solve.hess_solve, hess_solve.hess_solve_rq_plain, Hb,
                   shifts, Bb, f"K2 ({K}, {n}) complex64")
    del big["W"]
    k2_large = {}
    for name, solve in (("K2", hess_solve.hess_solve),
                        *((name, solve) for name, (solve, _) in variants.items())):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        solve(Hb, shifts, Bb)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        k2_large[name] = (time_ms(lambda: solve(Hb, shifts, Bb), reps=2), extra)
    say(5, f"({K}, {n}) complex64, one design at a time: "
           + "; ".join(f"{name} {ms:.3f} ms, the call's extra device memory "
                       f"{extra / 2**30:.3f} GiB" for name, (ms, extra)
                       in k2_large.items())
           + f"; K2 (state {hess_solve.rq_plan(n, torch.complex64)['home']}) vs "
             f"plain: residual {big['resid']:.3e}, plain {big['plain_resid']:.3e}, "
             f"backward error {big['berr']:.3e} (bar {big['bar']:g})")
    del Hb, Bb
    torch.cuda.empty_cache()

    # ---- phase 6: maus_tpu_torch.eig on the card ---------------------------
    A = eig_operand(EIG_N, SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = eig_and_check(maus_tpu_torch, hess_solve, A, "4096² eig")
    eig_counts = counts()
    check_k3_counts(eig_counts, EIG_N, f"{EIG_N}² eig")
    eig_launches = eig_counts["K2"]
    say(6, f"launches on the eig path: {eig_counts}")
    if eig_counts["P4_blocked"] <= 0 or eig_counts["P3_cluster"] <= 0:
        raise AssertionError(f"the eig finisher ran the blocked LU (P4) "
                             f"{eig_counts['P4_blocked']} and the cluster panel "
                             f"{eig_counts['P3_cluster']} times")
    if not (eig_counts["K2"] > 0 and eig_counts["K2_QR"] == 0 and
            eig_counts["P1"] == 0 and eig_counts["P2"] == 0):
        raise AssertionError(f"the eig's shifted solves went through the RQ "
                             f"kernel {eig_counts['K2']} times and the QR kernel, "
                             f"P1, P2 {eig_counts['K2_QR']}, {eig_counts['P1']}, "
                             f"{eig_counts['P2']} times")
    eig_peak = torch.cuda.max_memory_allocated()
    say(6, f"first eig {EIG_N}²: {first}; peak device memory "
           f"{eig_peak / 2**30:.2f} GiB")
    warm = eig_and_check(maus_tpu_torch, hess_solve, A, "4096² eig")
    say(6, f"{EIG_N}² general eig: {warm['num_distinct']} distinct pairs "
           f"(target {EIG_TARGETS}) in {warm['iterations']} iterations, K2 "
           f"launches {warm['launches']}; best {EIG_TARGETS} at ≤ "
           f"{warm['worst_of_best']:.3e} (independent complex128), reported ≤ "
           f"{warm['worst_reported']:.3e}; Hessenberg reduction "
           f"{warm['setup_s']:.3f} s, engine {warm['engine_s']:.3f} s, "
           f"finisher {warm['finish_s']:.3f} s (PR 2, torch.linalg.lu_factor: "
           f"{PR2_FINISH_S[0]:.3f}-{PR2_FINISH_S[1]:.3f} s); warm wall "
           f"{warm['wall_s']:.3f} s (one run after one first run); with the QR "
           f"kernel: {QR_EIG[0]} iterations, {QR_EIG[1]} distinct; peak device "
           f"memory {eig_peak / 2**30:.2f} GiB")
    torch.cuda.empty_cache()

    del A

    # ---- phase 7: K3 against its plain version -----------------------------
    # complex64 runs on the tensor cores (split TF32), complex128 on PR 3's
    # CUDA-core body; that body's complex64 form (cgemm_simt) is the A/B
    for (m, k, n, dtype) in ((1, 1, 1, torch.complex64), (100, 130, 50, torch.complex64),
                             (8, 128, 128, torch.complex64),
                             (65, 17, 129, torch.complex64),
                             (1000, 777, 513, torch.complex128)):
        a = cnormal(gen, (m, k), dtype, dev)
        b = cnormal(gen, (k, n), dtype, dev)
        err, bar = check_cgemm(cgemm.cgemm, cgemm, a, b, f"({m}, {k}, {n})")
        line = (f"K3 vs plain (M, K, N) = ({m}, {k}, {n}) {str(dtype)[6:]}: "
                f"max|Δ| {err:.3e} <= {bar:.3e}")
        if dtype == torch.complex64:
            s_err, _ = check_cgemm(cgemm.cgemm_simt, cgemm, a, b, f"SIMT ({m}, {k}, {n})")
            line += f" (err/bar {err / bar:.3f}; PR 3's body {s_err:.3e})"
        say(7, line)
    for width in (16, 8):
        attrs = (ctypes.c_int * 4)()
        err = build.library().maus_cgemm_tc_attrs(width, attrs)
        if err != 0:
            raise RuntimeError(f"maus_cgemm_tc_attrs: CUDA error {err}")
        say(7, f"K3 (64×64 tiles), {width}-byte copies: {attrs[0]} registers, "
               f"{attrs[1]} bytes local (spilled), {attrs[2]} CTAs a SM, "
               f"{attrs[3]} bytes of shared memory")
    n = HEADLINE_N
    a = cnormal(gen, (n, n), torch.complex64, dev)
    b = cnormal(gen, (n, n), torch.complex64, dev)
    err, bar = check_cgemm(cgemm.cgemm, cgemm, a, b, f"{n}³")
    s_err, _ = check_cgemm(cgemm.cgemm_simt, cgemm, a, b, f"SIMT {n}³")
    # the accumulation's error, against a complex128 product
    exact = a.to(torch.complex128) @ b.to(torch.complex128)
    vs_exact = {name: float((fn(a, b) - exact).abs().max()) / bar for name, fn in (
        ("K3", cgemm.cgemm), ("PR 3's body", cgemm.cgemm_simt),
        ("torch.matmul", lambda x, y: x @ y))}
    del exact
    out = torch.empty_like(a)
    turns = {"K3": [], "SIMT": [], "matmul": []}
    for _ in range(2):      # in turns, on the same inputs
        turns["K3"].append(time_ms(lambda: cgemm.cgemm_update(out, a, b), reps=10))
        turns["SIMT"].append(time_ms(lambda: cgemm.cgemm_update_simt(out, a, b), reps=10))
        turns["matmul"].append(time_ms(lambda: a @ b, reps=10))
    g_plain = time_ms(lambda: cgemm.cgemm_plain(a, b), reps=5)
    g_bytes = 3 * n * n * 8
    g_fma, _ = bound_ms(g_bytes, 8 * n ** 3, FP32_FLOPS)
    g_tc, g_by = bound_ms(g_bytes, 24 * n ** 3, TF32_FLOPS)
    g_ms = min(turns["K3"])
    say(7, f"K3 {n}³ complex64: max|Δ| {err:.3e} <= {bar:.3e} (PR 3's body "
           f"{s_err:.3e}); in turns, K3 {[round(t, 3) for t in turns['K3']]} ms "
           f"({8 * n ** 3 / g_ms / 1e9:.1f} TFLOP/s of complex products, "
           f"{24 * n ** 3 / g_ms / 1e9:.1f} TFLOP/s on the tensor cores), PR 3's "
           f"body {[round(t, 3) for t in turns['SIMT']]} ms, torch.matmul "
           f"{[round(t, 3) for t in turns['matmul']]} ms; plain {g_plain:.3f} ms; "
           f"max|Δ| against complex128 over the bar "
           f"{ {k: round(v, 4) for k, v in vs_exact.items()} }; bound split-TF32 {g_tc:.3f} ms ({g_by}), "
           f"FP32-FMA {g_fma:.3f} ms")
    if not max(turns["K3"]) < min(turns["SIMT"]):
        raise AssertionError(f"K3 at {n}³ is not faster than PR 3's body: {turns}")
    if not max(turns["K3"]) <= min(turns["matmul"]):
        say(7, f"K3 at {n}³ is slower than torch.matmul in a turn: {turns}")
    del a, b, out
    # the blocked LU's first trailing update at (8, 2048) and (8, 4096), and
    # two of its last ones, M = 64 and 192 (as in every LU of the finishers):
    # C = X[:, e:, e:], A = X[:, e:, s:e], B = X[:, s:e, e:] in one buffer,
    # α = −1, β = 1
    eps32 = torch.finfo(torch.float32).eps
    update_rows = {}
    for n in (SVD_N, EIG_N, 2 * lu.NB, 4 * lu.NB):
        K, e = LU_BATCH, lu.NB
        which = "first" if n in (SVD_N, EIG_N) else "last"
        X = cnormal(gen, (K, n, n), torch.complex64, dev)
        Xp = X.clone()
        cgemm.cgemm_update_plain(Xp[:, e:, e:], Xp[:, e:, :e], Xp[:, :e, e:], -1.0, 1.0)
        amax = float(X.abs().max())
        u_bar = 4 * e * eps32 * amax ** 2 + 2 * eps32 * amax
        errs = {}
        for name, fn in (("K3", cgemm.cgemm_update), ("SIMT", cgemm.cgemm_update_simt)):
            Xk = X.clone()
            fn(Xk[:, e:, e:], Xk[:, e:, :e], Xk[:, :e, e:], -1.0, 1.0)
            torch.cuda.synchronize()
            errs[name] = float((Xk - Xp).abs().max())
            if not errs[name] <= u_bar:
                raise AssertionError(f"{name} trailing update at ({K}, {n}): max|Δ| "
                                     f"{errs[name]:.3e} > {u_bar:.3e}")
            del Xk
        del Xp
        C_, A_, B_ = X[:, e:, e:], X[:, e:, :e], X[:, :e, e:]
        turns = {"K3": [], "SIMT": [], "baddbmm": []}
        for _ in range(2):
            turns["K3"].append(time_ms(
                lambda: cgemm.cgemm_update(C_, A_, B_, -1.0, 1.0)))
            turns["SIMT"].append(time_ms(
                lambda: cgemm.cgemm_update_simt(C_, A_, B_, -1.0, 1.0)))
            turns["baddbmm"].append(time_ms(
                lambda: torch.baddbmm(C_, A_, B_, beta=1, alpha=-1)))
        u_plain = time_ms(lambda: cgemm.cgemm_update_plain(C_, A_, B_, -1.0, 1.0))
        m_ = n - e
        u_bytes = (K * (2 * m_ * e) + 2 * K * m_ * m_) * 8
        u_fma, u_fma_by = bound_ms(u_bytes, 8 * K * m_ * m_ * e, FP32_FLOPS)
        u_tc, u_by = bound_ms(u_bytes, 24 * K * m_ * m_ * e, TF32_FLOPS)
        update_rows[n] = dict(err=errs["K3"], simt_err=errs["SIMT"],
                              ms=min(turns["K3"]), simt_ms=min(turns["SIMT"]),
                              library_ms=min(turns["baddbmm"]), plain_ms=u_plain,
                              bound_ms=u_tc, bound_by=u_by)
        say(7, f"K3 {which} trailing update of the LU, (batch, M, N, K) = "
               f"({K}, {m_}, {m_}, {e}): max|Δ| {errs['K3']:.3e} <= {u_bar:.3e} "
               f"(PR 3's body {errs['SIMT']:.3e}); in turns, K3 "
               f"{[round(t, 4) for t in turns['K3']]} ms, PR 3's body "
               f"{[round(t, 4) for t in turns['SIMT']]} ms, torch.baddbmm "
               f"{[round(t, 4) for t in turns['baddbmm']]} ms; plain {u_plain:.4f} ms; bound split-TF32 {u_tc:.4f} ms ({u_by}), "
               f"FP32-FMA {u_fma:.4f} ms ({u_fma_by})")
        if which == "last":
            if not max(turns["K3"]) <= min(turns["baddbmm"]):
                say(7, f"K3's update at ({K}, {m_}, {m_}, {e}) is slower than "
                       f"torch.baddbmm in a turn: {turns}")
        elif not max(turns["K3"]) < min(min(turns["SIMT"]), min(turns["baddbmm"])):
            raise AssertionError(f"K3's update at ({K}, {n}) is not faster than PR 3's "
                                 f"body and torch.baddbmm: {turns}")
        del X, C_, A_, B_
        torch.cuda.empty_cache()

    # ---- phase 8: P3/P4 against the plain version --------------------------
    lu_rows = {}
    # shifted Gram systems of the SVD operand, as the SVD finisher builds
    # them: G = AᴴA in complex64 − σ_k² + ψ for the top LU_BATCH σ
    A_svd, sig = svd_operand(SVD_M, SVD_N, SVD_TOP, SEED, dev)
    Ac = A_svd.to(torch.complex64)
    G = Ac.mH @ Ac
    del Ac
    psi = 3e-6 * float(torch.linalg.vector_norm(A_svd)) / math.sqrt(SVD_N)
    Hg = G.expand(LU_BATCH, SVD_N, SVD_N).clone()
    Hg.diagonal(dim1=-2, dim2=-1).add_(
        (-(sig[:LU_BATCH] ** 2) + psi).to(torch.complex64)[:, None])
    del G
    # shifted eig matrices of the eig operand: A − λ_k I, λ_k drawn as the
    # engine draws its shifts (centroid 0, RMS spread 1)
    A_e = eig_operand(EIG_N, SEED, dev)
    lam = cnormal(gen, (LU_BATCH,), torch.complex64, dev) / math.sqrt(2.0)
    He = A_e.expand(LU_BATCH, EIG_N, EIG_N).clone()
    He.diagonal(dim1=-2, dim2=-1).sub_(lam[:, None])
    del A_e
    # the cluster panel kernel's configuration at the finishers' panels: the
    # card's cudaOccupancyMaxActiveClusters for every cluster size whose
    # slice fits a CTA, and the size lu.choose_panel_kernel takes
    def active(C, rows, width):
        return lu.cluster_occupancy(C, rows, width, torch.complex64, dev)

    chosen = {}
    for N in (SVD_N, EIG_N):
        occ = {C: active(C, -(-N // C), lu.NB) for C in lu.CLUSTER_SIZES
               if lu.cluster_smem_bytes(-(-N // C), lu.NB, 8) <= lu.SMEM_LIMIT}
        chosen[N] = lu.choose_panel_kernel(LU_BATCH, N, lu.NB, 8, active)
        say(8, f"cluster panel at ({LU_BATCH}, {N}) complex64, 64 columns: "
               f"cudaOccupancyMaxActiveClusters by cluster size {occ}; chosen "
               f"C = {chosen[N]} ({-(-N // chosen[N])} rows a CTA)")
    # one cluster barrier, timed alone at the chosen size: the floor of a
    # column step of the cluster panel
    lib = build.library()
    iters = 10000

    def barriers():
        err = lib.maus_lu_cluster_barrier(
            chosen[EIG_N], LU_BATCH, iters,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"cluster barrier launch failed: CUDA error {err}")

    barrier_us = time_ms(barriers, reps=5) * 1e3 / iters
    say(8, f"one cluster barrier ({LU_BATCH} clusters of {chosen[EIG_N]} CTAs of "
           f"512 threads): {barrier_us:.4f} µs; a 64-column panel's latency "
           f"floor (64 dependent steps) {64 * barrier_us:.2f} µs")
    for label, H in ((f"({LU_BATCH}, {SVD_N}) shifted Gram", Hg),
                     (f"({LU_BATCH}, {EIG_N}) shifted eig", He)):
        r = check_lu(lu, H, gen, label)
        N = H.shape[-1]
        # kernel and library in turns, on the same inputs
        t_k = time_ms(lambda: lu.lu_factor(H), reps=3)
        t_l = time_ms(lambda: torch.linalg.lu_factor(H), reps=2)
        t_k2 = time_ms(lambda: lu.lu_factor(H), reps=3)
        t_l2 = time_ms(lambda: torch.linalg.lu_factor(H), reps=2)
        t_p = time_ms(lambda: lu.lu_factor_plain(H), reps=2 if N < 4096 else 1)
        # 8/3·K·N³ real flops, nearly all in K3's split-TF32 products (three
        # tensor flops each)
        bnd, by = bound_ms(2 * LU_BATCH * N * N * 8, 8 * LU_BATCH * N ** 3, TF32_FLOPS)
        lu_rows[N] = dict(r, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bnd,
                          bound_by=by)
        say(8, f"P4 vs plain {label} complex64: backward error kernel "
               f"{r['berr']:.3e}, plain {r['plain_berr']:.3e}, lu_solve "
               f"{r['solve_berr']:.3e} (bar {r['bar']:.3e}); pivots differing "
               f"{r['piv_mismatch']} (first differing column per matrix "
               f"{r['first_mismatch']}); max|Δ| {r['max_abs_err']:.3e}; kernel "
               f"{t_k:.3f} ms (again {t_k2:.3f} ms; PR 5, K3 on the CUDA cores: "
               f"{PR5_P4_MS[N]} ms), torch.linalg.lu_factor "
               f"{t_l:.3f} ms (again {t_l2:.3f} ms), plain {t_p:.1f} ms, bound "
               f"{bnd:.3f} ms ({by})")
        if not max(t_k, t_k2) < min(t_l, t_l2):
            say(8, f"P4 at {label} does not beat torch.linalg.lu_factor")
        say(8, f"P4 {label}: device time by kernel in one factorization "
               f"(torch.profiler): {p4_breakdown(lu, H)}")
    # the panel kernels on the first 64 columns of both batches, the largest
    # panels the finishers factor; repeated in place for the timing (each
    # call factors the same N × 64 block once more)
    w = lu.NB
    panel_rows = {}
    for N, H in ((SVD_N, Hg), (EIG_N, He)):
        pp = H.clone()
        piv_p = torch.zeros((LU_BATCH, N), dtype=torch.int32, device=dev)
        lu.lu_panel_plain(pp, piv_p, 0, w)
        panel_out = {}
        for name, cl in (("cluster", None), ("one-block", 0)):
            pk = H.clone()
            piv_k = torch.zeros_like(piv_p)
            launches0 = lu.CLUSTER_PANEL_LAUNCHES, lu.PANEL_LAUNCHES
            lu.lu_panel(pk, piv_k, 0, w, cluster=cl)
            torch.cuda.synchronize()
            took = (lu.CLUSTER_PANEL_LAUNCHES - launches0[0],
                    lu.PANEL_LAUNCHES - launches0[1])
            if took != ((1, 0) if cl is None else (0, 1)):
                raise AssertionError(f"P3 panel [0, {w}) of ({LU_BATCH}, {N}) took "
                                     f"(cluster, one-block) launches {took}")
            p_err = float((pk - pp).abs().max())
            p_mism = int((piv_k != piv_p).sum())
            if not (p_err <= 1e-4 * float(H.abs().max()) and p_mism == 0):
                raise AssertionError(f"P3 {name} panel [0, {w}) of ({LU_BATCH}, {N}): "
                                     f"max|Δ| {p_err:.3e}, pivots differing {p_mism}")
            panel_out[name] = (pk, piv_k, cl, p_err)
        del pp
        panel = H[:, :, :w].contiguous()
        turns = {"cluster": [], "one-block": [], "library": []}
        for _ in range(2):
            for name in ("cluster", "one-block"):
                pk, piv_k, cl, _ = panel_out[name]
                turns[name].append(time_ms(
                    lambda: lu.lu_panel(pk, piv_k, 0, w, cluster=cl), reps=5))
            turns["library"].append(time_ms(lambda: torch.linalg.lu_factor(panel),
                                            reps=5))
        pk, piv_k, _, p_err = panel_out["cluster"]
        p_plain = time_ms(lambda: lu.lu_panel_plain(pk, piv_k, 0, w), reps=2)
        by_size = {C: time_ms(lambda: lu.lu_panel(pk, piv_k, 0, w, cluster=C), reps=5)
                   for C in lu.CLUSTER_SIZES
                   if lu.cluster_smem_bytes(-(-N // C), w, 8) <= lu.SMEM_LIMIT}
        p_flops = LU_BATCH * sum((N - k - 1) * (8 + 8 * (w - k - 1)) for k in range(w))
        p_bound, p_by = bound_ms(2 * LU_BATCH * N * w * 8, p_flops, FP32_FLOPS)
        panel_rows[N] = dict(ms=turns["cluster"][0], block_ms=turns["one-block"][0],
                             library_ms=turns["library"][0], plain_ms=p_plain,
                             bound_ms=p_bound, bound_by=p_by, max_abs_err=p_err)
        say(8, f"P3 panel [0, {w}) of ({LU_BATCH}, {N}) complex64: max|Δ| cluster "
               f"{p_err:.3e}, one-block {panel_out['one-block'][3]:.3e}, pivots "
               f"differing 0; in turns, cluster kernel (C = {chosen[N]}) "
               f"{[round(t, 4) for t in turns['cluster']]} ms, one-block kernel "
               f"{[round(t, 4) for t in turns['one-block']]} ms, "
               f"torch.linalg.lu_factor of the {N}×{w} panels "
               f"{[round(t, 4) for t in turns['library']]} ms; plain {p_plain:.1f} ms; "
               f"bound {p_bound:.4f} ms ({p_by}), latency floor "
               f"{64 * barrier_us / 1e3:.4f} ms (64 barriers); cluster kernel by "
               f"cluster size { {C: round(t, 4) for C, t in by_size.items()} } ms")
        if not (max(turns["cluster"]) < min(turns["library"]) and
                5 * max(turns["cluster"]) <= min(turns["one-block"])):
            say(8, f"the cluster panel at ({LU_BATCH}, {N}) is not both faster than "
                   f"torch.linalg.lu_factor and 5× faster than the one-block kernel")
        del pk, panel, panel_out
    del Hg, He
    torch.cuda.empty_cache()
    # P3's own measured range: the whole unblocked LU (one panel over all N)
    K, N = 16, 256
    H = cnormal(gen, (K, N, N), torch.complex64, dev)
    a, b = H.clone(), H.clone()
    pa = torch.zeros((K, N), dtype=torch.int32, device=dev)
    pb = pa.clone()
    lu.lu_panel(a, pa, 0, N)
    lu.lu_panel_plain(b, pb, 0, N)
    torch.cuda.synchronize()
    p3_berr = lu_backward_error(H, a, pa)
    p3_bar = 10 * math.sqrt(N) * eps32
    if not (p3_berr <= p3_bar and int((pa != pb).sum()) == 0):
        raise AssertionError(f"P3 unblocked ({K}, {N}): backward error "
                             f"{p3_berr:.3e} > {p3_bar:.3e} or pivots differ")

    def unblocked():
        w_ = H.clone()
        lu.lu_panel(w_, pa, 0, N)

    def unblocked_plain():
        w_ = H.clone()
        lu.lu_panel_plain(w_, pb, 0, N)

    say(8, f"P3 unblocked ({K}, {N}) complex64 (one panel over all columns): "
           f"backward error {p3_berr:.3e} (bar {p3_bar:.3e}), max|Δ| vs plain "
           f"{float((a - b).abs().max()):.3e}; kernel {time_ms(unblocked):.3f} ms, "
           f"plain {time_ms(unblocked_plain, reps=2):.1f} ms, blocked P4 "
           f"{time_ms(lambda: lu.lu_factor(H)):.3f} ms, torch.linalg.lu_factor "
           f"{time_ms(lambda: torch.linalg.lu_factor(H)):.3f} ms")
    del H, a, b
    for (K, N, dtype) in ((1, 1, torch.complex64), (5, 129, torch.complex64),
                          (3, 1000, torch.complex64), (2, 2047, torch.complex64),
                          (2, 512, torch.complex128)):
        H = cnormal(gen, (K, N, N), dtype, dev)
        r = check_lu(lu, H, gen, f"({K}, {N}) {dtype}")
        say(8, f"P4 vs plain ({K}, {N}) {str(dtype)[6:]}: backward error kernel "
               f"{r['berr']:.3e}, plain {r['plain_berr']:.3e}, lu_solve "
               f"{r['solve_berr']:.3e} (bar {r['bar']:.3e}); pivots differing "
               f"{r['piv_mismatch']}; max|Δ| {r['max_abs_err']:.3e}")
        del H
    Hz = torch.zeros((2, 5, 5), dtype=torch.complex64, device=dev)
    Hz[:, 0, 1] = 1.0
    lz, pz = lu.lu_factor(Hz)
    xz = torch.linalg.lu_solve(lz, pz, torch.ones((2, 5, 1), dtype=Hz.dtype, device=dev))
    if bool(torch.isfinite(torch.view_as_real(xz)).all(dim=-1).all(dim=(1, 2)).any()):
        raise AssertionError("P4: an exactly singular H gave a finite solve")
    say(8, "P4 zero-pivot contract: the solve against an exactly singular H "
           "is non-finite")
    torch.cuda.empty_cache()

    # ---- phase 9: maus_tpu_torch.svd on the card ---------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = svd_and_check(maus_tpu_torch, A_svd, sig, f"{SVD_M}×{SVD_N} svd")
    svd_counts = counts()
    check_k3_counts(svd_counts, SVD_N, f"{SVD_M}×{SVD_N} svd")
    say(9, f"launches on the SVD path: {svd_counts}")
    for name in ("P3_cluster", "P4_blocked", "K3"):
        if svd_counts[name] <= 0:
            raise AssertionError(f"the SVD path launched {name} {svd_counts[name]} "
                                 f"times")
    say(9, f"first svd {SVD_M}×{SVD_N}: {first}; peak device memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    warm = svd_and_check(maus_tpu_torch, A_svd, sig, f"{SVD_M}×{SVD_N} svd")
    say(9, f"{SVD_M}×{SVD_N} svd: {warm['num_distinct']} distinct triplets "
           f"(target {warm['target']}, converged {warm['converged']}) in "
           f"{warm['iterations']} iterations; top {SVD_TOP} σ within "
           f"{warm['sigma_rel_err']:.3e} of 0.8^k, at ≤ {warm['worst_top']:.3e} "
           f"(independent complex128), best {SVD_TOP} at ≤ {warm['worst_best']:.3e}; "
           f"construct {warm['construct_s']:.3f} s, setup {warm['setup_s']:.3f} s, "
           f"engine {warm['engine_s']:.3f} s, finisher {warm['finish_s']:.3f} s; "
           f"warm wall {warm['wall_s']:.3f} s (one run after one first run); peak "
           f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del A_svd
    torch.cuda.empty_cache()

    # ---- phase 10: Hermitian eig at 4096², the deflated-Lanczos branch ------
    A = hermitian_operand(EIG_N, SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = eig_and_check(maus_tpu_torch, hess_solve, A, f"{EIG_N}² Hermitian eig",
                          hermitian=True)
    herm_counts = counts()
    check_k3_counts(herm_counts, EIG_N, f"{EIG_N}² Hermitian eig")
    say(10, f"launches on the Hermitian (Lanczos) eig path: {herm_counts}")
    if herm_counts["P4_blocked"] <= 0 or herm_counts["lanczos_calls"] <= 0 or \
            herm_counts["P3_cluster"] <= 0:
        raise AssertionError(f"the {EIG_N}² Hermitian eig ran P4 "
                             f"{herm_counts['P4_blocked']}, the cluster panel "
                             f"{herm_counts['P3_cluster']} and Lanczos "
                             f"{herm_counts['lanczos_calls']} times")
    say(10, f"first Hermitian eig {EIG_N}²: {first}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    warm = eig_and_check(maus_tpu_torch, hess_solve, A, f"{EIG_N}² Hermitian eig",
                         hermitian=True)
    say(10, f"{EIG_N}² Hermitian eig (Lanczos): {warm['num_distinct']} distinct "
            f"pairs (target {EIG_TARGETS}) in {warm['iterations']} iterations; "
            f"best {EIG_TARGETS} at ≤ {warm['worst_of_best']:.3e} (independent "
            f"complex128), reported ≤ {warm['worst_reported']:.3e}, λ within "
            f"{warm['lam_err']:.3e} of eigvalsh; setup {warm['setup_s']:.3f} s, "
            f"engine {warm['engine_s']:.3f} s, finisher {warm['finish_s']:.3f} s; "
            f"warm wall {warm['wall_s']:.3f} s (one run after one first run); "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del A
    torch.cuda.empty_cache()

    # ---- phase 11: Hermitian eig at 2048², the shared-eigh branch -----------
    A = hermitian_operand(HERM_SMALL_N, SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    small = eig_and_check(maus_tpu_torch, hess_solve, A,
                          f"{HERM_SMALL_N}² Hermitian eig", hermitian=True)
    small_counts = counts()
    check_k3_counts(small_counts, HERM_SMALL_N, f"{HERM_SMALL_N}² Hermitian eig")
    if small_counts["lanczos_calls"] != 0 or small_counts["P4_blocked"] <= 0 or \
            small_counts["P3_cluster"] <= 0:
        raise AssertionError(f"the {HERM_SMALL_N}² Hermitian eig called Lanczos "
                             f"{small_counts['lanczos_calls']} times (the shared "
                             f"eigh takes N ≤ eigh_max_n), P4 "
                             f"{small_counts['P4_blocked']} and the cluster panel "
                             f"{small_counts['P3_cluster']} times")
    say(11, f"launches on the Hermitian (shared eigh) eig path: {small_counts}")
    say(11, f"{HERM_SMALL_N}² Hermitian eig (shared eigh): {small['num_distinct']} "
            f"distinct pairs (target {EIG_TARGETS}) in {small['iterations']} "
            f"iterations; best {EIG_TARGETS} at ≤ {small['worst_of_best']:.3e} "
            f"(independent complex128), λ within {small['lam_err']:.3e} of "
            f"eigvalsh; eigh setup {small['setup_s']:.3f} s, engine "
            f"{small['engine_s']:.3f} s, finisher {small['finish_s']:.3f} s; wall "
            f"{small['wall_s']:.3f} s (one run); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del A
    torch.cuda.empty_cache()

    # ---- phase 12: the reference's scenarios through the CLI, on the card ---
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["scenarios"])
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
    for ln in lines:
        say(12, ln)
    got = [ln.split(": ")[-1].split(" ")[0] for ln in lines]
    if rc != 0 or len(lines) != 4 or not all(ln.startswith("[PASS]") for ln in lines) \
            or got != SCENARIO_COUNTS:
        raise AssertionError(f"scenarios: exit code {rc}, counts {got} "
                             f"(want {SCENARIO_COUNTS})")
    say(12, f"scenarios: exit code 0, four passed in {wall:.2f} s")

    k3u = update_rows[SVD_N]
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
        "source": "maus_tpu_torch/csrc/hess_solve_rq.cu",
        "replaces": "maus_tpu/ops/pallas/hess_solve.py:158",
        "launches": eig_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
        "bound_by": k2_by, "library_ms": k2_lib_ms}, *[{
        "name": name, "route": "cuda", "source": f"maus_tpu_torch/csrc/{src}.cu",
        "replaces": replaces, "launches": pv[key]["launches"],
        "max_abs_err": pv[key]["max_abs_err"], "ms": pv[key]["ms"],
        "plain_ms": pv[key]["plain_ms"], "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": k2_lib_ms} for key, name, src, replaces in (
            ("QR", "hess_solve_qr", "hess_solve",
             "maus_tpu/ops/pallas/hess_solve.py:158"),
            ("P1", "hess_solve_v2", "hess_solve_v2",
             "benchmarks/hess_v2_probe.py:168"),
            ("P2", "hess_solve_v3", "hess_solve_v3",
             "benchmarks/hess_v3_probe.py:187"))], {
        "name": "cgemm", "route": "cuda", "source": "maus_tpu_torch/csrc/cgemm_tc.cu",
        "replaces": "maus_tpu/ops/pallas/cgemm.py:57",
        "launches": svd_counts["K3"], "max_abs_err": k3u["err"], "ms": k3u["ms"],
        "plain_ms": k3u["plain_ms"], "bound_ms": k3u["bound_ms"],
        "bound_by": k3u["bound_by"], "library_ms": k3u["library_ms"]}, {
        "name": "cgemm_simt", "route": "cuda", "source": "maus_tpu_torch/csrc/cgemm.cu",
        "replaces": "maus_tpu/ops/pallas/cgemm.py:57",
        "launches": svd_counts["K3_simt"], "max_abs_err": k3u["simt_err"],
        "ms": k3u["simt_ms"], "plain_ms": k3u["plain_ms"], "bound_ms": k3u["bound_ms"],
        "bound_by": k3u["bound_by"], "library_ms": k3u["library_ms"]}, {
        "name": "lu_panel", "route": "cuda", "source": "maus_tpu_torch/csrc/lu.cu",
        "replaces": "benchmarks/parked/pallas_lu.py:103",
        "launches": svd_counts["P3_cluster"],
        "max_abs_err": panel_rows[EIG_N]["max_abs_err"],
        "ms": panel_rows[EIG_N]["ms"], "plain_ms": panel_rows[EIG_N]["plain_ms"],
        "bound_ms": panel_rows[EIG_N]["bound_ms"],
        "bound_by": panel_rows[EIG_N]["bound_by"],
        "library_ms": panel_rows[EIG_N]["library_ms"]}, {
        "name": "lu_factor_blocked", "route": "cuda",
        "source": "maus_tpu_torch/csrc/lu.cu",
        "replaces": "benchmarks/parked/pallas_lu_blocked.py:169",
        "launches": svd_counts["P4_blocked"],
        "max_abs_err": lu_rows[SVD_N]["max_abs_err"], "ms": lu_rows[SVD_N]["ms"],
        "plain_ms": lu_rows[SVD_N]["plain_ms"],
        "bound_ms": lu_rows[SVD_N]["bound_ms"],
        "bound_by": lu_rows[SVD_N]["bound_by"],
        "library_ms": lu_rows[SVD_N]["library_ms"]}, {
        "name": "lu_factor_blocked_n4096", "route": "cuda",
        "source": "maus_tpu_torch/csrc/lu.cu",
        "replaces": "benchmarks/parked/pallas_lu_blocked.py:169",
        "launches": eig_counts["P4_blocked"],
        "max_abs_err": lu_rows[EIG_N]["max_abs_err"], "ms": lu_rows[EIG_N]["ms"],
        "plain_ms": lu_rows[EIG_N]["plain_ms"],
        "bound_ms": lu_rows[EIG_N]["bound_ms"],
        "bound_by": lu_rows[EIG_N]["bound_by"],
        "library_ms": lu_rows[EIG_N]["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
