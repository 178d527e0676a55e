#!/usr/bin/env python3
"""Smoke run of maus_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, that its kernels agree with their plain versions, and that
its main paths run on the card through those kernels: a dense,
ill-conditioned complex64 Ax=b at 4096², κ = 1e6, solved to 1e-8 (kernel
K1); 16 eigenpairs of a general complex64 4096² operand to 1e-8 (kernel K2, and the
blocked LU P3/P4 with the complex GEMM K3 in its finisher); 16 singular
triplets of a 4096×2048 operand to 1e-6 (P3, P4 and K3 in its finisher);
K2's RQ kernel beside its QR form and the QR form's two blocked variants P1
and P2 (beside the row-loop bodies of them), which the JAX package's probes run
as an A/B; 16 eigenpairs of a
Hermitian complex64 operand at 4096² (deflated Lanczos) and 2048² (shared
eigh), both finished through P4; the reference's four scenarios through
the CLI; checkpoint/resume and per-iteration metrics of the linear and SVD
runs; KAIROSAGE's genesis cycles with stage III on the card; the mesh
paths (solve/eig/svd(mesh=), MeshSolver, sharded checkpoints, IslandAGE
over replica ranks, the CLI's --mesh-model) on two ranks sharing the card;
and the port's measuring programs (python -m maus_tpu_torch bench and
maus_tpu_torch/benchmarks/), each in its own process.

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. the card, as nvidia-smi names it, with its power limit;
  1. build kernels K1, K2 (and its QR form), P1, P2 (and the row-loop bodies),
     K3, P3 and P4 from
     maus_tpu_torch/csrc/ (one nvcc per source, all started together);
  2. K1 (the true-FP64 residual) against its plain PyTorch version at the
     main path's shapes (the mesh paths' (N, N/2) rank shards among them)
     and a few ragged ones, within 1e-15·‖A‖_F·‖x‖, and
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
     form), P1 and P2 (the QR kernel's function with a blocked back
     substitution, redesigned: a streaming sweep and a cluster back
     substitution; P2 also divide-free, with R in column tiles) and their
     row-loop bodies (the first CUDA form) held the same way on the same inputs and shapes, P1
     and P2 also at every cluster size (one CTA where N <= 128, as
     planned; 2-8 at N = 1000), with the carried row in global
     memory (N = 16673 complex128; the row-loop bodies at N = 8193) and a zero
     pivot in a later block; the median times at the slice shape of the RQ
     kernel by block size, its step's latency floor, the plain version,
     torch.linalg.solve (dense batched LU) and the call's extra device
     memory; the A/B of the QR kernel, P1, P2 and the row-loop bodies beside it
     as the JAX probes run it, in two turns (the QR-vs-P differences, each
     kernel's and plain version's time); P1 and P2 split into their sweep
     and back substitution (the row-loop bodies: sweep-only mode, the back
     substitution by difference), the R-traffic floor, the time at K = 1,
     raising if a redesign is under 2× faster than the row-loop body; and one
     call of each design at (32, 16384), with its time, residual and the
     device memory it adds (again raising under 2×);
  6. maus_tpu_torch.eig of A = (G₁ + iG₂)/√N at 4096², complex64, 32
     candidates, 16 targets, tol 1e-8: ≥ 16 distinct pairs, the best 16 each
     at ≤ 1e-8 by an independent complex128 residual and pairwise distinct,
     every shifted solve through the RQ kernel (none through the QR kernel,
     P1, P2 or the row-loop bodies), with the launch counts of K2, P3, P4 and K3 and the peak
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
     reference's four scenarios passed at 1/1, 8/8, 8/8 and 2/2;
 13. checkpoint/resume and metrics: the linear 4096² system of phase 3 and
     the SVD of phase 9, each through MausSolver.evolve uninterrupted
     without and with collect_metrics (host syncs counted by
     torch.cuda.set_sync_debug_mode, engine seconds), cut short with
     periodic saves (linear: every iteration, cut at 2; SVD: every 25, cut
     at 50) and resumed from the file in a fresh solver: the resumed run
     and the metrics run bit-equal to the uninterrupted one (iterations,
     distinct counts, residuals, every vector), the metrics rows zero
     after the stop, at most 13 syncs added by the metrics, the resumed
     run's kernel launches (K1; P3, P4, K3), and the checkpoint's size,
     load and save seconds;
 14. KAIROSAGE: GenesisEngine(AgeConfig(candidates_per_cycle=20),
     seed=0).run(5) (BASELINE.md row 10) with stage III on the card, held
     to the same run on the CPU in this process (library sizes equal every
     cycle, best fitness within 1e-4), with wall seconds; a stage-III batch
     of 4096 random tapes (N = T = 50) held to the CPU within 1e-4, with
     simulations per second; a two-cycle IslandAGE of 4 islands; and
     python -m maus_tpu_torch age --cycles 5 --json, equal to the card's
     run;
 15. the mesh paths, two ranks sharing the card over gloo (NCCL refuses two
     ranks on one GPU), launched by maus_tpu_torch/parallel/launch.py after
     phase 1 built the kernels: solve(mesh=) of phase 3's system, certified
     ≤ 1e-8 by an independent FP64 residual, with K1 launched on each rank;
     a MeshSolver run cut at 2 iterations (saved every one) and resumed in
     a fresh solver bit-equal to solve(mesh=), then a swap of b certified
     the same way; svd(mesh=) of phase 9's operand (≥ 16 triplets, σ within
     1e-8 of 0.8^k, each ≤ 1e-6); dist_hessenberg of phase 6's operand and
     one dist_hess_solve at (32, 4096) timed alone; eig(mesh=) of it (≥ 16
     pairs, each ≤ 1e-8 by an independent complex128 residual); the
     default backend (NCCL) refusing two ranks on one card with ValueError;
     an IslandAGE of 4 islands × 2 cycles with stage III over two replica
     ranks, equal to one device; and python -m maus_tpu_torch --backend
     gloo solve --mesh-model 2 --check. On each rank K1 is held against its
     plain version on the shard, x slice and b part the certification
     passes it. Each path prints every rank's wall seconds, K1 launches and
     peak memory above what the rank held before it, the shard shapes the
     path reports holding (each (rows, N/2), checked; the linear paths' peak
     below the full unsharded operand and factors, checked), the
     collectives' counts and bytes by kind, and the backend, beside phase
     3/6/9's single-device numbers;
 16. the candidate axis over replica ranks, the JAX package's entry
     (init_carry, place_population, evolve_while from that carry), each
     rank stepping only its K/2 slots: on a (2, 1) mesh of two ranks
     sharing the card over gloo, phase 6's general eig (K2 launched on each
     rank at (16, 4096) only, and held against its plain version on the
     inputs the rank's engine handed it), phase 10's Hermitian eig
     (Lanczos), phase 11's (shared eigh) and phase 9's SVD; on a (2, 2)
     mesh of four ranks, phase 3's system with A column-sharded over model,
     in phase 15's solve(mesh=) iterations, certified ≤ 1e-8 by
     refine_distributed (K1 on each rank's (4096, 2048) shard) and by an
     independent FP64 residual. Each placed run is held to the unplaced run
     of the same seed in the same phase (one device, or the model group's
     (1, 2) run): the same iterations and distinct count, every leader's λ
     (σ) within the two runs' engine residuals. Per rank: wall and engine
     seconds, K2/K1 launches, peak memory rise, replica-axis collectives
     (at most 2 an iteration, none as large as the operand) and their
     bytes;
 17. the measuring programs (maus_tpu_torch/benchmarks/), each run as its
     own process with python -m, as a user runs it: python -m
     maus_tpu_torch bench (the headline solve at 4096² with the kernel
     scorecard), throughput, spectral_large --sizes 4096, eig_paths,
     solve16k and age. Every line is printed, and held to its program's
     keys and to this card; the headline and 16384² solves certified
     ≤ 1e-8; the eig, Hermitian eig and SVD rows ≥ 16 distinct at tol; the
     scorecard's K1 and K2 within 10% of phases 2 and 5, and no sol_frac
     above 1.05; the direct eig branch at its target (the Jacobi–Davidson
     branch reported); the AGE 5×20 library as phase 14's and the
     scenarios 4/4.
On every solver path K3 launches once for each trailing update of the
path's LUs, and PR 3's CUDA-core body never (checked).
Then a JSON line with the kernel table (K2 also at phase 16's (16, 4096)),
and as the last line
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

# the seeded operands, the CUDA-event clock and the bound arithmetic that
# the measuring programs use too (H100 SXM peaks from NVIDIA's data sheet:
# HBM rate, FP32 and FP64 outside the tensor cores, the TF32 tensor-core
# rate that K3's split-TF32 products use)
from maus_tpu_torch.benchmarks.common import (
    FP32_FLOPS, FP64_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS, bound_ms, card_line,
    cnormal, eig_operand, hermitian_operand, k1_work, k2_work, make_system,
    svd_operand, time_ms)

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
# kernel's do; that of the row-loop P1 and P2's carried row
# (_SHARED_ROW_BYTES_BLOCKED); and the smallest complex128 N whose columns
# past the redesigned sweep's register fit leave shared memory
# (blocked_plan)
K2_GLOBAL_ROW_N = 10241
K2_GLOBAL_ROW_N_C64 = 17857
BLOCKED_GLOBAL_ROW_N = 8193
STREAM_GLOBAL_ROW_N = 16673
# the 4096² eig with K2's QR kernel (PERF.md §5): iterations, distinct pairs
QR_EIG = (6, 21)
HERM_SMALL_N = 2048          # the shared-eigh branch (SolverConfig.eigh_max_n)
# the reference's scenario counts (README.md, "Results vs the reference")
SCENARIO_COUNTS = ["1/1", "8/8", "8/8", "2/2"]
# checkpoints of phase 13, under the script's directory (gitignored) and
# removed after the phase
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".smoke_checkpoints")
# the mesh paths (phase 15): two ranks share the card over gloo (NCCL
# refuses two ranks on one GPU), which runs the collectives on CUDA tensors
MESH_RANKS = 2
MESH_BACKEND = "gloo"
MESH_EIG_N = EIG_N
MESH_HESS_K = 32
MESH_ISLANDS, MESH_ISLAND_CYCLES = 4, 2
MESH_CLI_N = 1024
# the candidate axis over replica ranks (phase 16): a (2, 1) mesh of two
# ranks sharing the card over gloo, then a (2, 2) mesh of four
REPLICA_RANKS = 2
# KAIROSAGE (phase 14): BASELINE.md row 10's workload, 5 cycles of 20
# candidates, and a stage-III batch of random tapes
AGE_CYCLES = 5
AGE_CANDIDATES = 20
AGE_BATCH = 4096


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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
               launches=launches, lams=lams, **rep.timings)
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


def ls_backward_error(H, X, B):
    """max over the batch and columns of ‖H·x − b‖/(‖H‖_F·‖x‖ + ‖b‖) in
    complex128, a matrix at a time."""
    import torch

    worst = 0.0
    for k in range(H.shape[0]):
        Hk = H[k].to(torch.complex128)
        xk, bk = X[k].to(torch.complex128), B[k].to(torch.complex128)
        r = torch.linalg.vector_norm(Hk @ xk - bk, dim=0)
        den = torch.linalg.matrix_norm(Hk) * torch.linalg.vector_norm(xk, dim=0) \
            + torch.linalg.vector_norm(bk, dim=0)
        worst = max(worst, float((r / den).max()))
        del Hk
    return worst


def phase8_lu_solve(lu, lu_solve, He, gen):
    """Kernel LS on P4's factors of the shifted eig matrices He (the
    finisher's chunk, complex64) and of its first half in complex128 (the
    straggler round's chunk of 4): the permutation against the plain one;
    for R = 1 and 2 the solution against the plain version and
    torch.linalg.lu_solve by the normwise backward error (the kernel's at
    most twice the library's and within 10·√N·ε), R = 2 equal to the bit to
    two R = 1 solves; times in turns beside the library call and the bytes'
    bound (each factor read once). Returns the row of (8, 4096) complex64,
    R = 2."""
    import torch

    rows = {}
    for dtype, H in ((torch.complex64, He),
                     (torch.complex128, He[: He.shape[0] // 2].to(torch.complex128))):
        K, N = H.shape[0], H.shape[-1]
        f, piv = lu.lu_factor(H)
        perm = lu_solve.lu_perm(f, piv)
        t_perm = time_ms(lambda: lu_solve.lu_perm(f, piv), reps=5)
        if not torch.equal(perm, lu_solve.lu_perm_plain(piv)):
            raise AssertionError(f"LS ({K}, {N}) {dtype}: the permutation differs from "
                                 f"the plain one")
        bar = 10 * math.sqrt(N) * torch.finfo(H.real.dtype).eps
        for R in (1, 2):
            B = cnormal(gen, (K, N, R), dtype, H.device)
            X = lu_solve.lu_solve(f, perm, B)
            Xp = lu_solve.lu_solve_plain(f, perm, B)
            Xl = torch.linalg.lu_solve(f, piv, B)
            torch.cuda.synchronize()
            berr, berr_p, berr_l = (ls_backward_error(H, Z, B) for Z in (X, Xp, Xl))
            rel = float((X - Xp).abs().max() / Xp.abs().max())
            if not (berr <= 2 * berr_l and berr <= bar):
                raise AssertionError(f"LS ({K}, {N}, {R}) {dtype}: backward error "
                                     f"{berr:.3e}, torch.linalg.lu_solve {berr_l:.3e}, "
                                     f"bar {bar:.3e}")
            if R == 2:
                apart = torch.stack([lu_solve.lu_solve(f, perm, B[..., c].contiguous())
                                     for c in range(2)], -1)
                if not torch.equal(apart, X):
                    raise AssertionError(f"LS ({K}, {N}) {dtype}: two columns differ "
                                         f"from two one-column solves")
            turns = {"kernel": [], "library": []}
            for _ in range(2):
                turns["kernel"].append(time_ms(lambda: lu_solve.lu_solve(f, perm, B),
                                               reps=10))
                turns["library"].append(time_ms(
                    lambda: torch.linalg.lu_solve(f, piv, B), reps=3))
            t_plain = time_ms(lambda: lu_solve.lu_solve_plain(f, perm, B), reps=2)
            nbytes = K * N * N * f.element_size() + 2 * K * N * R * f.element_size()
            bnd = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(dtype, R)] = dict(ms=turns["kernel"][0], plain_ms=t_plain,
                                    library_ms=turns["library"][0], bound_ms=bnd,
                                    bound_by="bytes", max_abs_err=rel)
            say(8, f"LS ({K}, {N}) {str(dtype)[6:]}, R = {R}: backward error kernel "
                   f"{berr:.3e}, plain {berr_p:.3e}, torch.linalg.lu_solve {berr_l:.3e} "
                   f"(bar {bar:.3e}); max|Δ|/max|x| vs plain {rel:.3e}; in turns, "
                   f"kernel {[round(t, 4) for t in turns['kernel']]} ms, "
                   f"torch.linalg.lu_solve {[round(t, 4) for t in turns['library']]} "
                   f"ms; plain {t_plain:.2f} ms; bound {bnd:.4f} ms (bytes, "
                   f"{100 * bnd / turns['kernel'][0]:.1f}% of it); lu_perm "
                   f"{t_perm:.4f} ms once a factorization")
            del B, X, Xp, Xl
        del f, piv, perm
    return rows[(torch.complex64, 2)]


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


def count_syncs(fn):
    """``fn()`` and the number of synchronizing CUDA calls it made (device
    to host copies, ``.item()``, ``bool`` of a device tensor), as
    ``torch.cuda.set_sync_debug_mode`` reports them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def same_report(got, want):
    """Bit equality of two reports: iterations, distinct counts, residuals
    and every array of every solution."""
    import numpy as np

    return (got.iterations == want.iterations
            and got.num_distinct == want.num_distinct
            and got.residuals == want.residuals
            and all(np.array_equal(np.asarray(x), np.asarray(y))
                    for sg, sw in zip(got.solutions, want.solutions)
                    for x, y in zip(sg, sw)))


def report_diff(got, want) -> str:
    import numpy as np

    res = np.abs(np.subtract(got.residuals[:len(want.residuals)],
                             want.residuals[:len(got.residuals)]))
    return (f"iterations {got.iterations} vs {want.iterations}, distinct "
            f"{got.num_distinct} vs {want.num_distinct}, max |Δ residual| "
            f"{res.max(initial=0.0):.3e}")


def phase13(maus_tpu_torch, A, b, A_svd, reset_counts, counts, check_k3_counts):
    """Checkpoint/resume and metrics on the card: the linear 4096² headline
    and the 4096×2048 SVD, each run uninterrupted with and without
    collect_metrics (host syncs counted), cut short with periodic saves,
    and resumed in a fresh solver from the file; the resumed run must equal
    the uninterrupted one bit for bit. Returns the numbers."""
    import shutil

    import numpy as np
    import torch

    from maus_tpu_torch import MausSolver, ProblemType
    from maus_tpu_torch.solver import evolve as evolve_mod
    from maus_tpu_torch.utils.checkpoint import load_state, save_state

    os.makedirs(CKPT_DIR, exist_ok=True)
    out = {}
    try:
        def linear():
            return MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                              initial_num_candidates=CANDIDATES,
                              global_convergence_tol=TOL, seed=SEED)

        def svd():
            return MausSolver(A_svd, ProblemType.SVD,
                              initial_num_candidates=SVD_CANDIDATES,
                              global_convergence_tol=SVD_TOL, seed=SEED,
                              target_solutions=SVD_TOP)

        for label, make, bound, cut, every, launched in (
                (f"linear {HEADLINE_N}²", linear, MAX_ITERATIONS, 2, 1, ("K1",)),
                (f"svd {SVD_M}×{SVD_N}", svd, SVD_MAX_ITERATIONS, 50, 25,
                 ("P3_cluster", "P4_blocked", "K3"))):
            path = os.path.join(CKPT_DIR, "carry.npz")
            plain, syncs_plain = count_syncs(lambda: make().evolve(bound))
            ref, syncs_ref = count_syncs(
                lambda: make().evolve(bound, collect_metrics=True))
            # engine seconds in turns, plain and metrics: ABBA BAAB
            engine = {False: [plain.timings["engine_s"]],
                      True: [ref.timings["engine_s"]]}
            for with_metrics in (True, False, False, True, True, False):
                engine[with_metrics].append(make().evolve(
                    bound, collect_metrics=with_metrics).timings["engine_s"])
            engine_plain, engine_metrics = engine[False], engine[True]
            part = make().evolve(cut, checkpoint_path=path,
                                 checkpoint_every=every)
            size = os.path.getsize(path)
            reset_counts()
            resumed = make().evolve(bound, resume_from=path)
            c = counts()
            # the loader and the saver alone, on the cut run's file
            s = make()
            template = evolve_mod.init_carry(s.config, s.knowledge, s.A, SEED,
                                             template=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = load_state(path, template, device=s.device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            save_state(os.path.join(CKPT_DIR, "again.npz"), carry)
            save_s = time.perf_counter() - t0
            del s, template, carry
            m = ref.metrics
            rows_ok = m["min_residual"].shape == (bound,) and \
                not any(np.any(v[ref.iterations:]) for v in m.values()) and \
                m["candidate_params"].shape == (bound, 0, 0)
            say(13, f"{label}: uninterrupted {plain.iterations} iterations, "
                    f"{plain.num_distinct} distinct; with collect_metrics "
                    f"{'bit-equal' if same_report(ref, plain) else 'DIFFERENT: ' + report_diff(ref, plain)}"
                    f", {len(m)} metrics of {m['min_residual'].shape[0]} rows "
                    f"(zero after iteration {ref.iterations}: {rows_ok}); cut at "
                    f"{part.iterations} (saved every {every}), resumed to "
                    f"{resumed.iterations}: "
                    f"{'bit-equal' if same_report(resumed, ref) else 'DIFFERENT: ' + report_diff(resumed, ref)}")
            say(13, f"{label}: checkpoint {size} bytes, load {load_s:.4f} s, "
                    f"save {save_s:.4f} s; engine seconds of four runs each "
                    f"in turns, without metrics "
                    f"{[round(x, 4) for x in engine_plain]} (median "
                    f"{statistics.median(engine_plain):.4f}), with "
                    f"{[round(x, 4) for x in engine_metrics]} (median "
                    f"{statistics.median(engine_metrics):.4f}); "
                    f"host syncs of the whole evolve {syncs_plain} without, "
                    f"{syncs_ref} with ({ref.iterations} iterations); launches in "
                    f"the resumed run: {c}")
            if not (same_report(ref, plain) and same_report(resumed, ref)
                    and rows_ok and part.iterations == cut):
                raise AssertionError(f"{label}: the resumed run or the metrics run "
                                     f"differs from the uninterrupted one")
            if syncs_ref - syncs_plain > len(m) + 1:
                raise AssertionError(f"{label}: collecting metrics added "
                                     f"{syncs_ref - syncs_plain} host syncs (the "
                                     f"final readback takes {len(m) + 1})")
            for name in launched:
                if c[name] <= 0:
                    raise AssertionError(f"{label}: the resumed run launched "
                                         f"{name} {c[name]} times")
            if "K3" in launched:
                check_k3_counts(c, SVD_N, label)
            out[label] = dict(
                iterations=ref.iterations, num_distinct=ref.num_distinct,
                bytes=size, load_s=load_s, save_s=save_s,
                engine_s=engine_plain, engine_metrics_s=engine_metrics,
                syncs=syncs_plain, syncs_metrics=syncs_ref, launches=c)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


def phase14(device):
    """KAIROSAGE on the card: the BASELINE.md row 10 workload held to the
    same run on the CPU, a stage-III batch of AGE_BATCH random tapes held to
    the CPU, a two-cycle 4-island run, and the CLI. Returns the numbers."""
    import random

    import numpy as np
    import torch

    from maus_tpu_torch.age import AgeConfig, GenesisEngine, IslandAGE, diffusion
    from maus_tpu_torch.age.tape import compile_tree, generate_tree, stack_tapes

    conf = AgeConfig(candidates_per_cycle=AGE_CANDIDATES)
    runs = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        eng = GenesisEngine(conf, seed=SEED, device=dev)
        runs[dev] = (eng.run(AGE_CYCLES), time.perf_counter() - t0, eng)
    card, card_s, card_eng = runs[device]
    cpu, cpu_s, cpu_eng = runs["cpu"]
    for g, w in zip(card, cpu):
        say(14, f"cycle {g['cycle']}: card best {g['best_fitness']:.6f} library "
                f"{g['library_size']} (survivors {g['survivors']}, archived "
                f"{g['archived']}); CPU best {w['best_fitness']:.6f} library "
                f"{w['library_size']}")
    dbest = max(abs(g["best_fitness"] - w["best_fitness"]) for g, w in zip(card, cpu))
    say(14, f"{AGE_CYCLES}×{AGE_CANDIDATES} seed {SEED}: card {card_s:.3f} s wall, "
            f"CPU {cpu_s:.3f} s wall (same process); max |Δ best| {dbest:.3e}")
    if [g["library_size"] for g in card] != [w["library_size"] for w in cpu] \
            or dbest > 1e-4:
        lib_c = {g.canonical_form(): g.stability for g in card_eng.harmonic_library}
        lib_p = {g.canonical_form(): g.stability for g in cpu_eng.harmonic_library}
        for form in sorted(set(lib_c) ^ set(lib_p)):
            say(14, f"  archived on one side only: {form[:60]} card "
                    f"{lib_c.get(form)} CPU {lib_p.get(form)}")
        raise AssertionError("the card's AGE trajectory parts from the CPU's")

    rng = random.Random(SEED)
    trees = [generate_tree(rng, 0, rng.randint(1, conf.max_tree_depth),
                           conf.variables, conf.unary_ops, conf.binary_ops,
                           conf.const_range) for _ in range(AGE_BATCH)]
    tapes = stack_tapes([compile_tree(t, conf.variables) for t in trees])
    n, t = conf.diffusion_n, conf.diffusion_t
    base = torch.tensor(conf.base_kernel, dtype=torch.float32)
    fits = {}
    for dev in (device, "cpu"):
        kernel = base.to(dev)
        reps = 3 if dev == device else 1
        if dev == device:
            diffusion.run_diffusion_population(tapes, n, t, kernel)   # warm-up
        times = []
        for _ in range(reps):
            if dev == device:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, ok = diffusion.run_diffusion_population(tapes, n, t, kernel)
            fit = diffusion.spread_fitness(final, ok).cpu().numpy()
            times.append(time.perf_counter() - t0)
        fits[dev] = (fit, ok.cpu().numpy(), statistics.median(times))
    (f_card, ok_card, s_card), (f_cpu, ok_cpu, s_cpu) = fits[device], fits["cpu"]
    # the same simulation at the workload's batch of AGE_CANDIDATES tapes
    small = {k: v[:AGE_CANDIDATES] for k, v in tapes.items()}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diffusion.population_fitness(small, n, t, base.to(device)).cpu()
        times.append(time.perf_counter() - t0)
    s_small = statistics.median(times)
    dfit = float(np.max(np.abs(f_card - f_cpu)))
    ok_diff = int(np.sum(ok_card != ok_cpu))
    say(14, f"stage III, {AGE_BATCH} random tapes, N = T = {n}: card "
            f"{s_card:.4f} s ({AGE_BATCH / s_card:.1f} sims/s, median of 3), CPU "
            f"{s_cpu:.4f} s ({AGE_BATCH / s_cpu:.1f} sims/s, {torch.get_num_threads()} "
            f"threads); max |Δ fitness| {dfit:.3e}, ok flags differing {ok_diff}, "
            f"{int(ok_card.sum())} members ok; {AGE_CANDIDATES} tapes on the card "
            f"{s_small:.4f} s (median of 3)")
    if dfit > 1e-4 or ok_diff:
        raise AssertionError(f"stage III on the card parts from the CPU: "
                             f"{dfit:.3e}, {ok_diff} ok flags")

    t0 = time.perf_counter()
    isl = IslandAGE(n_islands=4, config=conf, seed=SEED, device=device).run(2)
    isl_s = time.perf_counter() - t0
    say(14, f"IslandAGE, 4 islands, 2 cycles: best "
            f"{[round(o['best_fitness'], 6) for o in isl]}, library total "
            f"{[o['library_total'] for o in isl]}, {isl_s:.3f} s wall")
    if not isl[-1]["library_total"] > 0:
        raise AssertionError("the island run archived nothing")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "maus_tpu_torch", "age", "--cycles",
                           str(AGE_CYCLES), "--json"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    say(14, f"python -m maus_tpu_torch age --cycles {AGE_CYCLES} --json: exit code "
            f"{proc.returncode}, {len(lines)} lines, library "
            f"{[ln['library_size'] for ln in lines]}, {cli_s:.2f} s")
    if proc.returncode != 0 or [ln["library_size"] for ln in lines] != \
            [g["library_size"] for g in card] or max(
                abs(ln["best_fitness"] - g["best_fitness"])
                for ln, g in zip(lines, card)) > 1e-4:
        raise AssertionError(f"the age CLI: exit code {proc.returncode}, "
                             f"stderr {proc.stderr[-2000:]}")
    return dict(card_s=card_s, cpu_s=cpu_s, dbest=dbest, batch_s=s_card,
                batch_small_s=s_small,
                batch_cpu_s=s_cpu, dfit=dfit, islands_s=isl_s, cli_s=cli_s,
                library=[g["library_size"] for g in card])


def _mesh_report(rep):
    """What phase 15 keeps of a report: plain Python and numpy."""
    return dict(solutions=rep.solutions, residuals=rep.residuals,
                iterations=rep.iterations, num_distinct=rep.num_distinct,
                target=rep.target_solutions, timings=rep.timings,
                shards=rep.shards)


def _phase15_rank(mesh, files):
    """Phase 15's body on each rank: every mesh path through the entry
    points, each with the K1 count, the collective counters and the peak
    memory set to 0 just before it and read just after (the peak as the
    rise over what the rank held when the path began); K1 against its plain
    version on the shard the certification passes it; then every rank's
    numbers gathered to all."""
    import numpy as np
    import torch

    import maus_tpu_torch as mt
    from maus_tpu_torch import MeshSolver, ProblemType
    from maus_tpu_torch.ops.kernels import residual
    from maus_tpu_torch.parallel import comm
    from maus_tpu_torch.parallel.dist_hessenberg import (dist_hess_solve,
                                                         dist_hessenberg)
    from maus_tpu_torch.parallel.dist_refine import stage_spectral
    from maus_tpu_torch.parallel.mesh import column_range
    from maus_tpu_torch.utils.checkpoint import shard_path

    dev = mesh.device
    load = {k: np.load(v, mmap_mode="r") for k, v in files.items()
            if k.endswith("_npy")}
    out, per_rank = {}, []

    cuda = dev.type == "cuda"

    def run(name, fn):
        residual.LAUNCHES = 0
        held = 0
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        with comm.counting() as counts:
            t0 = time.perf_counter()
            res = fn()
            if cuda:
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        out[name] = dict(result=res, calls=dict(counts.calls),
                         bytes=dict(counts.bytes),
                         largest=max(counts.largest.values()))
        per_rank.append((name, [wall, residual.LAUNCHES, (torch.cuda.max_memory_allocated(
            dev) - held) / 2**30 if cuda else 0.0]))
        if mesh.rank == 0:
            say(15, f"rank 0: {name} ran in {wall:.3f} s")

    A, b = load["A_npy"], np.asarray(load["b_npy"])
    lin = dict(tol=TOL, num_candidates=CANDIDATES, max_iterations=MAX_ITERATIONS,
               seed=SEED)
    run("solve", lambda: _mesh_report(mt.solve(A, b, mesh=mesh, **lin)))

    # cut at 2 iterations with a save every iteration, resumed in a fresh
    # solver; then a swap of b in the resumed solver
    ckpt = os.path.join(files["dir"], "mesh_linear.npz")
    kw = dict(b_vector=b, initial_num_candidates=CANDIDATES,
              global_convergence_tol=TOL, seed=SEED)
    run("cut", lambda: _mesh_report(MeshSolver(
        A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh, **kw).evolve(
            max_iterations=2, checkpoint_path=ckpt, checkpoint_every=1)))
    with np.load(shard_path(ckpt, mesh.index("model"))) as f:
        out["cut"]["file_shards"] = [tuple(f["fac.q"].shape),
                                     tuple(f["fac.r"].shape)]
    out["cut"]["file_bytes"] = os.path.getsize(shard_path(ckpt, mesh.index("model")))
    solver = MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh, **kw)
    run("resume", lambda: _mesh_report(solver.evolve(
        max_iterations=MAX_ITERATIONS, resume_from=ckpt)))
    solver.update_problem(b_vector=np.asarray(load["b2_npy"]))
    run("swap", lambda: _mesh_report(solver.evolve(max_iterations=MAX_ITERATIONS)))
    # K1 on the solver's own full-precision shard, with the x slice and the
    # b part its certification passes (b on the first rank, zeros on the
    # others), against the plain version
    A_true, b_true = solver._stA[1], solver._stb[1]
    x = torch.from_numpy(out["swap"]["result"]["solutions"][0][0]).to(dev)
    lo, hi = column_range(x.shape[0], mesh)
    b_part = b_true if mesh.index("model") == 0 else torch.zeros_like(b_true)
    x_loc = x[lo:hi].contiguous()
    r_k = residual.true_residual(A_true, x_loc, b_part)
    r_p = residual.true_residual_plain(A_true, x_loc, b_part)
    k1_err = float((r_k - r_p).abs().max())
    k1_bar = 1e-15 * float(torch.linalg.vector_norm(A_true.to(torch.complex128))) \
        * float(torch.linalg.vector_norm(x_loc))
    if not k1_err <= k1_bar:
        raise AssertionError(f"rank {mesh.rank}: K1 disagrees with plain on its "
                             f"{tuple(A_true.shape)} {A_true.dtype} shard: "
                             f"{k1_err:.3e} > {k1_bar:.3e}")
    k1_rows = comm.gather(torch.tensor([[k1_err, k1_bar]], dtype=torch.float64,
                                       device=dev), mesh.index("model"),
                          mesh.model, mesh, dim=0)
    out["k1_shard"] = dict(shape=tuple(A_true.shape), dtype=str(A_true.dtype),
                           ranks=k1_rows.tolist())
    del solver, A_true, b_true, r_k, r_p
    comm.barrier(mesh)
    os.remove(shard_path(ckpt, mesh.index("model")))
    if mesh.index("model") == 0:
        os.remove(ckpt)

    S = load["S_npy"]
    run("svd", lambda: _mesh_report(mt.svd(
        S, tol=SVD_TOL, max_iterations=SVD_MAX_ITERATIONS,
        num_candidates=SVD_CANDIDATES, target_solutions=SVD_TOP, seed=SEED,
        mesh=mesh)))

    E = load["E_npy"]
    E_loc, _ = stage_spectral(mesh, E)
    hess = []
    run("hessenberg", lambda: hess.append(dist_hessenberg(mesh, E_loc)))
    hess = hess[0]
    out["hessenberg"]["shards"] = dict(A=tuple(E_loc.shape), H=tuple(hess.h.shape),
                                       Q=tuple(hess.q.shape))
    g = torch.Generator().manual_seed(SEED)
    K = MESH_HESS_K
    n = E.shape[0]
    B = torch.complex(torch.randn(K, n, generator=g),
                      torch.randn(K, n, generator=g)).to(dev, hess.h.dtype)
    shifts = torch.complex(torch.randn(K, generator=g),
                           torch.randn(K, generator=g)).to(dev, hess.h.dtype)
    W = []
    run("hess_solve", lambda: W.append(dist_hess_solve(mesh, hess.h, shifts, B)))
    # its relative residual ‖(H − λ_k)w_k − b_k‖/‖b_k‖ from the shards
    lo = mesh.index("model") * hess.h.shape[1]
    HW = comm.all_reduce(W[0][:, lo:lo + hess.h.shape[1]] @ hess.h.T, mesh)
    out["hess_solve"]["rel_residual"] = float(
        (torch.linalg.vector_norm(HW - shifts[:, None] * W[0] - B, dim=-1)
         / torch.linalg.vector_norm(B, dim=-1)).max())
    del hess, W, HW, E_loc
    if cuda:
        torch.cuda.empty_cache()
    run("eig", lambda: _mesh_report(mt.eig(
        E, tol=TOL, num_candidates=EIG_CANDIDATES, target_solutions=EIG_TARGETS,
        max_iterations=EIG_MAX_ITERATIONS, seed=SEED, mesh=mesh)))

    rows = comm.gather(torch.tensor([v for _, v in per_rank], dtype=torch.float64,
                                    device=dev)[None],
                       mesh.index("model"), mesh.model, mesh, dim=0)
    for i, (name, _) in enumerate(per_rank):
        out[name]["ranks"] = rows[:, i].tolist()
    out["backend"] = mesh.backend
    return out


def _phase15_islands(mesh):
    """IslandAGE with stage III split over the replica ranks, and the same
    run on one device, on each rank."""
    from maus_tpu_torch.age import AgeConfig, IslandAGE

    conf = AgeConfig(candidates_per_cycle=AGE_CANDIDATES)
    t0 = time.perf_counter()
    split = IslandAGE(n_islands=MESH_ISLANDS, config=conf, seed=SEED,
                      mesh=mesh).run(MESH_ISLAND_CYCLES)
    t1 = time.perf_counter()
    one = IslandAGE(n_islands=MESH_ISLANDS, config=conf, seed=SEED,
                    device=mesh.device).run(MESH_ISLAND_CYCLES)
    return split, one, t1 - t0, time.perf_counter() - t1


def phase15(single):
    """The mesh paths on the card: two ranks sharing it over gloo, launched
    by parallel/launch.py after phase 1 built the kernels. ``single``: phase
    3/6/9's numbers, which the mesh runs are held against. Returns the
    iterations of the solve(mesh=) run."""
    import numpy as np
    import torch

    from maus_tpu_torch import cli
    from maus_tpu_torch.ops.kernels import residual
    from maus_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    os.makedirs(CKPT_DIR, exist_ok=True)
    files = {"dir": CKPT_DIR}

    def save(name, t):
        files[name + "_npy"] = os.path.join(CKPT_DIR, f"mesh_{name}.npy")
        np.save(files[name + "_npy"], t.cpu().numpy())

    A, b = make_system(HEADLINE_N, COND, SEED, dev)
    save("A", A)
    save("b", b)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    b2 = cnormal(g, (HEADLINE_N,), torch.complex64, dev)
    save("b2", b2)
    S, sig = svd_operand(SVD_M, SVD_N, SVD_TOP, SEED, dev)
    save("S", S)
    E = eig_operand(MESH_EIG_N, SEED, dev)
    save("E", E)
    t0 = time.perf_counter()
    try:
        res = launch.run(_phase15_rank, MESH_RANKS, files, backend=MESH_BACKEND,
                         device="cuda:0")
    finally:
        for k, v in files.items():
            if k.endswith("_npy"):
                os.remove(v)
    say(15, f"{MESH_RANKS} ranks sharing {torch.cuda.get_device_name(0)} over "
            f"{res['backend']}: all paths in "
            f"{time.perf_counter() - t0:.1f} s (spawn included)")

    def line(name, what):
        r = res[name]
        ranks = "; ".join(f"rank {i}: {w:.3f} s, K1 {int(k)}, peak +"
                          f"{p:.3f} GiB" for i, (w, k, p) in enumerate(r["ranks"]))
        say(15, f"{what}: {ranks}; collectives {r['calls']} calls, "
                f"{r['bytes']} bytes a rank (largest {r['largest']}); shards "
                f"{shards_of(name)}")

    def k1_each_rank(name):
        return [int(k) for _, k, _ in res[name]["ranks"]]

    def shards_of(name):
        """The shards a path reported holding (an entry point's report,
        else the function's own outputs)."""
        r = res[name]
        return r["shards"] if "shards" in r else (r["result"] or {}).get("shards")

    def sharded(name, rows, cols, names):
        """The path reported holding exactly ``names``, each a (rows,
        cols/m) shard."""
        got = shards_of(name)
        if tuple(got) != names or \
                any(s_ != (rows, cols // m) for s_ in got.values()):
            raise AssertionError(f"{name}: shards {got}")

    def below_full(name, full_bytes):
        """Each rank's peak rise stayed below the full unsharded operand
        and factors."""
        peaks = [p for _, _, p in res[name]["ranks"]]
        if not max(peaks) < full_bytes / 2**30:
            raise AssertionError(f"{name}: peak rise {peaks} GiB a rank, not "
                                 f"below {full_bytes / 2**30:.3f} GiB unsharded")

    b64 = b.to(torch.complex128)

    def certified(rep, rhs, label):
        x = torch.from_numpy(rep["solutions"][0][0]).to(dev)
        rel = float(torch.linalg.vector_norm(
            residual.true_residual_plain(A, x, rhs.to(torch.complex128)))
            / torch.linalg.vector_norm(rhs.to(torch.complex128)))
        if not (rep["num_distinct"] == 1 and rep["residuals"][0] <= TOL
                and rel <= TOL):
            raise AssertionError(f"{label}: reported {rep['residuals']}, "
                                 f"independent {rel:.3e} > {TOL}")
        return rel

    # linear
    rep = res["solve"]["result"]
    rel = certified(rep, b, "mesh solve")
    if min(k1_each_rank("solve")) <= 0:
        raise AssertionError(f"mesh solve: K1 launches by rank "
                             f"{k1_each_rank('solve')}")
    n, m = HEADLINE_N, MESH_RANKS
    # the working copy is the certified one (the system is complex64): A,
    # Q and R at full size
    full_linear = 3 * n * n * 8
    for name in ("solve", "cut", "resume", "swap"):
        sharded(name, n, n, ("A", "A_true", "Q", "R"))
        below_full(name, full_linear)
    if res["cut"]["file_shards"] != [(n, n // m)] * 2:
        raise AssertionError(f"cut: file shards {res['cut']['file_shards']}")
    k1 = res["k1_shard"]
    say(15, f"K1 vs plain on each rank's {k1['shape']} {k1['dtype'][6:]} shard "
            f"with its x slice and b part: " + "; ".join(
                f"rank {i}: max|Δ| {e:.3e} <= {b_:.3e}"
                for i, (e, b_) in enumerate(k1["ranks"])))
    line("solve", f"solve(mesh=) {n}² κ={COND:g}: {rep['iterations']} iterations, "
                  f"certified {rep['residuals'][0]:.3e} (independent "
                  f"{rel:.3e}; single device: {single['solve']['iterations']} "
                  f"iterations, {single['solve']['reported']:.3e}); "
                  f"engine {rep['timings']['engine_s']:.3f} s, refinement "
                  f"{rep['timings']['finish_s']:.3f} s")
    want, got = res["solve"]["result"], res["resume"]["result"]
    same = want["iterations"] == got["iterations"] and \
        want["residuals"] == got["residuals"] and \
        np.array_equal(want["solutions"][0][0], got["solutions"][0][0])
    if not same:
        raise AssertionError(f"mesh resume: {got['iterations']} iterations, "
                             f"{got['residuals']} vs {want['iterations']}, "
                             f"{want['residuals']}")
    line("cut", f"MeshSolver cut at {res['cut']['result']['iterations']} "
                f"iterations (saved every one; shard file "
                f"{res['cut']['file_bytes']} bytes a rank)")
    line("resume", "resumed from the file in a fresh MeshSolver: bit-equal to "
                   "solve(mesh=)")
    rel2 = certified(res["swap"]["result"], b2, "mesh swap")
    line("swap", f"update_problem(b_vector=b2): {res['swap']['result']['iterations']}"
                 f" iterations, certified {res['swap']['result']['residuals'][0]:.3e}"
                 f" (independent {rel2:.3e})")
    del A, b, b64, b2

    # SVD
    rep = res["svd"]["result"]
    top = sorted(range(rep["num_distinct"]),
                 key=lambda i: -rep["solutions"][i][0])[:SVD_TOP]
    sig_h = sig[:SVD_TOP].cpu().numpy()
    sig_err, worst = 0.0, 0.0
    for j, i in enumerate(top):
        s_, u_, v_ = rep["solutions"][i]
        u, v = (torch.from_numpy(np.asarray(t, np.complex128)).to(dev) for t in (u_, v_))
        worst = max(worst, float(torch.linalg.vector_norm(S @ v - s_ * u)
                                 + torch.linalg.vector_norm(S.mH @ u - s_ * v)))
        sig_err = max(sig_err, abs(s_ - sig_h[j]) / sig_h[j])
    if not (rep["num_distinct"] >= SVD_TOP and sig_err <= 1e-8 and worst <= SVD_TOL):
        raise AssertionError(f"mesh svd: {rep['num_distinct']} triplets, σ off "
                             f"{sig_err:.3e}, residual {worst:.3e}")
    sharded("svd", SVD_M, SVD_N, ("A", "A64"))
    line("svd", f"svd(mesh=) {SVD_M}×{SVD_N}: {rep['num_distinct']} distinct "
                f"triplets in {rep['iterations']} iterations, top {SVD_TOP} σ "
                f"within {sig_err:.3e} of 0.8^k, each at ≤ {worst:.3e} "
                f"(single device: {single['svd']['num_distinct']} in "
                f"{single['svd']['iterations']} iterations, "
                f"{single['svd']['worst_top']:.3e}); engine "
                f"{rep['timings']['engine_s']:.3f} s, finisher "
                f"{rep['timings']['finish_s']:.3f} s")
    del S

    # eig
    ne = MESH_EIG_N
    sharded("hessenberg", ne, ne, ("A", "H", "Q"))
    line("hessenberg", f"dist_hessenberg {ne}²")
    hs = res["hess_solve"]
    if not hs["rel_residual"] <= 1e-3:
        raise AssertionError(f"dist_hess_solve: relative residual "
                             f"{hs['rel_residual']:.3e}")
    line("hess_solve", f"dist_hess_solve ({MESH_HESS_K}, {ne}) complex64 alone: "
                       f"max relative residual {hs['rel_residual']:.3e}")
    rep = res["eig"]["result"]
    sharded("eig", ne, ne, ("A", "A64", "H", "Q"))
    E128 = E.to(torch.complex128)
    order = np.argsort(rep["residuals"])[:EIG_TARGETS]
    indep, lams = [], []
    for i in order:
        lam, v_ = rep["solutions"][i]
        v = torch.from_numpy(np.asarray(v_, np.complex128)).to(dev)
        indep.append(float(torch.linalg.vector_norm(E128 @ v - lam * v)
                           / torch.linalg.vector_norm(v)))
        lams.append(lam)
    if not (rep["num_distinct"] >= EIG_TARGETS and max(indep) <= TOL):
        raise AssertionError(f"mesh eig: {rep['num_distinct']} pairs, worst "
                             f"independent residual {max(indep):.3e}")
    shared = "not compared (another size)"
    if ne == EIG_N:
        ref = np.asarray(single["eig"]["lams"])
        shared = sum(bool(np.min(np.abs(ref - lam)) <= 1e-8) for lam in lams)
    line("eig", f"eig(mesh=) {ne}²: {rep['num_distinct']} distinct pairs in "
                f"{rep['iterations']} iterations, best {EIG_TARGETS} at ≤ "
                f"{max(indep):.3e} (independent complex128), {shared} of them "
                f"within 1e-8 of a phase-6 eigenvalue (single device: "
                f"{single['eig']['num_distinct']} pairs in "
                f"{single['eig']['iterations']} iterations, "
                f"{single['eig']['worst_of_best']:.3e}); Hessenberg "
                f"{rep['timings']['setup_s']:.3f} s, engine "
                f"{rep['timings']['engine_s']:.3f} s, finisher "
                f"{rep['timings']['finish_s']:.3f} s")
    del E, E128
    torch.cuda.empty_cache()

    # no silent backend: NCCL (the default) refuses two ranks on one card
    try:
        launch.run(_phase15_islands, MESH_RANKS, device="cuda:0")
    except ValueError as e:
        if "NCCL refuses" not in str(e):
            raise
        say(15, f"default backend with {MESH_RANKS} ranks on one card: "
                f"ValueError ({e})")
    else:
        raise AssertionError("two ranks on one card ran without naming gloo")

    # IslandAGE over two replica ranks, against one device
    t0 = time.perf_counter()
    split, one, t_split, t_one = launch.run(
        _phase15_islands, MESH_RANKS, backend=MESH_BACKEND, device="cuda:0",
        replica=MESH_RANKS, model=1)
    best = [s_["best_fitness"] for s_ in split]
    if best != [s_["best_fitness"] for s_ in one] or \
            [s_["library_total"] for s_ in split] != [s_["library_total"] for s_ in one]:
        raise AssertionError(f"IslandAGE over replica ranks: best {best}, one "
                             f"device {[s_['best_fitness'] for s_ in one]}")
    say(15, f"IslandAGE {MESH_ISLANDS} islands × {MESH_ISLAND_CYCLES} cycles, "
            f"stage III over {MESH_RANKS} replica ranks: equal "
            f"to one device "
            f"(best {best}); {t_split:.3f} s split, {t_one:.3f} s one device, "
            f"{time.perf_counter() - t0:.1f} s with the spawn")

    # the CLI, once
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--backend", MESH_BACKEND, "solve", "--n", str(MESH_CLI_N),
                       "--mesh-model", str(MESH_RANKS), "--check"])
    lines = buf.getvalue().splitlines()
    if rc != 0 or not lines[0].startswith("SOLVE_LINEAR_SYSTEM: 1/1") or \
            "matched 1/1" not in lines[-1]:
        raise AssertionError(f"mesh CLI: exit code {rc}, {lines}")
    say(15, f"python -m maus_tpu_torch --backend gloo solve --n {MESH_CLI_N} "
            f"--mesh-model {MESH_RANKS} --check: exit code 0, {lines[0]}; "
            f"{lines[-1].strip()}; {time.perf_counter() - t0:.1f} s")
    return res["solve"]["result"]["iterations"]


def _replica_leaders(cfg, carry, target):
    """[(λ or σ, engine residual)] of the distinct leaders."""
    from maus_tpu_torch.solver import strategy

    diag = strategy.compute_diagnostics(cfg, carry.pop, carry.strat, target)
    lead = diag.distinct_leader.cpu().tolist()
    lam = carry.pop.lam.cpu().tolist()
    res = carry.pop.residual.cpu().tolist()
    return [(lam[k], res[k]) for k in range(len(lead)) if lead[k]]


def _replica_runs(mesh, runs):
    """Phase 16's paths on each rank. For each ``(name, build, iterations,
    follow)`` of ``runs``: the entry the JAX package uses (``init_carry``,
    ``place_population``, then ``evolve_while`` from that carry), with the
    K1, K2 and Lanczos counts, the collective counters and the peak memory
    set to 0 just before it and read just after; then, on the ranks of
    replica index 0, the unplaced run of the same seed on the same operand
    (one device on a (2, 1) mesh, the model group's (1, 2) run on a (2, 2)
    mesh). With ``follow`` the placed run must follow it: the same
    iterations and distinct count, and each of the unplaced run's leaders'
    λ (σ) within the two runs' engine residuals of one of the placed run's.
    Without (the Lanczos step, whose trajectory the rounding of a product's
    batch can change: ROADMAP, recorded divergences) it must reach the same
    distinct count, and its leaders go back for a check against the
    spectrum. ``build()`` gives ``(cfg, knowledge, operand, b, target,
    caches, finish)``; ``finish`` (or None) runs on the placed carry.
    Returns every rank's numbers (on every rank) and the inputs of the
    first K2 call of each run."""
    import torch
    import torch.distributed as dist

    from maus_tpu_torch.ops import hessenberg, lanczos
    from maus_tpu_torch.ops.kernels import hess_solve, residual
    from maus_tpu_torch.parallel import comm
    from maus_tpu_torch.parallel.mesh import MODEL_AXIS, REPLICA_AXIS
    from maus_tpu_torch.parallel.placement import place_population
    from maus_tpu_torch.solver import evolve as ev

    dev = mesh.device
    calls = []
    kernel = hessenberg.hess_solve

    def recorded(H, shifts, B):
        if not calls:
            calls.append((H.clone(), shifts.clone(), B.clone()))
        calls.append(tuple(B.shape))
        return kernel(H, shifts, B)

    hessenberg.hess_solve = recorded
    out, k2_inputs = {}, {}
    try:
        for name, build, iters, follow in runs:
            dist.barrier()
            del calls[:]
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            residual.LAUNCHES = hess_solve.LAUNCHES = lanczos.CALLS = 0
            t0 = time.perf_counter()
            cfg, kn, op, rhs, target, caches, finish = build()
            carry = ev.init_carry(cfg, kn, op, SEED)
            carry.pop = place_population(mesh, carry.pop)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            with comm.counting() as counts:
                carry = ev.evolve_while(cfg, kn, op, rhs, SEED, iters, target,
                                        carry0=carry, caches=caches)
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            fin = finish(carry) if finish is not None else None
            torch.cuda.synchronize(dev)
            row = dict(wall_s=time.perf_counter() - t0, setup_s=t1 - t0,
                       engine_s=t2 - t1, K1=residual.LAUNCHES,
                       K2=hess_solve.LAUNCHES, lanczos=lanczos.CALLS,
                       k2_shapes=sorted(set(calls[1:])),
                       peak_gib=(torch.cuda.max_memory_allocated(dev) - held) / 2**30,
                       iterations=int(carry.iteration),
                       num_distinct=int(carry.strat.num_distinct),
                       slots=(carry.pop.slots.lo, carry.pop.slots.hi),
                       **{f"{axis}_{key}": getattr(counts, f"axis_{key}")[axis]
                          for axis in (REPLICA_AXIS, MODEL_AXIS)
                          for key in ("calls", "bytes", "largest")},
                       finish=fin)
            if calls:
                k2_inputs[name] = calls[0]
            if mesh.index(REPLICA_AXIS) == 0:
                t3 = time.perf_counter()
                ref = ev.evolve_while(cfg, kn, op, rhs, SEED, iters, target,
                                      carry0=ev.init_carry(cfg, kn, op, SEED),
                                      caches=caches)
                torch.cuda.synchronize(dev)
                row.update(ref_engine_s=time.perf_counter() - t3,
                           ref_iterations=int(ref.iteration),
                           ref_num_distinct=int(ref.strat.num_distinct))
                got = _replica_leaders(cfg, carry, target)
                excess, dlam = -math.inf, 0.0
                for lam, res in _replica_leaders(cfg, ref, target):
                    near, near_res = min(got, key=lambda g: abs(g[0] - lam)) \
                        if got else (math.inf, math.inf)
                    dlam = max(dlam, abs(near - lam))
                    excess = max(excess, abs(near - lam) - (res + near_res))
                row.update(leader_dlam=dlam, leader_excess=excess, leaders=got)
                same = row["num_distinct"] == row["ref_num_distinct"]
                if follow:
                    same = same and row["iterations"] == row["ref_iterations"] \
                        and excess <= 0.0
                if not same:
                    raise AssertionError(
                        f"{name}: placed run {row['iterations']} iterations, "
                        f"{row['num_distinct']} distinct; unplaced "
                        f"{row['ref_iterations']}, {row['ref_num_distinct']}; "
                        f"leaders' λ apart by {dlam:.3e}, {excess:.3e} beyond "
                        f"the engine residuals")
                del ref
            out[name] = row
            del carry, caches, op
            torch.cuda.empty_cache()
    finally:
        hessenberg.hess_solve = kernel
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every, k2_inputs


def _phase16_spectral(mesh):
    """The (2, 1) paths of phase 16: phase 6's general eig, phase 10's
    (Lanczos) and 11's (shared eigh) Hermitian eigs and phase 9's SVD;
    then K2 against its plain version on the inputs this rank's eig engine
    handed it, timed on the first rank while the other waits."""
    import torch
    import torch.distributed as dist

    from maus_tpu_torch import MausSolver, ProblemType
    from maus_tpu_torch.ops.kernels import hess_solve
    from maus_tpu_torch.solver import evolve as ev

    dev = mesh.device

    def spectral(make, ptype, k, tol):
        def build():
            s = MausSolver(make(), ptype, initial_num_candidates=k,
                           global_convergence_tol=tol, target_solutions=SVD_TOP
                           if ptype == ProblemType.SVD else EIG_TARGETS,
                           seed=SEED, device=dev)
            return (s.config, s.knowledge, s.A, None, s.target_solutions,
                    ev._setup_caches(s.config, s.knowledge, s.A), None)
        return build

    EIG = ProblemType.EIGENVALUE
    every, k2_inputs = _replica_runs(mesh, [
        ("eig", spectral(lambda: eig_operand(EIG_N, SEED, dev), EIG,
                         EIG_CANDIDATES, TOL), EIG_MAX_ITERATIONS, True),
        ("hermitian_lanczos", spectral(lambda: hermitian_operand(EIG_N, SEED, dev),
                                       EIG, EIG_CANDIDATES, TOL), EIG_MAX_ITERATIONS,
         False),
        ("hermitian_eigh", spectral(lambda: hermitian_operand(HERM_SMALL_N, SEED, dev),
                                    EIG, EIG_CANDIDATES, TOL), EIG_MAX_ITERATIONS,
         True),
        ("svd", spectral(lambda: svd_operand(SVD_M, SVD_N, SVD_TOP, SEED, dev)[0],
                         ProblemType.SVD, SVD_CANDIDATES, SVD_TOL),
         SVD_MAX_ITERATIONS, True)])
    H, shifts, B = k2_inputs["eig"]
    k2 = check_k2(hess_solve.hess_solve, hess_solve.hess_solve_rq_plain, H,
                  shifts, B, f"rank {mesh.rank}: K2 {tuple(B.shape)} complex64")
    del k2["W"]
    k2["shape"] = tuple(B.shape)
    checks = [None] * dist.get_world_size()
    dist.all_gather_object(checks, k2)
    if mesh.rank == 0:
        k2["ms"] = time_ms(lambda: hess_solve.hess_solve(H, shifts, B), reps=10)
        k2["plain_ms"] = time_ms(
            lambda: hess_solve.hess_solve_rq_plain(H, shifts, B), reps=2)
        Hd = H[None] + torch.diag_embed(shifts[:, None].expand(*B.shape))
        k2["library_ms"] = time_ms(lambda: torch.linalg.solve(Hd, B[..., None]),
                                   reps=3)
        del Hd
    dist.barrier()
    return every, checks, k2


def _phase16_linear(mesh):
    """The (2, 2) path of phase 16: phase 3's system with A column-sharded
    over model and the population over replica, through the mesh linear
    path's configuration (``solve(mesh=)``'s), certified by
    ``refine_distributed`` (K1 on each rank's shard)."""
    import torch

    from maus_tpu_torch import ProblemKnowledge, ProblemType
    from maus_tpu_torch.parallel.dist_qr import (panel_block, refine_distributed,
                                                 stage_operands)
    from maus_tpu_torch.parallel.placement import place_operands
    from maus_tpu_torch.solver.api import _mesh_config, mesh_convergence_floor

    dev = mesh.device

    def build():
        A, b = make_system(HEADLINE_N, COND, SEED, dev)
        A_loc, b_work, A_true, b_true = stage_operands(mesh, A, b)
        del A
        cfg = _mesh_config(None, ProblemType.SOLVE_LINEAR_SYSTEM,
                           num_candidates=CANDIDATES, tol=TOL, dtype=A_loc.dtype,
                           convergence_floor=mesh_convergence_floor(A_loc.dtype),
                           refine=True)

        def finish(carry):
            res = carry.pop.residual
            x0 = carry.pop.v[int(torch.argmin(torch.where(
                torch.isfinite(res), res, torch.full_like(res, math.inf))))]
            x, rel = refine_distributed(mesh, carry.fac, A_true, b_true, x0,
                                        panel_block(A_loc.shape[1]),
                                        cfg.max_refine_steps, TOL * 0.3)
            return dict(x=x.cpu().numpy(), rel=rel, shard=tuple(A_true.shape))

        return (cfg, ProblemKnowledge(shape=(HEADLINE_N, HEADLINE_N)),
                place_operands(mesh, A_loc), b_work, 1, None, finish)

    return _replica_runs(mesh, [("linear", build, MAX_ITERATIONS, True)])[0]


def phase16(mesh_iterations):
    """The candidate axis over replica ranks on the card: two (2, 1) ranks
    and then four (2, 2) ranks sharing it over gloo. ``mesh_iterations``:
    phase 15's (1, 2) solve(mesh=) iterations, which the (2, 2) linear run
    must equal. Returns K2's row for the kernel table."""
    import numpy as np
    import torch

    from maus_tpu_torch.ops.kernels import residual
    from maus_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    every, checks, k2 = launch.run(_phase16_spectral, REPLICA_RANKS,
                                   backend=MESH_BACKEND, device="cuda:0",
                                   replica=REPLICA_RANKS, model=1)
    say(16, f"({REPLICA_RANKS}, 1) mesh, {REPLICA_RANKS} ranks sharing "
            f"{torch.cuda.get_device_name(0)} over {MESH_BACKEND}: "
            f"{time.perf_counter() - t0:.1f} s with the spawn")
    k2_rows = EIG_CANDIDATES // REPLICA_RANKS

    def lines(every, name, what):
        for rank, rows in enumerate(every):
            r = rows[name]
            ref = f"; unplaced run (same seed) {r['ref_iterations']} iterations, " \
                  f"{r['ref_num_distinct']} distinct in {r['ref_engine_s']:.3f} s " \
                  f"engine, leaders' λ apart by ≤ {r['leader_dlam']:.3e}" \
                if "ref_iterations" in r else ""
            say(16, f"{what}, rank {rank} (slots [{r['slots'][0]}, "
                    f"{r['slots'][1]})): {r['iterations']} iterations, "
                    f"{r['num_distinct']} distinct; wall {r['wall_s']:.3f} s "
                    f"(setup {r['setup_s']:.3f}), engine {r['engine_s']:.3f} s; "
                    f"K2 {r['K2']} at {r['k2_shapes']}, K1 {r['K1']}, Lanczos "
                    f"{r['lanczos']}; peak +{r['peak_gib']:.3f} GiB; replica "
                    f"collectives {r['replica_calls']} ({r['replica_bytes']} bytes, "
                    f"largest {r['replica_largest']}), model "
                    f"{r['model_calls']} ({r['model_bytes']} bytes){ref}")

    def bounded(every, name, operand_bytes):
        """At most 2 replica-axis collectives an iteration, none as large
        as the operand, on every rank."""
        for rank, rows in enumerate(every):
            r = rows[name]
            if not (0 < r["replica_calls"] <= 2 * r["iterations"]
                    and r["replica_largest"] < operand_bytes):
                raise AssertionError(f"{name}, rank {rank}: {r['replica_calls']} "
                                     f"replica collectives in {r['iterations']} "
                                     f"iterations, largest {r['replica_largest']} "
                                     f"bytes (operand {operand_bytes})")

    for name, what, n_bytes in (
            ("eig", f"general eig {EIG_N}², {EIG_CANDIDATES} candidates",
             EIG_N * EIG_N * 8),
            ("hermitian_lanczos", f"Hermitian eig {EIG_N}² (Lanczos)", EIG_N * EIG_N * 8),
            ("hermitian_eigh", f"Hermitian eig {HERM_SMALL_N}² (shared eigh)",
             HERM_SMALL_N * HERM_SMALL_N * 8),
            ("svd", f"svd {SVD_M}×{SVD_N}", SVD_M * SVD_N * 8)):
        lines(every, name, what)
        bounded(every, name, n_bytes)
    for rank, rows in enumerate(every):
        r = rows["eig"]
        if r["K2"] <= 0 or r["k2_shapes"] != [(k2_rows, EIG_N)]:
            raise AssertionError(f"eig, rank {rank}: K2 launched {r['K2']} times "
                                 f"at {r['k2_shapes']}, not at ({k2_rows}, {EIG_N})")
        if rows["hermitian_lanczos"]["lanczos"] <= 0 or \
                rows["hermitian_eigh"]["lanczos"] != 0:
            raise AssertionError(f"rank {rank}: Lanczos calls "
                                 f"{rows['hermitian_lanczos']['lanczos']} at "
                                 f"{EIG_N}², {rows['hermitian_eigh']['lanczos']} at "
                                 f"{HERM_SMALL_N}²")
    for name, n in (("hermitian_lanczos", EIG_N), ("hermitian_eigh", HERM_SMALL_N)):
        # every leader of the placed run is an eigenpair: a unit vector's
        # Rayleigh quotient lies within its residual of an eigenvalue
        w = torch.linalg.eigvalsh(hermitian_operand(n, SEED, dev).to(
            torch.complex128)).cpu().numpy()
        slack = 1e-6 * float(np.abs(w).max())
        off = [float(np.min(np.abs(w - complex(lam).real))) - res
               for lam, res in every[0][name]["leaders"]]
        if not max(off, default=math.inf) <= slack:
            raise AssertionError(f"{name}: a leader's λ lies {max(off):.3e} past "
                                 f"its engine residual from eigvalsh")
        say(16, f"{name}: each of the placed run's {len(off)} leaders' λ within "
                f"its engine residual (+ {slack:.1e}) of eigvalsh (complex128); "
                f"placed {every[0][name]['iterations']} iterations, unplaced "
                f"{every[0][name]['ref_iterations']}")
    for rank, c in enumerate(checks):
        say(16, f"K2 vs plain on rank {rank}'s own engine inputs {c['shape']} "
                f"complex64: residual kernel {c['resid']:.3e}, plain "
                f"{c['plain_resid']:.3e}; backward error {c['berr']:.3e} (bar "
                f"{c['bar']:g}); max|Δ| {c['max_abs_err']:.3e}")
    K, n = k2_rows, EIG_N
    k2["bound_ms"], k2["bound_by"] = bound_ms(*k2_work(K, n), FP32_FLOPS)
    k2["launches"] = every[0]["eig"]["K2"]
    k2["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    say(16, f"K2 at ({K}, {n}) complex64 on rank 0: kernel {k2['ms']:.4f} ms, "
            f"plain {k2['plain_ms']:.1f} ms, torch.linalg.solve "
            f"{k2['library_ms']:.1f} ms, bound {k2['bound_ms']:.4f} ms "
            f"({k2['bound_by']})")

    t0 = time.perf_counter()
    every = launch.run(_phase16_linear, 2 * REPLICA_RANKS, backend=MESH_BACKEND,
                       device="cuda:0", replica=REPLICA_RANKS, model=2)
    say(16, f"({REPLICA_RANKS}, 2) mesh, {2 * REPLICA_RANKS} ranks sharing the "
            f"card over {MESH_BACKEND}: {time.perf_counter() - t0:.1f} s with "
            f"the spawn")
    n = HEADLINE_N
    lines(every, "linear", f"linear {n}² κ={COND:g}, A over model, the "
                           f"population over replica")
    bounded(every, "linear", n * n * 8)
    A, b = make_system(n, COND, SEED, dev)
    fin = every[0]["linear"]["finish"]
    b64 = b.to(torch.complex128)
    rel = float(torch.linalg.vector_norm(residual.true_residual_plain(
        A, torch.from_numpy(fin["x"]).to(dev), b64)) / torch.linalg.vector_norm(b64))
    for rank, rows in enumerate(every):
        r = rows["linear"]
        if r["K1"] <= 0 or r["finish"]["shard"] != (n, n // 2) or \
                r["iterations"] != mesh_iterations:
            raise AssertionError(f"linear, rank {rank}: K1 {r['K1']} on a "
                                 f"{r['finish']['shard']} shard, "
                                 f"{r['iterations']} iterations (phase 15: "
                                 f"{mesh_iterations})")
    if not (fin["rel"] <= TOL and rel <= TOL):
        raise AssertionError(f"linear (2, 2): refine_distributed {fin['rel']:.3e}, "
                             f"independent {rel:.3e} > {TOL}")
    say(16, f"linear (2, 2): {every[0]['linear']['iterations']} iterations (phase "
            f"15's (1, 2) solve(mesh=): {mesh_iterations}); refine_distributed "
            f"certified {fin['rel']:.3e} with K1 on each rank's "
            f"{fin['shard']} shard, independent FP64 residual {rel:.3e}")
    del A, b, b64
    torch.cuda.empty_cache()
    return k2



# the measuring programs (phase 17), each run as its own process on the card
# as a user runs it: the command line, and what each line must carry (the
# JAX program's keys, plus the device)
BENCH_PROGRAMS = (
    ("bench", ["maus_tpu_torch", "bench"]),
    ("throughput", ["maus_tpu_torch.benchmarks.throughput"]),
    ("spectral_large", ["maus_tpu_torch.benchmarks.spectral_large", "--sizes",
                        str(EIG_N)]),
    ("eig_paths", ["maus_tpu_torch.benchmarks.eig_paths"]),
    ("solve16k", ["maus_tpu_torch.benchmarks.solve16k"]),
    ("age", ["maus_tpu_torch.benchmarks.age"]),
)
BENCH_KEYS = {
    "bench": {"metric", "value", "unit", "vs_baseline", "solves_per_s",
              "iterations", "achieved_rel", "k1_launches", "peak_gib", "layers",
              "mfu", "device"},
    "throughput": {"metric", "value", "unit", "vs_baseline", "device"},
    "spectral_large": {"metric", "time_s", "num_distinct", "target", "n_at_tol",
                       "iterations", "max_resid", "resid_top_target",
                       "hbm_peak_gb", "timings", "launches", "device"},
    "eig_paths": {"n", "cands", "target", "direct_hessenberg",
                  "jacobi_davidson_gmres", "jd_over_direct", "device"},
    "solve16k": {"metric", "value", "unit", "vs_baseline", "iters",
                 "scipy_per_solve_modeled_s", "achieved_rel", "peak_gib",
                 "device"},
    "age": {"metric", "time_s", "device"},
}
SCORECARD_KEYS = {"shape", "time_s", "gflops", "mfu", "sol_frac"}
# the scorecard's kernel times against the same kernels' in phases 2 and 5
SCORECARD_AGREE = 0.10
SOL_FRAC_MAX = 1.05


def phase17(k1_ms, k2_ms, age_library):
    """The measuring programs on the card: each module of
    maus_tpu_torch/benchmarks/ run as a user runs it (``python -m``), every
    line parsed and held to its keys, to this card, and to what phases 2-14
    measured: the headline and 16384² solves certified ≤ TOL, ≥ EIG_TARGETS
    distinct at tol on the eig and SVD rows, the scorecard's K1 and K2
    within SCORECARD_AGREE of phases 2 and 5 (``k1_ms``, ``k2_ms``) and no
    sol_frac above SOL_FRAC_MAX, the direct eig branch at its target, the
    AGE 5×20 library as phase 14's (``age_library``) and the scenarios 4/4.
    Returns the lines by program."""
    import torch

    kind = torch.cuda.get_device_name(0)
    root = os.path.dirname(os.path.abspath(__file__))
    lines = {}
    for name, args in BENCH_PROGRAMS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                              capture_output=True, text=True, timeout=600)
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        for row in rows:
            say(17, f"{name}: {json.dumps(row)}")
        say(17, f"python -m {' '.join(args)}: exit code {proc.returncode}, "
                f"{len(rows)} lines, {time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or not rows:
            raise AssertionError(f"{name}: exit code {proc.returncode}, stderr "
                                 f"{proc.stderr[-3000:]}")
        for row in rows:
            missing = BENCH_KEYS[name] - set(row)
            if missing:
                raise AssertionError(f"{name}: a line lacks {sorted(missing)}")
            dev = row["device"]
            if dev["platform"] != "gpu" or dev["kind"] != kind or dev["count"] < 1:
                raise AssertionError(f"{name}: ran on {dev}, not on {kind}")
        lines[name] = rows

    bench, = lines["bench"]
    big, = lines["solve16k"]
    for label, row in (("bench", bench), ("solve16k", big)):
        if not (row["achieved_rel"] <= TOL and "MISS" not in row["metric"]):
            raise AssertionError(f"{label}: achieved_rel {row['achieved_rel']:.3e}")
    kernels = bench["mfu"]["kernels"]
    for kname, row in kernels.items():
        want = SCORECARD_KEYS if row["unit"] != "HBM" else \
            SCORECARD_KEYS - {"gflops", "mfu"} | {"gbs"}
        if not want <= set(row):
            raise AssertionError(f"scorecard {kname}: keys {sorted(row)}")
        if row["sol_frac"] is None or row["sol_frac"] > SOL_FRAC_MAX:
            raise AssertionError(f"scorecard {kname}: sol_frac {row['sol_frac']}")
    for kname, ms in (("true_residual", k1_ms),
                      ("hessenberg_shifted_solve_eig_path", k2_ms)):
        got = kernels[kname]["time_s"] * 1e3
        say(17, f"scorecard {kname}: {got:.4f} ms; the same kernel in this "
                f"run's phase {2 if kname == 'true_residual' else 5}: {ms:.4f} ms "
                f"({100 * (got / ms - 1):+.1f}%)")
        if abs(got / ms - 1) > SCORECARD_AGREE:
            raise AssertionError(f"scorecard {kname} {got:.4f} ms against "
                                 f"{ms:.4f} ms")
    layers = bench["layers"]
    say(17, f"headline {HEADLINE_N}²: {bench['value']:.4f} s = init "
            f"{layers['init_s']:.4f} + engine {layers['engine_s']:.4f} + refine "
            f"{layers['refine_s']:.4f} + other {layers['other_s']:.4f} s; "
            f"{bench['iterations']} iterations, K1 {bench['k1_launches']}")
    for row in lines["spectral_large"]:
        tol = SVD_TOL if row["metric"].startswith("svd") else TOL
        if row["num_distinct"] < EIG_TARGETS or row["n_at_tol"] < EIG_TARGETS \
                or row["resid_top_target"] > tol:
            raise AssertionError(f"{row['metric']}: {row['num_distinct']} distinct, "
                                 f"{row['n_at_tol']} at tol {tol:g}")
    if len(lines["spectral_large"]) != 3:
        raise AssertionError("spectral_large: want the general, Hermitian and "
                             "SVD rows")
    paths, = lines["eig_paths"]
    if paths["direct_hessenberg"]["distinct"] < paths["target"]:
        raise AssertionError(f"eig_paths: the direct branch reached "
                             f"{paths['direct_hessenberg']}")
    jd = paths["jacobi_davidson_gmres"]
    say(17, f"eig_paths: Jacobi–Davidson {jd['distinct']}/{paths['target']} "
            f"distinct in {jd['iters']} iterations, min residual "
            f"{jd['min_res']:.3e}, {jd['s']:.3f} s; direct "
            f"{paths['direct_hessenberg']['distinct']} in "
            f"{paths['direct_hessenberg']['iters']}, "
            f"{paths['direct_hessenberg']['s']:.3f} s")
    parity, _, suite = lines["age"]
    if parity["library"] != age_library or suite["passed"] != "4/4":
        raise AssertionError(f"age: library {parity['library']} (phase 14: "
                             f"{age_library}), scenarios {suite['passed']}")
    return lines


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import maus_tpu_torch
    from maus_tpu_torch import cli
    from maus_tpu_torch.ops import hessenberg, lanczos
    from maus_tpu_torch.ops.kernels import build, cgemm, hess_solve, lu, lu_solve, residual

    def reset_counts():
        residual.LAUNCHES = hess_solve.LAUNCHES = cgemm.LAUNCHES = 0
        cgemm.LAUNCHES_SIMT = 0
        hess_solve.LAUNCHES_QR = 0
        hess_solve.LAUNCHES_V2 = hess_solve.LAUNCHES_V3 = 0
        hess_solve.LAUNCHES_V2_ROWLOOP = hess_solve.LAUNCHES_V3_ROWLOOP = 0
        hess_solve.LAUNCHES_SWEEP = hess_solve.LAUNCHES_BACK = 0
        lu.LAUNCHES = lu.PANEL_LAUNCHES = lu.CLUSTER_PANEL_LAUNCHES = 0
        lu_solve.LAUNCHES = lu_solve.PERM_LAUNCHES = 0
        lanczos.CALLS = 0

    def counts():
        return dict(K1=residual.LAUNCHES, K2=hess_solve.LAUNCHES,
                    K2_QR=hess_solve.LAUNCHES_QR, P1=hess_solve.LAUNCHES_V2,
                    P2=hess_solve.LAUNCHES_V3, P1_PR4=hess_solve.LAUNCHES_V2_ROWLOOP,
                    P2_PR4=hess_solve.LAUNCHES_V3_ROWLOOP,
                    P12_sweep=hess_solve.LAUNCHES_SWEEP,
                    P12_back=hess_solve.LAUNCHES_BACK,
                    P3_panel=lu.PANEL_LAUNCHES, P3_cluster=lu.CLUSTER_PANEL_LAUNCHES,
                    P4_blocked=lu.LAUNCHES,
                    K3=cgemm.LAUNCHES, K3_simt=cgemm.LAUNCHES_SIMT,
                    LS=lu_solve.LAUNCHES, LS_perm=lu_solve.PERM_LAUNCHES,
                    lanczos_calls=lanczos.CALLS)

    def check_ls_counts(c, label):
        """Every finisher factorization had its pivots made a permutation
        once and was solved against 7 times by kernel LS (2 pre-sweeps and 5
        Newton steps, a step's two columns in one launch)."""
        if not (c["LS_perm"] > 0 and c["LS"] == 7 * c["LS_perm"]):
            raise AssertionError(f"{label}: kernel LS launched {c['LS']} times for "
                                 f"{c['LS_perm']} permutations (want 7 a "
                                 f"permutation)")

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
    # the mesh paths certify with K1 on each rank's (N, N/2) shard: phase
    # 15's complex64 system and the CLI's complex128 one
    for shape, dtype in (((HEADLINE_N, HEADLINE_N), torch.complex64),
                         ((HEADLINE_N, HEADLINE_N), torch.complex128),
                         ((HEADLINE_N, HEADLINE_N // MESH_RANKS), torch.complex64),
                         ((HEADLINE_N, HEADLINE_N // MESH_RANKS), torch.complex128),
                         ((MESH_CLI_N, MESH_CLI_N // MESH_RANKS), torch.complex128),
                         ((4097, 4097), torch.complex64),
                         ((1000, 777), torch.complex64),
                         ((1, 513), torch.complex64)):
        err, bar, ops = check_kernel(residual, shape, dtype, dev, gen)
        line = f"K1 vs plain {shape} {str(dtype)[6:]}: max|Δ| {err:.3e} <= {bar:.3e}"
        if shape == (HEADLINE_N, HEADLINE_N):
            A, x, b = ops
            ms = time_ms(lambda: residual.true_residual(A, x, b))
            plain_ms = time_ms(lambda: residual.true_residual_plain(A, x, b))
            nbytes, flops = k1_work(*shape, dtype)
            b_ms, b_by = bound_ms(nbytes, flops, FP64_FLOPS)
            line += (f"; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
                     f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s), "
                     f"bound {b_ms:.4f} ms ({b_by})")
            library_ms = None
            if dtype == torch.complex128:
                library_ms = time_ms(lambda: torch.addmv(b, A, x, alpha=-1))
                line += f", torch.addmv {library_ms:.4f} ms"
            kernel_rows[dtype] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, nbytes=nbytes,
                                      flops=flops)
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
    single = {"solve": best}
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
    # K2's QR kernel, P1 and P2 (its function with a blocked back
    # substitution; redesigned: a streaming sweep and a cluster back
    # substitution) and the row-loop body of each, on the same inputs and held to
    # the same bars (the JAX package's A/B probes,
    # benchmarks/hess_v2_probe.py and hess_v3_probe.py, run P1 and P2 so)
    variants = {"QR": (hess_solve.hess_solve_qr, hess_solve.hess_solve_plain),
                "P1": (hess_solve.hess_solve_v2, hess_solve.hess_solve_v2_plain),
                "P2": (hess_solve.hess_solve_v3, hess_solve.hess_solve_v3_plain),
                "P1 rowloop": (hess_solve.hess_solve_v2_rowloop,
                            hess_solve.hess_solve_v2_plain),
                "P2 rowloop": (hess_solve.hess_solve_v3_rowloop,
                            hess_solve.hess_solve_v3_plain)}
    redesigned = {"P1": (hess_solve.hess_solve_v2, hess_solve.hess_solve_v2_plain,
                         False),
                  "P2": (hess_solve.hess_solve_v3, hess_solve.hess_solve_v3_plain,
                         True)}
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
            where = ""
            if name in redesigned:
                plan = hess_solve.card_plan(k, n, dtype, redesigned[name][2])
                where = f", carried row {plan['home']}, cluster {plan['cluster']}"
            say(5, f"{name} vs plain ({k}, {n}) {str(dtype)[6:]}{where}: residual "
                   f"kernel {r['resid']:.3e}, plain {r['plain_resid']:.3e} (bar "
                   f"{r['bar']:g}); max|Δ| {r['max_abs_err']:.3e}")
        if (k, n) == (3, 1000):
            # the redesign's back substitution at every cluster size
            for name, (solve, plain, _) in redesigned.items():
                worst = 0.0
                for C in range(2, hess_solve.BLOCKED_MAX_CLUSTER + 1):
                    r = check_k2(lambda H_, s_, B_: solve(H_, s_, B_, cluster=C), plain,
                                 Hn, sn, Bn, f"{name} ({k}, {n}) cluster {C}")
                    worst = max(worst, r["resid"])
                say(5, f"{name} vs plain ({k}, {n}) {str(dtype)[6:]} at clusters 2-"
                       f"{hess_solve.BLOCKED_MAX_CLUSTER}: worst residual {worst:.3e} "
                       f"(bar {r['bar']:g})")
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
    # the redesign's zero pivot in the last of three blocks, on one CTA and
    # on a cluster
    Hz = torch.zeros(130, 130, dtype=torch.complex64, device=dev)
    Hz[0, 1] = 1.0
    for name, (solve, _, _) in redesigned.items():
        for C in (2, 3):
            Wz = solve(Hz, torch.zeros(2, dtype=torch.complex64, device=dev),
                       torch.ones(2, 130, dtype=torch.complex64, device=dev), cluster=C)
            if bool(torch.isfinite(torch.view_as_real(Wz)).all(dim=-1).all(dim=-1).any()):
                raise AssertionError(f"{name} (N = 130, cluster {C}): an exact-zero "
                                     f"pivot gave a finite row")
    say(5, "K2, QR, P1, P2 and the row-loop P1, P2 zero-pivot contract: every row of a "
           "singular shifted H non-finite (P1, P2 also at N = 130, clusters 2 and 3)")
    # the carried row in global memory: the row-loop bodies past their 128 KB
    # budget, the redesign past its shared-memory fit, drawn from a
    # generator of its own so that the later phases' draws stay those of
    # earlier slices
    gen_pv = torch.Generator(device=dev)
    gen_pv.manual_seed(SEED + 1)
    for n, names in ((BLOCKED_GLOBAL_ROW_N, ("P1 rowloop", "P2 rowloop")),
                     (STREAM_GLOBAL_ROW_N, ("P1", "P2"))):
        Hg = torch.triu(torch.randn(n, n, generator=gen_pv, dtype=torch.complex128,
                                    device=dev), diagonal=-1) / n \
            + 3.0 * torch.eye(n, dtype=torch.complex128, device=dev)
        sg = torch.full((1,), 0.5 + 0.5j, dtype=torch.complex128, device=dev)
        Bg = torch.randn(1, n, generator=gen_pv, dtype=torch.complex128, device=dev)
        for name in names:
            solve, plain = variants[name]
            if name in redesigned and \
                    hess_solve.blocked_plan(1, n, torch.complex128)["home"] != "global":
                raise AssertionError(f"{name} at (1, {n}) complex128: carried row not "
                                     f"in global memory")
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
    # the function's least work (common.k2_work): read H's upper Hessenberg
    # part, shifts and B once, write W once; ~14·N² flops per candidate
    k2_bytes, k2_flops = k2_work(K, EIG_N)
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
    hess_solve.LAUNCHES_V2_ROWLOOP = hess_solve.LAUNCHES_V3_ROWLOOP = 0
    W1 = pv["QR"]["W"]
    plain_ms = {}
    for name, (solve, plain) in variants.items():
        r = pv[name]
        Wv = solve(H, shifts, B)
        if name != "QR":
            r["v1_rel_diff"] = float((W1 - Wv).abs().max()) / max(
                float(W1.abs().max()), 1e-30)
        del Wv
        # two turns, the redesign beside the row-loop body in the same call
        r["turns"] = [time_ms(lambda: solve(H, shifts, B), reps=10)]
        if plain not in plain_ms:
            plain_ms[plain] = time_ms(lambda: plain(H, shifts, B), reps=2)
        r["plain_ms"] = plain_ms[plain]
    for name, (solve, _) in variants.items():
        pv[name]["turns"].append(time_ms(lambda: solve(H, shifts, B), reps=10))
        pv[name]["ms"] = min(pv[name]["turns"])
    pv["QR"]["launches"] = hess_solve.LAUNCHES_QR
    pv["P1"]["launches"] = hess_solve.LAUNCHES_V2
    pv["P2"]["launches"] = hess_solve.LAUNCHES_V3
    pv["P1 rowloop"]["launches"] = hess_solve.LAUNCHES_V2_ROWLOOP
    pv["P2 rowloop"]["launches"] = hess_solve.LAUNCHES_V3_ROWLOOP
    k2_again_ms = time_ms(lambda: hess_solve.hess_solve(H, shifts, B), reps=10)
    k2_vs_qr = float((W1 - k2["W"]).abs().max()) / float(W1.abs().max())
    for name, r in pv.items():
        say(5, f"{name} at ({K}, {EIG_N}) complex64: kernel {r['ms']:.3f} ms (two "
               f"turns {[round(t, 4) for t in r['turns']]}; {r['ms'] / k2_ms:.2f}× the "
               f"RQ kernel's {k2_ms:.4f} ms; RQ again after all: {k2_again_ms:.4f} ms), "
               f"plain {r['plain_ms']:.1f} ms, torch.linalg.solve {k2_lib_ms:.1f} ms, "
               f"bound {k2_bound:.4f} ms ({k2_by}, the work of K2); "
               + (f"QR-vs-{name} rel diff {r['v1_rel_diff']:.3e}; "
                  if "v1_rel_diff" in r else "")
               + f"launches {r['launches']}")
    say(5, f"RQ-vs-QR rel diff at ({K}, {EIG_N}) complex64: {k2_vs_qr:.3e} of "
           f"max|w| (two complex64 orders of the same solve; both within the bars "
           f"above)")
    # P1 and P2 split: the redesign's sweep and back substitution each alone
    # (blocked_sweep, blocked_back), the row-loop body's sweep alone (its sweep-only
    # mode) and its back substitution by difference; the floor of a design
    # that keeps R (R written once and read once) beside K2's bound; the
    # redesign at K = 1 (no sharing of H's rows through L2)
    for name, (solve, _, tiled) in redesigned.items():
        r = pv[name]
        R_, Y_ = hess_solve.blocked_sweep(H, shifts, B, tiled)
        r["sweep_ms"] = time_ms(lambda: hess_solve.blocked_sweep(H, shifts, B, tiled),
                                reps=10)
        r["back_ms"] = time_ms(lambda: hess_solve.blocked_back(R_, Y_, tiled), reps=10)
        del R_, Y_
        old = pv[f"{name} rowloop"]
        rowloop = variants[f"{name} rowloop"][0]
        old["sweep_ms"] = time_ms(lambda: rowloop(H, shifts, B, sweep_only=True), reps=5)
        old["back_ms"] = old["ms"] - old["sweep_ms"]
        r["r_floor_ms"] = old["r_floor_ms"] = (
            2 * K * hess_solve.r_elems(EIG_N, tiled) * 8 / HBM_BYTES_PER_S * 1e3)
        one_ms = time_ms(lambda: solve(H, shifts[:1], B[:1].contiguous()), reps=10)
        plan = hess_solve.card_plan(K, EIG_N, B.dtype, tiled)
        r["speedup"] = old["ms"] / r["ms"]
        say(5, f"{name} at ({K}, {EIG_N}) complex64, split: redesign {r['ms']:.4f} ms = "
               f"sweep {r['sweep_ms']:.4f} ms (carried row {plan['home']}) + back "
               f"substitution {r['back_ms']:.4f} ms (cluster {plan['cluster']}); the "
               f"row-loop body {old['ms']:.3f} ms = sweep {old['sweep_ms']:.3f} ms + back "
               f"substitution {old['back_ms']:.3f} ms (by difference); "
               f"{r['speedup']:.2f}× faster; R-traffic floor {r['r_floor_ms']:.3f} ms "
               f"beside the bound {k2_bound:.4f} ms; the redesign at K = 1: "
               f"{one_ms:.4f} ms")
        if r["speedup"] < 2.0:
            raise AssertionError(f"{name} at ({K}, {EIG_N}): the redesign is only "
                                 f"{r['speedup']:.2f}× faster than the row-loop body")
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
        Wb = solve(Hb, shifts, Bb)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        res = float(shifted_residual(Hb, shifts, Wb, Bb).max())
        del Wb
        if not res <= 5e-5:
            raise AssertionError(f"{name} ({K}, {n}): residual {res:.3e} > 5e-5")
        k2_large[name] = (time_ms(lambda: solve(Hb, shifts, Bb), reps=2), extra, res)
    for name in redesigned:
        ratio = k2_large[f"{name} rowloop"][0] / k2_large[name][0]
        if ratio < 2.0:
            raise AssertionError(f"{name} at ({K}, {n}): the redesign is only "
                                 f"{ratio:.2f}× faster than the row-loop body")
    say(5, f"({K}, {n}) complex64, one design at a time: "
           + "; ".join(f"{name} {ms:.3f} ms, the call's extra device memory "
                       f"{extra / 2**30:.3f} GiB, residual {res:.2e}"
                       for name, (ms, extra, res) in k2_large.items())
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
    check_ls_counts(eig_counts, f"{EIG_N}² eig")
    if eig_counts["P4_blocked"] <= 0 or eig_counts["P3_cluster"] <= 0:
        raise AssertionError(f"the eig finisher ran the blocked LU (P4) "
                             f"{eig_counts['P4_blocked']} and the cluster panel "
                             f"{eig_counts['P3_cluster']} times")
    others = ("K2_QR", "P1", "P2", "P1_PR4", "P2_PR4", "P12_sweep", "P12_back")
    if not (eig_counts["K2"] > 0 and all(eig_counts[c] == 0 for c in others)):
        raise AssertionError(f"the eig's shifted solves went through the RQ "
                             f"kernel {eig_counts['K2']} times and the QR kernel, "
                             f"P1, P2 and the row-loop bodies "
                             f"{[eig_counts[c] for c in others]} times")
    eig_peak = torch.cuda.max_memory_allocated()
    say(6, f"first eig {EIG_N}²: {first}; peak device memory "
           f"{eig_peak / 2**30:.2f} GiB")
    warm = eig_and_check(maus_tpu_torch, hess_solve, A, "4096² eig")
    single["eig"] = warm
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
    ls_row = phase8_lu_solve(lu, lu_solve, He, gen)
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
    check_ls_counts(svd_counts, f"{SVD_M}×{SVD_N} svd")
    for name in ("P3_cluster", "P4_blocked", "K3"):
        if svd_counts[name] <= 0:
            raise AssertionError(f"the SVD path launched {name} {svd_counts[name]} "
                                 f"times")
    say(9, f"first svd {SVD_M}×{SVD_N}: {first}; peak device memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    warm = svd_and_check(maus_tpu_torch, A_svd, sig, f"{SVD_M}×{SVD_N} svd")
    single["svd"] = warm
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

    # ---- phase 13: checkpoint/resume and metrics on the card ----------------
    A, b = make_system(HEADLINE_N, COND, SEED, dev)
    A_svd, _ = svd_operand(SVD_M, SVD_N, SVD_TOP, SEED, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phase13(maus_tpu_torch, A, b, A_svd, reset_counts, counts, check_k3_counts)
    say(13, f"checkpoint/resume and metrics: {time.perf_counter() - t0:.1f} s")
    del A, b, A_svd
    torch.cuda.empty_cache()

    # ---- phase 14: KAIROSAGE on the card -------------------------------------
    t0 = time.perf_counter()
    age = phase14(dev)
    say(14, f"KAIROSAGE: {time.perf_counter() - t0:.1f} s")

    # ---- phase 15: the mesh paths, two ranks sharing the card ---------------
    t0 = time.perf_counter()
    mesh_iterations = phase15(single)
    say(15, f"mesh paths: {time.perf_counter() - t0:.1f} s")

    # ---- phase 16: the candidate axis over replica ranks --------------------
    t0 = time.perf_counter()
    k2r = phase16(mesh_iterations)
    say(16, f"the candidate axis over replica ranks: "
            f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 17: the measuring programs on the card ------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase17(kernel_rows[torch.complex64]["ms"], k2_ms, age["library"][-1])
    say(17, f"the measuring programs: {time.perf_counter() - t0:.1f} s")

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
        "bound_by": k2_by, "library_ms": k2_lib_ms}, {
        "name": "hess_solve_replica_slots", "route": "cuda",
        "source": "maus_tpu_torch/csrc/hess_solve_rq.cu",
        "replaces": "maus_tpu/ops/pallas/hess_solve.py:158",
        "launches": k2r["launches"], "max_abs_err": k2r["max_abs_err"],
        "ms": k2r["ms"], "plain_ms": k2r["plain_ms"], "bound_ms": k2r["bound_ms"],
        "bound_by": k2r["bound_by"], "library_ms": k2r["library_ms"]}, *[{
        "name": name, "route": "cuda", "source": f"maus_tpu_torch/csrc/{src}.cu",
        "replaces": replaces, "launches": pv[key]["launches"],
        "max_abs_err": pv[key]["max_abs_err"], "ms": pv[key]["ms"],
        "plain_ms": pv[key]["plain_ms"], "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": k2_lib_ms} for key, name, src, replaces in (
            ("QR", "hess_solve_qr", "hess_solve",
             "maus_tpu/ops/pallas/hess_solve.py:158"),
            ("P1", "hess_solve_v2", "hess_stream_v2",
             "benchmarks/hess_v2_probe.py:168"),
            ("P2", "hess_solve_v3", "hess_stream_v3",
             "benchmarks/hess_v3_probe.py:187"),
            ("P1 rowloop", "hess_solve_v2_rowloop", "hess_solve_v2",
             "benchmarks/hess_v2_probe.py:168"),
            ("P2 rowloop", "hess_solve_v3_rowloop", "hess_solve_v3",
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
        "library_ms": lu_rows[EIG_N]["library_ms"]}, {
        "name": "lu_solve", "route": "cuda", "source": "maus_tpu_torch/csrc/lu_solve.cu",
        "replaces": None, "launches": eig_counts["LS"],
        "max_abs_err": ls_row["max_abs_err"], "ms": ls_row["ms"],
        "plain_ms": ls_row["plain_ms"], "bound_ms": ls_row["bound_ms"],
        "bound_by": ls_row["bound_by"], "library_ms": ls_row["library_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
