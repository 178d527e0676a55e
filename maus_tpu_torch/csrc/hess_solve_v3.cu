// The row-loop body of P2 (its first CUDA form), kept as the yardstick of its
// redesign (hess_stream_v3.cu) and launched on no solver path: the batched
// shifted upper-Hessenberg solve with a divide-free sweep, tiled R and a
// blocked back substitution without divides:
//   (H + s_k I) w_k = b_k   for k = 0..K-1, one shared upper-Hessenberg H.
//
// Replaces benchmarks/hess_v3_probe.py:187, hess_solve_v3 (body _kernel_v3),
// a second TPU alternative to K2 that only the JAX package's A/B probe calls.
// It computes K2's function with K2's contract (hess_solve.cu): any K and
// N >= 1, complex64 and complex128, a non-finite row on an exact-zero
// diagonal; the TPU kernel's gates (N % 128 == 0, K a multiple of its chunk)
// do not apply.
//
// Bound: the same work as K2, ~14·K·N² flops: 0.112 ms at (32, 4096)
// complex64 on the FP32 rate, 0.0207 ms by bytes alone. Latency-bound like
// K2 and P1: one block per candidate, N - 1 barriers in the sweep.
//
// Design: P1's blocked back substitution (hess_solve_v2.cu; block B = 64
// for the same reasons) with the three changes of the TPU's v3:
//   - the divide-free rotation: u = rsqrt(|a|²)·rsqrt(|a|² + |b|²),
//     c = |a|²·u, s = a·conj(b)·u, two rsqrts and no divide or hypot on the
//     sweep's dependent chain (maus::blocked::givens_rsqrt);
//   - R in column tiles of width B (tile t: columns [tB, (t+1)B) of rows
//     0..min(N, (t+1)B)-1, row stride B), so the block's diagonal tile is
//     one contiguous 32 KB run (complex64) and phase A reads one contiguous
//     run of B rows per tile;
//   - no divide in the recurrence: before phase B each lane takes the
//     reciprocals conj(d)/|d|² of its two diagonals (inf on an exact zero),
//     so a column costs a multiply, a shuffle and the rank-1 update, which
//     runs without a triangularity mask: rows at or below the current column
//     are solved already, and rows past a ragged block's width are never read.
// The TPU's stacked re/im planes have no counterpart on CUDA cores and are
// left out (hess_solve_v2.cu).
//
// Operands as K2: H (N, N) row-major, contiguous; shifts (K,); B, W (K, N);
// R a scratch of K·((nb-1)·nb/2·B² + N·B) elements, nb = ceil(N/B);
// cur_scratch (K, N) or null.

#include "hess_blocked.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when `block` is not the kernel's block width. With
// sweep_only != 0 the kernel stops after the sweep (W holds y).
extern "C" int maus_hess_solve_v3_rowloop(const void* H, const void* shifts,
                                          const void* B, void* W, void* R,
                                          void* cur_scratch, int is_c128, int K,
                                          int N, int block, int sweep_only,
                                          void* stream) {
  using namespace maus;
  using namespace maus::blocked;
  if (block != kBS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch<double, true>(H, shifts, B, W, R, cur_scratch, K, N, sweep_only, s);
  return launch<float, true>(H, shifts, B, W, R, cur_scratch, K, N, sweep_only, s);
}
