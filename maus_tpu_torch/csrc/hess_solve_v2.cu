// The row-loop body of P1 (its first CUDA form), kept as the yardstick of its
// redesign (hess_stream_v2.cu) and launched on no solver path: the batched
// shifted upper-Hessenberg solve with a blocked back substitution,
//   (H + s_k I) w_k = b_k   for k = 0..K-1, one shared upper-Hessenberg H.
//
// Replaces benchmarks/hess_v2_probe.py:168, hess_solve_v2 (body _kernel_v2),
// a TPU alternative to K2 (maus_tpu/ops/pallas/hess_solve.py) that only the
// JAX package's A/B probe calls. It computes K2's function with K2's contract
// (hess_solve.cu): K2's forward Givens sweep, any K and N >= 1, complex64 and
// complex128, a non-finite row on an exact-zero diagonal. The TPU kernel's
// gates (N % 128 == 0, K a multiple of its chunk) do not apply.
//
// Bound: the same work as K2, ~14·K·N² flops (10·N² in the sweep, 4·N² in
// the back substitution): 0.112 ms at (32, 4096) complex64 on the FP32
// rate, 0.0207 ms by bytes alone. Like K2 the kernel is latency-bound: one
// block per candidate, so only K of the 132 SMs have work, and the sweep's
// N - 1 dependent steps each end in a block barrier.
//
// Design. The forward sweep is K2's (hess_common.cuh, hess_blocked.cuh):
// the carried row in shared memory, R's rows written once, packed. What this
// variant changes is the back substitution, where K2 ends each of the N
// columns with a block-wide reduction and a barrier. Here the columns go in
// blocks of B = 64, from the last block up:
//   phase A: each warp takes rows of the block and reads R[i, i..N) once,
//     coalesced: the part inside the block is staged in shared memory as a
//     column-major tile, the part right of it is dotted with the solved x
//     (a GEMV over the solved columns, four loads in flight per lane, a warp
//     shuffle reduction, no barrier per column);
//   phase B: one warp runs the block's 64-step recurrence from the staged
//     tile, column-oriented: lane l holds the rhs of rows l and l + 32; at
//     column jj the owning lane divides (Smith's scaling, as K2), one shuffle
//     broadcasts x_jj, and every lane subtracts T[t, jj]·x_jj from its rows
//     t < jj (masked). One barrier per block instead of one per column.
// B = 64 because the tile is then 64·65 elements, 33 KB in complex64 and
// 67 KB in complex128, which fits one template for both dtypes beside the
// carried row in shared memory (B = 128 would need 264 KB in complex128), and
// a warp's 32 lanes hold the block's rhs in two registers each.
//
// The TPU kernel's stacked re/im planes (one (2, kc, n) tensor instead of
// two planes) cut the TPU's vector-unit issue count; CUDA cores have no such
// cost (a complex multiply is four FMAs either way), so they are left out.
//
// Operands as K2: H (N, N) row-major, contiguous; shifts (K,); B, W (K, N);
// R a scratch of K·N(N+1)/2 elements; cur_scratch (K, N) or null (the
// carried row, then x, in global memory when N elements exceed the wrapper's
// shared-memory budget).

#include "hess_blocked.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when `block` is not the kernel's block width. With
// sweep_only != 0 the kernel stops after the sweep (W holds y).
extern "C" int maus_hess_solve_v2_rowloop(const void* H, const void* shifts,
                                          const void* B, void* W, void* R,
                                          void* cur_scratch, int is_c128, int K,
                                          int N, int block, int sweep_only,
                                          void* stream) {
  using namespace maus;
  using namespace maus::blocked;
  if (block != kBS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch<double, false>(H, shifts, B, W, R, cur_scratch, K, N, sweep_only, s);
  return launch<float, false>(H, shifts, B, W, R, cur_scratch, K, N, sweep_only, s);
}
