// Kernel P2, redesigned for Hopper: the batched shifted upper-Hessenberg
// solve (H + s_k I) w_k = b_k by a streaming Givens sweep that keeps R and a
// cluster-wide blocked back substitution, with the divide-free
// givens_rsqrt() (hess_common.cuh), the diagonals' reciprocals taken once
// a block, R in column tiles of 64.
//
// Replaces benchmarks/hess_v3_probe.py:187, hess_solve_v3 (body _kernel_v3),
// a TPU alternative to K2 that only the JAX package's A/B probe calls; on
// no solver path of the port either. Design, bound and contract in
// hess_stream.cuh; the row-loop body stays in hess_solve_v3.cu as the yardstick.
//
// Operands: H (N, N) row-major, contiguous; shifts (K,); B, W (K, N); R a
// scratch of K·r_elems(N) elements (hess_common.cuh); spill null (the
// carried row's columns past the register fit in shared memory) or
// (K, N - 480·cols); Y (K, N), read in mode 2 only.

#include "hess_stream.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for what the kernels do not take (see
// maus::stream::entry).
extern "C" int maus_hess_solve_v3(const void* H, const void* shifts, const void* B,
                                  void* W, void* R, void* spill, const void* Y,
                                  int is_c128, int K, int N, int cols, int cluster,
                                  int mode, void* stream) {
  return maus::stream::entry<true>(H, shifts, B, W, R, spill, Y, is_c128, K, N, cols,
                                   cluster, mode, stream);
}
