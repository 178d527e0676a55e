// Batched shifted upper-Hessenberg solve (kernel K2):
//   (H + s_k I) w_k = b_k   for k = 0..K-1, one shared upper-Hessenberg H.
//
// Replaces maus_tpu/ops/pallas/hess_solve.py:158, hess_solve_batched_pallas
// (the TPU kernel behind every shifted solve of the non-Hermitian eig path,
// through maus_tpu/ops/hessenberg.py::solve_shifted_hessenberg). Same contract: a
// forward sweep of complex Givens rotations down the subdiagonal, c = |a|/r,
// s = sign(a)·conj(b)/r with r = sqrt(|a|² + |b|²) and the identity rotation
// when b = 0; row j+1 of the working matrix is always a fresh row of H plus
// the shift on its diagonal, so only the current rotated row and the current
// rhs element are carried. Then a back substitution; an exact-zero diagonal
// of the triangular factor gives inf in that row (the Ψ ladder upstream reads
// non-finite rows as failed solves). The TPU kernel is gated to complex64,
// N % 128 == 0, N <= 1024; this one takes any N >= 1, any K >= 1, complex64 or
// complex128 (templated on the real type).
//
// Operands: H (N, N) row-major, contiguous (entries below the subdiagonal are
// never read); shifts (K,) = -λ_k + ψ_k; B, W (K, N); R a scratch of
// K·N(N+1)/2 elements holding each candidate's triangular factor, packed by
// rows (row j holds columns j..N-1); cur_scratch (K, N) or null (see below).
//
// Bound: at the eig slice shape (K = 32, N = 4096, complex64) the packed
// triangular factor is written once and read once: 2·K·N²/2·8 B = 4.3 GB, at
// least 1.3 ms at 3.35 TB/s; H adds 134 MB read (through L2, shared by all
// candidates). The arithmetic (~8 flops per rotated element, ~8 per
// back-substitution element, 4.3 GFLOP) is far below the FP32 rate. The real
// limit is latency: the sweep has 2N dependent steps per candidate, each ends
// in a block barrier, and only K of the 132 SMs have work.
//
// Design (simple and right first): one thread block per candidate, a loop over
// the N-1 sweep steps. The carried row lives in shared memory (N elements: 32
// KB for complex64 at N = 4096), so any N works without templating the
// per-thread column count; past 160 KB it lives in a global scratch row. Each
// step reads the pivot a = cur[j] after the previous step's barrier, reads
// fresh row j+1 of H coalesced, writes rotated row j once to R (columns >= j
// only) and updates the carried row in place. The back substitution reads each
// R row once, coalesced, as a block reduction for the dot product; x is kept
// in shared memory (the carried row's buffer). The rhs y is written into W and
// overwritten by x. All offsets into R, H, B, W are 64-bit: K·N² reaches 2^31
// at N = 8192, K = 32.

#include "hess_common.cuh"

namespace {

using namespace maus;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row j of the packed upper triangle starts after rows 0..j-1, of lengths
// N, N-1, ..., N-j+1.
__device__ __forceinline__ size_t row_offset(int j, int N) {
  const size_t jj = static_cast<size_t>(j);
  return jj * static_cast<size_t>(N) - jj * (jj - 1) / 2;
}

// Sum over the block; the result is valid in thread 0 only.
template <typename R>
__device__ __forceinline__ cx<R> block_sum(cx<R> v, cx<R>* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.re += __shfl_down_sync(0xffffffffu, v.re, off);
    v.im += __shfl_down_sync(0xffffffffu, v.im, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = add(v, red[w]);
  }
  return v;
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
hess_solve_kernel(const cx<R>* __restrict__ H, const cx<R>* __restrict__ shifts,
                  const cx<R>* __restrict__ B, cx<R>* __restrict__ W,
                  cx<R>* __restrict__ Rpk, cx<R>* __restrict__ gcur, int N) {
  extern __shared__ unsigned char smem_raw[];
  cx<R>* red = reinterpret_cast<cx<R>*>(smem_raw);
  const size_t k = blockIdx.x;
  const size_t n = static_cast<size_t>(N);
  cx<R>* cur = gcur != nullptr ? gcur + k * n : red + kWarps;
  const int tid = threadIdx.x;
  const cx<R> sh = shifts[k];
  const cx<R>* b = B + k * n;
  cx<R>* w = W + k * n;
  cx<R>* Rk = Rpk + k * (n * (n + 1) / 2);

  // carried row 0: H[0] + shift on the diagonal
  for (int col = tid; col < N; col += kThreads) {
    cx<R> v = H[col];
    if (col == 0) v = add(v, sh);
    cur[col] = v;
  }
  cx<R> ycur = b[0];
  __syncthreads();

  // ---- forward Givens sweep ----------------------------------------------
  for (int j = 0; j < N - 1; ++j) {
    const cx<R>* hrow = H + static_cast<size_t>(j + 1) * n;
    const cx<R> a = cur[j];
    const cx<R> bb = hrow[j];  // shared subdiagonal pivot H[j+1, j]
    R c;
    cx<R> s;
    givens(a, bb, c, s);
    const cx<R> ms = mk(-s.re, s.im);  // -conj(s)
    cx<R>* rrow = Rk + row_offset(j, N) - static_cast<size_t>(j);
    for (int col = j + tid; col < N; col += kThreads) {
      cx<R> f = hrow[col];
      if (col == j + 1) f = add(f, sh);
      const cx<R> o = col == j ? a : cur[col];
      rrow[col] = add(scale(c, o), mul(s, f));
      if (col > j) cur[col] = add(mul(ms, o), scale(c, f));
    }
    const cx<R> yn = b[j + 1];
    if (tid == 0) w[j] = add(scale(c, ycur), mul(s, yn));
    ycur = add(mul(ms, ycur), scale(c, yn));
    __syncthreads();
  }
  if (tid == 0) {
    Rk[row_offset(N - 1, N)] = cur[N - 1];
    w[N - 1] = ycur;
  }
  __syncthreads();

  // ---- back substitution ---------------------------------------------------
  cx<R>* xs = cur;  // x[j+1..N-1] lives where the carried row was
  for (int j = N - 1; j >= 0; --j) {
    const cx<R>* rrow = Rk + row_offset(j, N) - static_cast<size_t>(j);
    cx<R> acc = mk(R(0), R(0));
    for (int col = j + 1 + tid; col < N; col += kThreads)
      acc = add(acc, mul(rrow[col], xs[col]));
    acc = block_sum(acc, red);
    if (tid == 0) {
      const cx<R> d = rrow[j];
      const cx<R> num = sub(w[j], acc);
      const cx<R> xj = (d.re != R(0) || d.im != R(0))
                           ? cdiv(num, d)
                           : mk(rinf(R(0)), R(0));
      xs[j] = xj;
      w[j] = xj;
    }
    __syncthreads();
  }
}

template <typename R>
int launch(const void* H, const void* shifts, const void* B, void* W, void* Rs,
           void* cur_scratch, int K, int N, cudaStream_t stream) {
  const size_t smem = sizeof(cx<R>) *
      (kWarps + (cur_scratch != nullptr ? 0 : static_cast<size_t>(N)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hess_solve_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hess_solve_kernel<R><<<K, kThreads, smem, stream>>>(
      static_cast<const cx<R>*>(H), static_cast<const cx<R>*>(shifts),
      static_cast<const cx<R>*>(B), static_cast<cx<R>*>(W),
      static_cast<cx<R>*>(Rs), static_cast<cx<R>*>(cur_scratch), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_c128 selects the element type: 0 for complex64, 1 for complex128.
// cur_scratch: null to keep the carried row in shared memory, else a (K, N)
// buffer of the element type (the wrapper passes one when N elements exceed
// the shared-memory budget).
extern "C" int maus_hess_solve(const void* H, const void* shifts, const void* B,
                               void* W, void* R, void* cur_scratch, int is_c128,
                               int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch<double>(H, shifts, B, W, R, cur_scratch, K, N, s);
  return launch<float>(H, shifts, B, W, R, cur_scratch, K, N, s);
}
