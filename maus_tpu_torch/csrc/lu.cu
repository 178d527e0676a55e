// Batched LU with partial pivoting (kernels P3 and P4): the panel
// factorization, the row interchanges outside a panel and the unit-lower
// triangular solve of the blocked right-looking LU. The driver that strings
// them together with kernel K3's trailing update (csrc/cgemm.cu) is
// maus_tpu_torch/ops/kernels/lu.py::lu_factor.
//
// Replaces benchmarks/parked/pallas_lu.py:103, lu_factor_batched (P3, body
// _lu_kernel, :40), and benchmarks/parked/pallas_lu_blocked.py:169,
// lu_factor_batched_blocked (P4, body _blocked_lu_kernel, :41). Same
// contract: (K, N, N) matrices factored in place into packed L (unit lower,
// multipliers below the diagonal) and U, the pivot of column k the row index
// of the largest |a|² among rows >= k (ties to the lowest index, as jnp.argmax
// and LAPACK's i?amax do), recorded 1-based in torch.linalg.lu_factor's layout
// (the JAX kernels record it 0-based). A zero pivot gives zero multipliers
// and leaves U's diagonal 0 (pallas_lu.py:78), so a later solve is non-finite
// and the Ψ ladder reads it as a failure. The TPU kernels keep the whole
// matrix in VMEM as split f32 planes (N ≤ ~724 at 16 MB), the blocked one
// needs N % 128 == 0 (the lane tile); these take any K >= 1, N >= 1, complex64
// or complex128 (templated on the real type), with 64-bit offsets.
//
// Bound of the whole factorization: 8/3·K·N³ real flops at the FP32 rate
// (67 TFLOP/s on an H100 SXM): 2.7 ms at (K, N) = (8, 2048), 21.9 ms at
// (8, 4096); the bytes (one read and one write of K·N² complex64) take 0.16
// and 0.64 ms at 3.35 TB/s. Almost all flops are the trailing updates, which
// run in kernel K3.
//
// Design (simple and right first):
// * lu_panel: one block of 1024 threads per matrix factors columns [s, e) of
//   rows [s, N) in place in global memory (a 4096 × 64 complex64 panel is
//   2 MB, far past shared memory; the K panels of a batch stay in L2). Per
//   column k: the pivot row p (found in the previous step), a swap of rows k
//   and p across the panel's columns, a barrier, then a warp per row i > k
//   computes the multiplier l = a[i,k]·conj(d)/|d|² (d the pivot) and the
//   rank-1 update a[i,j] -= l·a[k,j] of the panel's columns j > k with its
//   lanes on neighbouring columns (coalesced row segments; the pivot row is
//   read through L1). Four rows are in flight per warp. Lane 0 of each warp
//   keeps the largest |a[i,k+1]|² it produced, so the next pivot needs only
//   one reduction over 32 warps. The chain of N dependent column steps, each
//   ending in two barriers, makes the panel latency-bound.
// * lu_swap: the panel's interchanges applied to the columns outside it, one
//   thread per column, in pivot order; a grid over column tiles × K.
// * lu_trsm: U12 <- L11⁻¹·A[s:e, e:N] (unit lower, panel width <= 64), one
//   block per 64-column tile and matrix, L11 and the tile in shared memory,
//   row by row right-looking with one barrier per row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPanelThreads = 1024;
constexpr int kRowsInFlight = 4;
constexpr int kSwapThreads = 256;
constexpr int kTrsmThreads = 256;
constexpr int kTrsmCols = 64;
constexpr int kMaxTrsmWidth = 64;

template <typename R>
struct __align__(2 * sizeof(R)) cx {
  R re, im;
};

template <typename R>
__device__ __forceinline__ cx<R> mk(R re, R im) {
  cx<R> z;
  z.re = re;
  z.im = im;
  return z;
}

// a - l·u
template <typename R>
__device__ __forceinline__ cx<R> sub_mul(cx<R> a, cx<R> l, cx<R> u) {
  return mk(a.re - (l.re * u.re - l.im * u.im), a.im - (l.re * u.im + l.im * u.re));
}

__device__ __forceinline__ bool is_nan(float x) { return isnan(x); }
__device__ __forceinline__ bool is_nan(double x) { return isnan(x); }
__device__ __forceinline__ float rinf(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double rinf(double) {
  return __longlong_as_double(0x7ff0000000000000ULL);
}

// The pivot search key |a|²; a NaN counts as the largest, as jnp.argmax
// and torch.argmax treat it.
template <typename R>
__device__ __forceinline__ R pivot_key(cx<R> a) {
  const R k = a.re * a.re + a.im * a.im;
  return is_nan(k) ? rinf(R(0)) : k;
}

// (key, row) is better than (best, brow): larger, or equal and lower.
template <typename R>
__device__ __forceinline__ bool better(R key, int row, R best, int brow) {
  return key > best || (key == best && row < brow);
}

template <typename R>
__global__ void __launch_bounds__(kPanelThreads)
lu_panel_kernel(cx<R>* LU, int* piv, int N, int s, int e) {
  __shared__ R red_key[kPanelThreads / 32];
  __shared__ int red_row[kPanelThreads / 32];
  __shared__ int s_piv;
  const int64_t n = N;
  cx<R>* a = LU + static_cast<int64_t>(blockIdx.x) * n * n;
  int* pv = piv + static_cast<int64_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // pivot of column s: a strided argmax over rows [s, N)
  R best = R(-1);
  int brow = N;
  for (int i = s + tid; i < N; i += blockDim.x) {
    const R key = pivot_key(a[i * n + s]);
    if (better(key, i, best, brow)) {
      best = key;
      brow = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const R ok = __shfl_down_sync(0xffffffffu, best, off);
    const int orow = __shfl_down_sync(0xffffffffu, brow, off);
    if (better(ok, orow, best, brow)) {
      best = ok;
      brow = orow;
    }
  }
  if (lane == 0) {
    red_key[warp] = best;
    red_row[warp] = brow;
  }
  __syncthreads();

  for (int k = s; k < e; ++k) {
    // reduce the warps' candidates for column k's pivot
    if (tid == 0) {
      R bk = red_key[0];
      int br = red_row[0];
      for (int w = 1; w < nwarps; ++w)
        if (better(red_key[w], red_row[w], bk, br)) {
          bk = red_key[w];
          br = red_row[w];
        }
      s_piv = br < N ? br : k;
      pv[k] = s_piv + 1;
    }
    __syncthreads();
    const int p = s_piv;
    if (p != k) {
      for (int j = s + tid; j < e; j += blockDim.x) {
        const cx<R> t = a[k * n + j];
        a[k * n + j] = a[p * n + j];
        a[p * n + j] = t;
      }
    }
    __syncthreads();

    const cx<R> d = a[k * n + k];
    R den = d.re * d.re + d.im * d.im;
    if (!(den > R(0))) den = R(1);
    const cx<R>* prow = a + k * n;
    R wbest = R(-1);
    int wrow = N;
    for (int i0 = k + 1 + warp; i0 < N; i0 += nwarps * kRowsInFlight) {
      cx<R> l[kRowsInFlight];
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const int i = i0 + q * nwarps;
        cx<R> m = mk(R(0), R(0));
        if (lane == 0 && i < N) {
          const cx<R> x = a[i * n + k];
          m = mk((x.re * d.re + x.im * d.im) / den, (x.im * d.re - x.re * d.im) / den);
          a[i * n + k] = m;
        }
        l[q].re = __shfl_sync(0xffffffffu, m.re, 0);
        l[q].im = __shfl_sync(0xffffffffu, m.im, 0);
      }
      for (int j = k + 1 + lane; j < e; j += 32) {
        const cx<R> u = prow[j];
#pragma unroll
        for (int q = 0; q < kRowsInFlight; ++q) {
          const int i = i0 + q * nwarps;
          if (i < N) {
            const cx<R> v = sub_mul(a[i * n + j], l[q], u);
            a[i * n + j] = v;
            if (j == k + 1) {
              const R key = pivot_key(v);
              if (better(key, i, wbest, wrow)) {
                wbest = key;
                wrow = i;
              }
            }
          }
        }
      }
    }
    // column k+1's candidates sit in lane 0 (the lane of column k+1)
    if (lane == 0) {
      red_key[warp] = wbest;
      red_row[warp] = wrow;
    }
    __syncthreads();
  }
}

template <typename R>
__global__ void __launch_bounds__(kSwapThreads)
lu_swap_kernel(cx<R>* LU, const int* piv, int N, int s, int e) {
  const int64_t n = N;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N - (e - s)) return;
  const int j = c < s ? c : c + (e - s);
  cx<R>* a = LU + static_cast<int64_t>(blockIdx.y) * n * n;
  const int* pv = piv + static_cast<int64_t>(blockIdx.y) * n;
  for (int k = s; k < e; ++k) {
    const int p = pv[k] - 1;
    if (p != k) {
      const cx<R> t = a[k * n + j];
      a[k * n + j] = a[p * n + j];
      a[p * n + j] = t;
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kTrsmThreads)
lu_trsm_kernel(cx<R>* LU, int N, int s, int e) {
  extern __shared__ unsigned char smem_raw[];
  const int w = e - s;
  cx<R>* L = reinterpret_cast<cx<R>*>(smem_raw);  // w × w
  cx<R>* X = L + w * w;                            // w × kTrsmCols
  const int64_t n = N;
  cx<R>* a = LU + static_cast<int64_t>(blockIdx.y) * n * n;
  const int c0 = e + blockIdx.x * kTrsmCols;
  const int ncols = min(kTrsmCols, N - c0);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < w * w; idx += blockDim.x) {
    const int r = idx / w;
    const int q = idx % w;
    L[idx] = a[(s + r) * n + s + q];
  }
  for (int idx = tid; idx < w * kTrsmCols; idx += blockDim.x) {
    const int r = idx / kTrsmCols;
    const int c = idx % kTrsmCols;
    X[idx] = c < ncols ? a[(s + r) * n + c0 + c] : mk(R(0), R(0));
  }
  __syncthreads();
  for (int q = 0; q + 1 < w; ++q) {
    for (int idx = tid; idx < (w - 1 - q) * kTrsmCols; idx += blockDim.x) {
      const int r = q + 1 + idx / kTrsmCols;
      const int c = idx % kTrsmCols;
      X[r * kTrsmCols + c] = sub_mul(X[r * kTrsmCols + c], L[r * w + q],
                                     X[q * kTrsmCols + c]);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < w * kTrsmCols; idx += blockDim.x) {
    const int r = idx / kTrsmCols;
    const int c = idx % kTrsmCols;
    if (c < ncols) a[(s + r) * n + c0 + c] = X[idx];
  }
}

template <typename R>
int launch_panel(void* LU, void* piv, int K, int N, int s, int e, cudaStream_t st) {
  lu_panel_kernel<R><<<K, kPanelThreads, 0, st>>>(static_cast<cx<R>*>(LU),
                                                  static_cast<int*>(piv), N, s, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_swap(void* LU, const void* piv, int K, int N, int s, int e,
                cudaStream_t st) {
  const int cols = N - (e - s);
  if (cols <= 0) return 0;
  const dim3 grid((cols + kSwapThreads - 1) / kSwapThreads, K);
  lu_swap_kernel<R><<<grid, kSwapThreads, 0, st>>>(
      static_cast<cx<R>*>(LU), static_cast<const int*>(piv), N, s, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_trsm(void* LU, int K, int N, int s, int e, cudaStream_t st) {
  const int w = e - s;
  if (w > kMaxTrsmWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (e >= N) return 0;
  const size_t smem = sizeof(cx<R>) * static_cast<size_t>(w) * (w + kTrsmCols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lu_trsm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N - e + kTrsmCols - 1) / kTrsmCols, K);
  lu_trsm_kernel<R><<<grid, kTrsmThreads, smem, st>>>(static_cast<cx<R>*>(LU), N,
                                                       s, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// LU: (K, N, N) contiguous, complex64 (is_c128 = 0) or complex128 (1), factored
// in place; piv: (K, N) int32, 1-based. Columns [s, e) form the panel.

// Factor the panel: columns [s, e) of rows [s, N), pivots piv[:, s:e].
extern "C" int maus_lu_panel(void* LU, void* piv, int is_c128, int K, int N, int s,
                             int e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch_panel<double>(LU, piv, K, N, s, e, st);
  return launch_panel<float>(LU, piv, K, N, s, e, st);
}

// Apply the interchanges piv[:, s:e] to every column outside [s, e).
extern "C" int maus_lu_swap(void* LU, const void* piv, int is_c128, int K, int N,
                            int s, int e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch_swap<double>(LU, piv, K, N, s, e, st);
  return launch_swap<float>(LU, piv, K, N, s, e, st);
}

// U12 <- L11⁻¹·A[s:e, e:N] with L11 the panel's unit lower triangle
// (e - s <= 64).
extern "C" int maus_lu_trsm(void* LU, int is_c128, int K, int N, int s, int e,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch_trsm<double>(LU, K, N, s, e, st);
  return launch_trsm<float>(LU, K, N, s, e, st);
}
