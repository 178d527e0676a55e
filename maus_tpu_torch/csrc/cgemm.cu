// Batched complex GEMM on the CUDA cores (kernel K3's first body, PR 3):
//   C[b] = beta·C[b] + alpha·A[b]·B[b]   for b = 0..batch-1,
// A[b] (M, K), B[b] (K, N), C[b] (M, N), row-major with unit column stride,
// any row strides (lda, ldb, ldc) and batch strides, complex64 or complex128.
//
// Replaces maus_tpu/ops/pallas/cgemm.py:57, cgemm (body _cgemm_kernel, :35):
// complex64 C = A·B at full f32 precision by the 3M scheme on split re/im
// planes, an (i, j, k) tile grid accumulating over k in VMEM. In the port it
// is the trailing update A22 -= L21·U12 of the blocked LU (kernel P4,
// maus_tpu_torch/ops/kernels/lu.py), whose Pallas body computes that product
// itself (benchmarks/parked/pallas_lu_blocked.py:153-158).
//
// maus_cgemm, the entry every caller uses (the LU's maus_lu_factor
// included), sends complex64 to the tensor-core kernel in csrc/cgemm_tc.cu
// (split-TF32 products, FP32-accurate) and complex128 to the body below.
// maus_cgemm_simt runs the body below for both types: for complex64 it is
// the A/B yardstick of the tensor-core kernel, on no solver path.
//
// 3M or 4M: the 3M scheme saves one of four MXU passes on the TPU, where the
// products are the cost and the extra (Ar+Ai)·(Br+Bi) operand is cheap VPU
// work. Here every real multiply-add is one FFMA (or DFMA) on the CUDA cores,
// and the 4-FMA complex product re += ar·br − ai·bi, im += ar·bi + ai·br is
// the same function with one rounding per FMA; 3M would save a quarter of the
// FMAs but forms Im as P3 − P1 − P2, whose cancellation loses accuracy when
// |Re| ≫ |Im|, and it needs a third staged operand. A simple tiled kernel is
// bounded by its shared-memory traffic and latency before its FMA rate, so
// the 4-FMA form costs little and keeps the error bound of a plain complex
// product: |ΔC| ≤ ~K·ε·max|a|·max|b| per element.
//
// Bound: 8·M·N·K real flops at the FP32 rate outside the tensor cores
// (67 TFLOP/s on an H100 SXM): 8.2 ms at M = N = K = 4096; complex128 at the
// FP64 rate (34 TFLOP/s). The trailing updates of the blocked LU have K = 64,
// where reading and writing C once (16 B per complex64 element) weighs as
// much as the flops.
//
// Design (simple and right first): one block of 256 threads per 64×64 output
// tile and batch entry; the k loop stages a 64×16 tile of A (stored
// transposed, one padding column against bank conflicts) and a 16×64 tile of
// B in shared memory, 16 complex elements per row segment so that a half warp
// reads 128 contiguous bytes; each thread keeps a 4×4 register tile of
// complex accumulators at rows ty + 16·i and columns tx + 16·j, so that
// neighbouring threads read neighbouring shared-memory words and write
// neighbouring columns of C. Ragged edges load zeros and skip their stores.
// beta = 0 never reads C (C may then hold anything, NaN included). All
// offsets are 64-bit. Measured on an H100 at 4096³ complex64: 38.3 TFLOP/s,
// 57% of the FP32 peak; a warp's 8-byte shared loads take as many cycles as
// its FMAs, and each k-slice is loaded, then computed, with no overlap.

#include <cstdint>
#include <cuda_runtime.h>

#include "cgemm.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;
constexpr int kSub = kTile / 16;

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

__device__ __forceinline__ float rfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double rfma(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
cgemm_kernel(const cx<R>* __restrict__ A, const cx<R>* __restrict__ B,
             cx<R>* __restrict__ C, int M, int N, int K, int64_t lda,
             int64_t ldb, int64_t ldc, int64_t sA, int64_t sB, int64_t sC,
             R alpha_re, R alpha_im, R beta_re, R beta_im, int beta_zero) {
  __shared__ cx<R> As[kDepth][kTile + 1];
  __shared__ cx<R> Bs[kDepth][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int64_t b = blockIdx.z;
  A += b * sA;
  B += b * sB;
  C += b * sC;

  R accr[kSub][kSub];
  R acci[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      accr[i][j] = R(0);
      acci[i][j] = R(0);
    }

  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int t = 0; t < kTile * kDepth / kThreads; ++t) {
      const int idx = tid + t * kThreads;
      const int r = idx / kDepth;
      const int kk = idx % kDepth;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? A[gr * lda + gk] : mk(R(0), R(0));
    }
#pragma unroll
    for (int t = 0; t < kTile * kDepth / kThreads; ++t) {
      const int idx = tid + t * kThreads;
      const int kk = idx / kTile;
      const int c = idx % kTile;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? B[gk * ldb + gc] : mk(R(0), R(0));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      cx<R> a[kSub];
      cx<R> bv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          accr[i][j] = rfma(a[i].re, bv[j].re, accr[i][j]);
          accr[i][j] = rfma(-a[i].im, bv[j].im, accr[i][j]);
          acci[i][j] = rfma(a[i].re, bv[j].im, acci[i][j]);
          acci[i][j] = rfma(a[i].im, bv[j].re, acci[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      cx<R>* p = C + r * ldc + c;
      R outr = alpha_re * accr[i][j] - alpha_im * acci[i][j];
      R outi = alpha_re * acci[i][j] + alpha_im * accr[i][j];
      if (!beta_zero) {
        const cx<R> o = *p;
        outr += beta_re * o.re - beta_im * o.im;
        outi += beta_re * o.im + beta_im * o.re;
      }
      *p = mk(outr, outi);
    }
  }
}

template <typename R>
int launch(const void* A, const void* B, void* C, int batch, int M, int N, int K,
           long long lda, long long ldb, long long ldc, long long sA,
           long long sB, long long sC, double ar, double ai, double br,
           double bi, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch);
  const int beta_zero = (br == 0.0 && bi == 0.0) ? 1 : 0;
  cgemm_kernel<R><<<grid, kThreads, 0, stream>>>(
      static_cast<const cx<R>*>(A), static_cast<const cx<R>*>(B),
      static_cast<cx<R>*>(C), M, N, K, lda, ldb, ldc, sA, sB, sC, R(ar), R(ai),
      R(br), R(bi), beta_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// is_c128 selects the element type: 0 for complex64, 1 for complex128.
// Strides are in elements; C must not overlap A or B. M, N and batch must be
// >= 1 (K may be 0: C = beta·C).

// The body above for both types.
extern "C" int maus_cgemm_simt(const void* A, const void* B, void* C, int is_c128,
                               int batch, int M, int N, int K, long long lda,
                               long long ldb, long long ldc, long long sA,
                               long long sB, long long sC, double alpha_re,
                               double alpha_im, double beta_re, double beta_im,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_c128)
    return launch<double>(A, B, C, batch, M, N, K, lda, ldb, ldc, sA, sB, sC,
                          alpha_re, alpha_im, beta_re, beta_im, s);
  return launch<float>(A, B, C, batch, M, N, K, lda, ldb, ldc, sA, sB, sC,
                       alpha_re, alpha_im, beta_re, beta_im, s);
}

// K3: complex64 on the tensor cores (csrc/cgemm_tc.cu, its copy width chosen
// from the pointers and strides), complex128 on the body above.
extern "C" int maus_cgemm(const void* A, const void* B, void* C, int is_c128,
                          int batch, int M, int N, int K, long long lda,
                          long long ldb, long long ldc, long long sA,
                          long long sB, long long sC, double alpha_re,
                          double alpha_im, double beta_re, double beta_im,
                          void* stream) {
  if (is_c128)
    return maus_cgemm_simt(A, B, C, 1, batch, M, N, K, lda, ldb, ldc, sA, sB, sC,
                           alpha_re, alpha_im, beta_re, beta_im, stream);
  return maus_cgemm_tc(A, B, C, batch, M, N, K, lda, ldb, ldc, sA, sB, sC, alpha_re,
                       alpha_im, beta_re, beta_im, stream);
}
