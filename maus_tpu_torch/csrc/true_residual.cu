// True-FP64 residual r = b - A·x for a dense complex operand (kernel K1).
//
// Replaces maus_tpu/ops/pallas/slice_residual.py::sliced_residual_fused, the
// TPU kernel behind every certification of the iterative refinement. The TPU
// has no FP64, so that kernel splits A into an exact f32 triple, extracts
// base-2^5 digits in VMEM and feeds them to bf16 MXU dots, recombining the
// partials in emulated f64 outside the kernel. Hopper has FP64, so this kernel
// widens each element of A exactly to double and accumulates with FP64 FMAs;
// b - A·x happens inside the kernel. Like the TPU kernel, it never writes a
// widened copy of A to device memory: A is read once, in its own dtype.
//
// Operands: A (M, N) complex64 (the c64-exact case, split_triple_c64) or
// complex128 (the full-triple case, split_triple), row-major and contiguous;
// x (N,) complex128; b, r (M,) complex128.
//
// Bound: device-memory bandwidth for reading A once — 8 B per element for c64
// (134 MB at 4096², about 40 us at 3.35 TB/s), 16 B for c128. The FP64 work is
// 8 flops per element, about a tenth of what the FP64 units could do in that
// time. Design (simple and right first): one warp per row, several rows per
// block; 16-byte loads along the row (two c64 or one c128 element per lane);
// x through the read-only cache; two FP64 accumulators per lane, a warp-shuffle
// reduction and one store per row. Ragged M and N (down to N = 1) need no
// padding: a c64 row that starts 8 bytes past a 16-byte boundary peels its
// first element, and an odd remainder is taken by lane 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void cmac(double& re, double& im, double ar,
                                     double ai, double2 xv) {
  re = fma(ar, xv.x, re);
  re = fma(-ai, xv.y, re);
  im = fma(ar, xv.y, im);
  im = fma(ai, xv.x, im);
}

__device__ __forceinline__ void store_row(double re, double im,
                                          const double2* __restrict__ b,
                                          double2* __restrict__ r, int row,
                                          int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, off);
    im += __shfl_down_sync(0xffffffffu, im, off);
  }
  if (lane == 0) {
    const double2 bv = b[row];
    r[row] = make_double2(bv.x - re, bv.y - im);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
residual_c64(const float2* __restrict__ A, const double2* __restrict__ x,
             const double2* __restrict__ b, double2* __restrict__ r, int M,
             int N) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const float2* arow = A + static_cast<size_t>(row) * N;
  double re = 0.0, im = 0.0;
  int j0 = 0;
  if ((reinterpret_cast<uintptr_t>(arow) & 15u) != 0) {
    if (lane == 0) {
      const float2 a = arow[0];
      cmac(re, im, a.x, a.y, __ldg(&x[0]));
    }
    j0 = 1;
  }
  const int npairs = (N - j0) >> 1;
  const float4* arow4 = reinterpret_cast<const float4*>(arow + j0);
#pragma unroll 4
  for (int p = lane; p < npairs; p += 32) {
    const float4 a = arow4[p];
    const int j = j0 + 2 * p;
    cmac(re, im, a.x, a.y, __ldg(&x[j]));
    cmac(re, im, a.z, a.w, __ldg(&x[j + 1]));
  }
  const int jt = j0 + 2 * npairs;
  if (jt < N && lane == 0) {
    const float2 a = arow[jt];
    cmac(re, im, a.x, a.y, __ldg(&x[jt]));
  }
  store_row(re, im, b, r, row, lane);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
residual_c128(const double2* __restrict__ A, const double2* __restrict__ x,
              const double2* __restrict__ b, double2* __restrict__ r, int M,
              int N) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const double2* arow = A + static_cast<size_t>(row) * N;
  double re = 0.0, im = 0.0;
#pragma unroll 4
  for (int j = lane; j < N; j += 32) {
    const double2 a = arow[j];
    cmac(re, im, a.x, a.y, __ldg(&x[j]));
  }
  store_row(re, im, b, r, row, lane);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// a_is_c128 selects the operand dtype: 0 for complex64, 1 for complex128.
extern "C" int maus_true_residual(const void* A, int a_is_c128, const void* x,
                                  const void* b, void* r, int M, int N,
                                  void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_is_c128) {
    residual_c128<<<grid, block, 0, s>>>(
        static_cast<const double2*>(A), static_cast<const double2*>(x),
        static_cast<const double2*>(b), static_cast<double2*>(r), M, N);
  } else {
    residual_c64<<<grid, block, 0, s>>>(
        static_cast<const float2*>(A), static_cast<const double2*>(x),
        static_cast<const double2*>(b), static_cast<double2*>(r), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
