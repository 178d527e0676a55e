// Batched complex64 GEMM on the tensor cores (kernel K3, complex64 path):
//   C[b] = beta·C[b] + alpha·A[b]·B[b]   for b = 0..batch-1,
// A[b] (M, K), B[b] (K, N), C[b] (M, N), row-major with unit column stride,
// any row strides (lda, ldb, ldc) and batch strides, all in complex elements.
//
// Replaces maus_tpu/ops/pallas/cgemm.py:57, cgemm (body _cgemm_kernel, :35):
// complex64 C = A·B with its real products at Precision.HIGHEST, i.e. to
// FP32 accuracy. In the port it is the trailing update A22 -= L21·U12 of the
// blocked LU (kernel P4, maus_lu_factor in csrc/lu.cu, through maus_cgemm in
// csrc/cgemm.cu, which keeps PR 3's CUDA-core body for complex128 and as the
// A/B yardstick maus_cgemm_simt).
//
// Products: 3-pass split TF32 ("3xTF32") on mma.sync m16n8k8. Each fp32 x is
// split in registers into big = rna_tf32(x) and small = rna_tf32(x − big)
// (round half away from zero to 10 stored mantissa bits, as
// cvt.rna.tf32.f32; x − big is exact), and a·b ≈ small_a·big_b +
// big_a·small_b + big_a·big_b. Every tf32 product is exact in fp32; the
// dropped small_a·small_b and the rounding of the smalls cost at most
// ≈ 3·2⁻²²·|a|·|b| per real product, typically under one fp32 ulp. (Single-
// pass TF32 keeps ~3 digits and is used nowhere.) The complex product stays
// the 4-product form (not 3M, whose Im = P3 − P1 − P2 cancels; see
// csrc/cgemm.cu), folded into two real MMAs per k8 by interleaving k: the A
// fragment's k columns t and t + 4 carry Re and Im of complex k = t, so
//   Re: [Ar | Ai] · [Br ; −Bi],   Im: [Ar | Ai] · [Bi ; Br],
// one 8-byte shared load gives both halves of an A fragment pair (rows g,
// g + 8 take two) and one gives a B fragment, and −Bi is a sign-bit flip of
// its split halves. A complex k4 step is 2 products × 3 passes = 6 MMAs per
// 16×8 output block: 24·M·N·K tensor flops for the 8·M·N·K real ones.
//
// Accumulation. The tensor core adds each MMA's products into its fp32
// accumulator input with a truncating (not nearest) rounding, a biased
// error of up to an ulp of the running sum per MMA. Accumulating all
// 3·K/4 MMAs of an output into its sum, as a plain GEMM does, made the
// error grow ~linearly in K, many times that of the CUDA-core body, and
// P4's backward error several times larger. So each k-slice (16 complex k,
// 12 MMAs a 16×8 block) accumulates into fresh registers and is then added
// to the output's sum with one fp32 add (round to nearest): the truncations
// act on a slice's partial sum, whose sign varies from slice to slice. The
// error is then that of fp32 FMAs or below (chip_smoke.py phase 7 prints it
// beside PR 3's body's).
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 3.35 TB/s): 4096³ takes
// 3.33 ms of tensor work; P4's updates (K = 64) are bound by reading and
// writing C (16 B per element against 512 tensor flops): 0.155 ms at
// (8, 1984, 1984, 64), 0.63 ms at (8, 4032, 4032, 64). This kernel's
// mma.sync reaches about a third of the TF32 peak at 4096³ (chip_smoke.py
// phase 7; the full rate needs wgmma), so the products bound both shapes.
//
// Design. A CTA of 2×2 warps computes a 64×64 complex tile of one batch
// entry, a warp 32×32 (2×4 MMA blocks, Re and Im in separate fp32
// accumulators); two CTAs a SM. k advances in slices of 16 complex through
// a ring of kStages shared-memory stages (dynamic shared memory), filled by
// cp.async with one barrier a slice: 16-byte cp.async.cg copies where every
// base and stride is 16-byte aligned (even in complex elements), else 8-byte
// cp.async.ca copies of the same layout (odd N in the LU's views); ragged
// edges copy zeros (src-size 0 or 8). Operands stay interleaved complex in
// shared memory with an XOR swizzle of 16-byte chunks (A: chunk ^ row%8; B:
// chunk ^ 4·(k%2)), so the fragment loads of a warp take the minimum two
// wavefronts. With beta ≠ 0 the C tile is prefetched into L2 four slices
// before the loop ends (at once for K ≤ 64), and the epilogue loads a 16-row
// block's C values before using any; each thread writes its two
// neighbouring complex outputs as one 16-byte store (8-byte in the
// unaligned form), masks ragged edges, and never reads C when beta = 0. All
// offsets are 64-bit. Warp tiles of 64×32 (CTA tiles 128×128, 128×64) leave
// too few registers for a slice's fresh sums and spill; a 64×128 tile of
// 32×32 warps was no faster, nor a 32×64 one on the LU's last, small
// updates, which take about a launch's latency at any tile; nor splitting
// each operand once per CTA into shared memory (16 bytes an element).
//
// Not here yet: wgmma (TF32 wgmma wants B K-major, a transpose while
// staging), TMA, a persistent schedule.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "cgemm.cuh"

namespace {

constexpr int kDepth = 16;   // complex k per stage
constexpr int kStages = 4;
constexpr int kBM = 64;      // complex rows and columns of a CTA's tile
constexpr int kBN = 64;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 2;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kMinBlocks = 2;
constexpr uint32_t kSign = 0x80000000u;

// rna_tf32(x): round to the nearest tf32 value, ties away from zero, low 13
// bits zero. Two integer instructions give the bits cvt.rna.tf32.f32 gives
// for every non-NaN x (ptxas expands the cvt into six, with a NaN test); a
// NaN x may get a non-NaN big, but its small, x − big, is NaN, so a NaN
// still reaches every product it enters.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(__float_as_uint(x));
  small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One k-slice [k0, k0 + kDepth) of A's rows [row0, row0 + kBM) and of B's
// columns [col0, col0 + kBN) into a stage, swizzled, zeros past the edges.
template <bool V16>
__device__ __forceinline__ void load_slice(float2* as, float2* bs, const float2* A,
                                           const float2* B, int M, int N, int K,
                                           int64_t lda, int64_t ldb, int row0,
                                           int col0, int k0, int tid) {
  constexpr int BM = kBM, BN = kBN, THREADS = kThreads;
  if constexpr (V16) {
    constexpr int kAChunks = BM * kDepth / 2;
#pragma unroll
    for (int i = 0; i < kAChunks / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx >> 3, c = idx & 7;
      const int gk = k0 + 2 * c;
      const int n = (row0 + r < M) ? max(0, min(2, K - gk)) : 0;
      const float2* src = n ? A + r * lda + gk : A;
      cp_async16(as + r * kDepth + ((c ^ (r & 7)) << 1), src, 8 * n);
    }
    constexpr int kRowChunks = BN / 2;
    constexpr int kBChunks = kDepth * kRowChunks;
#pragma unroll
    for (int i = 0; i < kBChunks / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kr = idx / kRowChunks, c = idx % kRowChunks;
      const int gc = col0 + 2 * c;
      const int n = (k0 + kr < K) ? max(0, min(2, N - gc)) : 0;
      const float2* src = n ? B + (k0 + kr) * ldb + 2 * c : B;
      cp_async16(bs + kr * BN + ((c ^ ((kr & 1) << 2)) << 1), src, 8 * n);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM * kDepth / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx >> 4, q = idx & 15;
      const bool ok = row0 + r < M && k0 + q < K;
      const float2* src = ok ? A + r * lda + k0 + q : A;
      cp_async8(as + r * kDepth + ((((q >> 1) ^ (r & 7)) << 1) | (q & 1)), src,
                ok ? 8 : 0);
    }
#pragma unroll
    for (int i = 0; i < kDepth * BN / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kr = idx / BN, q = idx % BN;
      const bool ok = k0 + kr < K && col0 + q < N;
      const float2* src = ok ? B + (k0 + kr) * ldb + q : B;
      cp_async8(bs + kr * BN + ((((q >> 1) ^ ((kr & 1) << 2)) << 1) | (q & 1)), src,
                ok ? 8 : 0);
    }
  }
}

template <bool V16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cgemm_tc_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                float2* __restrict__ C, int M, int N, int K, int64_t lda, int64_t ldb,
                int64_t ldc, int64_t sA, int64_t sB, int64_t sC, float alpha_re,
                float alpha_im, float beta_re, float beta_im, int beta_zero,
                int tiles_n) {
  constexpr int BM = kBM, BN = kBN, THREADS = kThreads;
  constexpr int WM = BM / kWarpsM;
  constexpr int WN = BN / kWarpsN;
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  extern __shared__ float4 smem4[];
  float2* As = reinterpret_cast<float2*>(smem4);
  float2* Bs = As + kStages * BM * kDepth;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm0 = (warp / kWarpsN) * WM;
  const int wn0 = (warp % kWarpsN) * WN;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  const int64_t b = blockIdx.y;
  A += b * sA + row0 * lda;
  B += b * sB + col0;
  C += b * sC;

  float accr[MI][NI][4];
  float acci[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accr[i][j][e] = 0.f;
        acci[i][j][e] = 0.f;
      }

  // shared offsets of this thread's fragments: A's (row, complex k) column
  // for each of the slice's four k4 steps, B's column for each 8-column block
  int acol[kDepth / 4];
#pragma unroll
  for (int kk = 0; kk < kDepth / 4; ++kk)
    acol[kk] = ((((2 * kk + (t >> 1)) ^ g)) << 1) | (t & 1);
  int bcol[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j)
    bcol[j] = (((((wn0 + 8 * j) >> 1) + (g >> 1)) ^ ((t & 1) << 2)) << 1) | (g & 1);

  const int nk = (K + kDepth - 1) / kDepth;
  const int prefetch_at = beta_zero ? -1 : max(0, nk - 4);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_slice<V16>(As + s * BM * kDepth, Bs + s * kDepth * BN, A, B, M, N, K, lda,
                      ldb, row0, col0, s * kDepth, tid);
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) {
      const int st = next % kStages;
      load_slice<V16>(As + st * BM * kDepth, Bs + st * kDepth * BN, A, B, M, N, K,
                      lda, ldb, row0, col0, next * kDepth, tid);
    }
    cp_commit();
    if (kt == prefetch_at) {
      // the C tile's 128-byte lines into L2, for the epilogue's read
      constexpr int kLines = BN / 16;
      for (int idx = tid; idx < BM * kLines; idx += THREADS) {
        const int r = row0 + idx / kLines;
        const int c = col0 + (idx % kLines) * 16;
        if (r < M && c < N)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(C + r * ldc + c));
      }
    }
    const float2* as = As + (kt % kStages) * BM * kDepth;
    const float2* bs = Bs + (kt % kStages) * kDepth * BN;
    // a 16-row block at a time, the slice's 4 k4 steps × 3 passes
    // (small·big, big·small, big·big) into fresh registers, then one fp32
    // add into the accumulators (see the header)
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      float dr[NI][4], di[NI][4];
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dr[j][e] = di[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDepth / 4; ++kk) {
        uint32_t bb[NI][2], bsm[NI][2];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float2 v = bs[(4 * kk + t) * BN + bcol[j]];
          split(v.x, bb[j][0], bsm[j][0]);
          split(v.y, bb[j][1], bsm[j][1]);
        }
        const float2 u0 = as[(wm0 + 16 * i + g) * kDepth + acol[kk]];
        const float2 u1 = as[(wm0 + 16 * i + g + 8) * kDepth + acol[kk]];
        uint32_t ab[4], asm_[4];
        split(u0.x, ab[0], asm_[0]);
        split(u1.x, ab[1], asm_[1]);
        split(u0.y, ab[2], asm_[2]);
        split(u1.y, ab[3], asm_[3]);
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma(dr[j], asm_, bb[j][0], bb[j][1] ^ kSign);
          mma(di[j], asm_, bb[j][1], bb[j][0]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma(dr[j], ab, bsm[j][0], bsm[j][1] ^ kSign);
          mma(di[j], ab, bsm[j][1], bsm[j][0]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma(dr[j], ab, bb[j][0], bb[j][1] ^ kSign);
          mma(di[j], ab, bb[j][1], bb[j][0]);
        }
      }
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accr[i][j][e] += dr[j][e];
          acci[i][j][e] += di[j][e];
        }
    }
  }
  cp_wait<0>();

  // the epilogue, a 16-row block at a time: its C values are all loaded
  // before any is used, so their latencies overlap
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float4 old[2][NI];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int r = row0 + wm0 + 16 * i + g + 8 * h;
        const int c = col0 + wn0 + 8 * j + 2 * t;
        old[h][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (beta_zero || r >= M || c >= N) continue;
        const float2* p = C + r * ldc + c;
        if (V16 && c + 1 < N) {
          old[h][j] = *reinterpret_cast<const float4*>(p);
        } else {
          const float2 o0 = p[0];
          const float2 o1 = c + 1 < N ? p[1] : make_float2(0.f, 0.f);
          old[h][j] = make_float4(o0.x, o0.y, o1.x, o1.y);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int r = row0 + wm0 + 16 * i + g + 8 * h;
        const int c = col0 + wn0 + 8 * j + 2 * t;
        if (r >= M || c >= N) continue;
        const float xr0 = accr[i][j][2 * h], xi0 = acci[i][j][2 * h];
        const float xr1 = accr[i][j][2 * h + 1], xi1 = acci[i][j][2 * h + 1];
        const float4 o = old[h][j];
        float4 out = make_float4(alpha_re * xr0 - alpha_im * xi0,
                                 alpha_re * xi0 + alpha_im * xr0,
                                 alpha_re * xr1 - alpha_im * xi1,
                                 alpha_re * xi1 + alpha_im * xr1);
        if (!beta_zero) {
          out.x += beta_re * o.x - beta_im * o.y;
          out.y += beta_re * o.y + beta_im * o.x;
          out.z += beta_re * o.z - beta_im * o.w;
          out.w += beta_re * o.w + beta_im * o.z;
        }
        float2* p = C + r * ldc + c;
        if (V16 && c + 1 < N) {
          *reinterpret_cast<float4*>(p) = out;
        } else {
          p[0] = make_float2(out.x, out.y);
          if (c + 1 < N) p[1] = make_float2(out.z, out.w);
        }
      }
  }
}

using KernelFn = void (*)(const float2*, const float2*, float2*, int, int, int, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t, float, float,
                          float, float, int, int);

constexpr size_t kSmemBytes =
    static_cast<size_t>(kStages) * (kBM + kBN) * kDepth * sizeof(float2);

KernelFn pick(int width) {
  return width == 16 ? cgemm_tc_kernel<true> : cgemm_tc_kernel<false>;
}

bool even(long long v) { return (v & 1) == 0; }

// 16-byte copies need every base 16-byte aligned and every row and batch
// stride even in complex64 elements.
int width_of(const void* A, const void* B, const void* C, long long lda, long long ldb,
             long long ldc, long long sA, long long sB, long long sC) {
  const bool ok = (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B) |
                   reinterpret_cast<uintptr_t>(C)) % 16 == 0 &&
                  even(lda) && even(ldb) && even(ldc) && even(sA) && even(sB) &&
                  even(sC);
  return ok ? 16 : 8;
}

constexpr int kMaxDevices = 64;
std::atomic<bool> g_prepared[2][kMaxDevices];   // [width == 16][device]

// Lets the kernel for `width` take kSmemBytes of dynamic shared memory on the
// current device: once a device (the attribute is the device's), so the LU's
// many small updates pay no host call for it.
int prepare(int width) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::atomic<bool>* done = dev < kMaxDevices ? &g_prepared[width == 16][dev] : nullptr;
  if (done != nullptr && done->load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(pick(width)),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes));
  if (e == cudaSuccess && done != nullptr) done->store(true, std::memory_order_release);
  return static_cast<int>(e);
}

}  // namespace

// C = beta·C + alpha·A·B in complex64 on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidConfiguration for more tiles or batch
// entries than the grid holds. Copies are 16 bytes where width_of allows,
// else 8. Strides in elements; C must not overlap A or B; M, N, batch >= 1,
// K >= 0.
extern "C" int maus_cgemm_tc(const void* A, const void* B, void* C, int batch, int M,
                             int N, int K, long long lda, long long ldb, long long ldc,
                             long long sA, long long sB, long long sC, double alpha_re,
                             double alpha_im, double beta_re, double beta_im,
                             void* stream) {
  const long long tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = (M + kBM - 1) / kBM * tiles_n;
  if (tiles > 0x7fffffffLL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int width = width_of(A, B, C, lda, ldb, ldc, sA, sB, sC);
  int err = prepare(width);
  if (err != 0) return err;
  const int beta_zero = (beta_re == 0.0 && beta_im == 0.0) ? 1 : 0;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  pick(width)<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(A), static_cast<const float2*>(B),
      static_cast<float2*>(C), M, N, K, lda, ldb, ldc, sA, sB, sC,
      static_cast<float>(alpha_re), static_cast<float>(alpha_im),
      static_cast<float>(beta_re), static_cast<float>(beta_im), beta_zero,
      static_cast<int>(tiles_n));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = registers a thread, local (spilled) bytes a thread, CTAs a SM
// by cudaOccupancyMaxActiveBlocksPerMultiprocessor, dynamic shared bytes a
// CTA; of the kernel for `width` (16 or 8).
extern "C" int maus_cgemm_tc_attrs(int width, int* out) {
  if (width != 8 && width != 16) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = pick(width);
  int err = prepare(width);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(fn), kThreads, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(kSmemBytes);
  return 0;
}
