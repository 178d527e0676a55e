// Batched solve against packed LU factors (kernel LS): x = U⁻¹·L⁻¹·P·B for K
// matrices at once, each with R = 1 or 2 right-hand-side columns, on the
// factors that maus_lu_factor (csrc/lu.cu) leaves: row-major (K, N, N),
// L unit lower below the diagonal, U on and above it, and piv the N
// sequential 1-based row interchanges (torch.linalg.lu_factor's layout).
// The Python wrapper is maus_tpu_torch/ops/kernels/lu_solve.py.
//
// Replaces no TPU kernel: the JAX package solves against its LU factors with
// jax.scipy.linalg.lu_solve, a library call. It was added because cuBLAS's
// triangular solves (torch.linalg.lu_solve → trsv), which the eig finisher
// (ops/refine_eig.py) ran two to a Newton step, took ≈ 3.2 ms a solve at
// (K, N) = (8, 4096) complex64, about ten times the time of reading the
// factors once, and their row-major factors first needed the pivots unpacked
// and a layout of their own.
//
// What bounds it on an H100:
//   - bytes: each factor read once, K·N²·itemsize: 1.07 GB at (8, 4096)
//     complex64 and at (4, 4096) complex128, 0.320 ms at 3.35 TB/s; the
//     right-hand sides and solutions are K·N·R·itemsize, nothing beside it;
//   - latency: the substitution is a chain. Row block i of the forward
//     solve needs the solution of every block above it, and the back
//     substitution starts from the last row, so a matrix's 2·⌈N/64⌉
//     diagonal-block solves run one after another (128 at N = 4096), each
//     64 dependent steps plus the hand-over of a block from CTA to CTA.
// One launch does both halves of the K matrices:
//   - Tasks. Every (matrix, row block) of the forward solve, then of the
//     back substitution, is a task of one CTA. CTAs take tickets from one
//     atomic counter, ticket g being task g / K of matrix g % K, so a task
//     only ever waits on tasks with lower tickets, which CTAs already
//     running hold: no deadlock whatever the residency, and the matrices
//     advance together.
//   - The strip. A forward task streams its strip L[r0:r0+64, 0:r0] once,
//     a back task U[r0:r0+64, r0+64:N], the 64-column block that became
//     ready first first: each warp holds 8 rows, each lane two columns of a
//     block, 16 independent loads in flight a lane, the loads issued before
//     the warp waits for the block's solution. A warp polls a per-matrix
//     progress count (acquire at GPU scope, by lane 0) only when it reaches
//     a block it has not yet seen published, so far from the chain's head
//     it streams without waiting. With R = 2 each loaded element serves both
//     columns, so a Newton step's two solves read the factors once.
//   - The diagonal block. Loaded into shared memory (row stride 65, so that
//     a warp's column read is free of bank conflicts) when the task starts,
//     off the chain. After the strip, a reduce-scatter of the warps' partial
//     sums (31 shuffles a warp) and one barrier, warp c solves column c of
//     the block: a lane owns rows lane and lane + 32, and each of the 64
//     steps is one shuffle and one complex multiply-add, the same loop
//     upward for U: its columns come scaled by the reciprocal diagonal
//     (Smith's division, so a tiny pivot does not overflow its square), and
//     a row is divided by its pivot when it is written. The right-hand
//     sides are in the solving warps' registers before the strip's last
//     block arrives (a forward task gathers them when it starts, a back task
//     once the first back block is published, which implies the whole
//     forward solve), so nothing but the strip's last block, its sums and
//     the block solve lies on the chain.
//   - The hand-over. The solving warps write the block's solution, and
//     thread 0, after their barrier, stores the matrix's new progress count
//     with release semantics (cumulative: it orders the warps' stores).
//     Solutions are read through L2 (ld.global.cg), never from a stale L1
//     line. A wait that is not met after 2^24 polls traps rather than hangs.
// Pivots: maus_lu_perm turns piv into the permutation perm (P·B)[r] =
// B[perm[r]] once per factorization (one CTA a matrix, the swaps in shared
// memory), and a forward task gathers its right-hand sides through it.
// A zero on U's diagonal makes its reciprocal non-finite, so that matrix's
// solution comes back non-finite and the others' are untouched.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNB = 64;                 // rows of a task, columns of a strip block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kNB / kWarps;
constexpr int kLd = kNB + 1;            // the diagonal block's row stride in smem
constexpr long long kMaxPolls = 1LL << 24;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPermThreads = 256;
constexpr size_t kSmemLimit = 227 * 1024;

template <typename R>
struct __align__(2 * sizeof(R)) cx {
  R re, im;
};

template <typename R>
struct vec2;
template <>
struct vec2<float> {
  using type = float2;
};
template <>
struct vec2<double> {
  using type = double2;
};

template <typename R>
__device__ __forceinline__ cx<R> mk(R re, R im) {
  cx<R> z;
  z.re = re;
  z.im = im;
  return z;
}

// a factor element, streamed: read once, evicted first
template <typename R>
__device__ __forceinline__ cx<R> ld_stream(const cx<R>* p) {
  const typename vec2<R>::type v = __ldcs(reinterpret_cast<const typename vec2<R>::type*>(p));
  return mk(v.x, v.y);
}

// a solution element another CTA published: through L2, never a stale L1 line
template <typename R>
__device__ __forceinline__ cx<R> ld_l2(const cx<R>* p) {
  const typename vec2<R>::type v = __ldcg(reinterpret_cast<const typename vec2<R>::type*>(p));
  return mk(v.x, v.y);
}

// acc + a·x
template <typename R>
__device__ __forceinline__ cx<R> fma_c(cx<R> acc, cx<R> a, cx<R> x) {
  return mk(fma(a.re, x.re, fma(-a.im, x.im, acc.re)),
            fma(a.re, x.im, fma(a.im, x.re, acc.im)));
}

// acc − a·x
template <typename R>
__device__ __forceinline__ cx<R> fms_c(cx<R> acc, cx<R> a, cx<R> x) {
  return mk(fma(-a.re, x.re, fma(a.im, x.im, acc.re)),
            fma(-a.re, x.im, fma(-a.im, x.re, acc.im)));
}

template <typename R>
__device__ __forceinline__ cx<R> mul_c(cx<R> a, cx<R> b) {
  return mk(fma(a.re, b.re, -(a.im * b.im)), fma(a.re, b.im, a.im * b.re));
}

// 1/d by Smith's division; non-finite for d = 0
template <typename R>
__device__ __forceinline__ cx<R> recip(cx<R> d) {
  if (fabs(d.re) >= fabs(d.im)) {
    const R t = d.im / d.re;
    const R den = fma(d.im, t, d.re);
    return mk(R(1) / den, -t / den);
  }
  const R t = d.re / d.im;
  const R den = fma(d.re, t, d.im);
  return mk(t / den, R(-1) / den);
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// lane 0 of the warp polls *flag until it reaches `need`; the warp gets the
// value seen. Traps after kMaxPolls polls.
__device__ __forceinline__ int warp_wait(const int* flag, int need, int lane) {
  int v = 0;
  if (lane == 0) {
    v = ld_acquire_gpu(flag);
    for (long long i = 0; v < need; ++i) {
      if (i == kMaxPolls) __trap();
      v = ld_acquire_gpu(flag);
    }
  }
  v = __shfl_sync(kFull, v, 0);
  __syncwarp();
  return v;
}

// Reduce-scatter of the warp's NV partial sums: lane l returns the warp's
// total of v[l % NV] (NV a power of two <= 32). The lanes are combined
// across bit 4 of the lane index first and bit 0 last whatever NV is, so a
// column's sum is the same to the bit at R = 1 and R = 2; 31 shuffles.
template <typename R, int NV>
__device__ __forceinline__ R reduce_scatter(R (&v)[NV], int lane) {
#pragma unroll
  for (int o = 16; o >= NV; o /= 2)
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] += __shfl_xor_sync(kFull, v[j], o);
#pragma unroll
  for (int h = NV / 2; h >= 1; h /= 2) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const R send = upper ? v[j] : v[j + h];
      const R keep = upper ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

template <typename R, int NRHS>
size_t solve_smem_bytes() {
  // the diagonal block, U's reciprocal diagonal, the reduced strip sums
  return sizeof(cx<R>) * (static_cast<size_t>(kNB) * kLd + kNB + kNB * NRHS);
}

// sync: [0] the ticket counter, [1 + k] matrix k's published forward blocks,
// [1 + K + k] its published back blocks (from the bottom); zero at launch.
template <typename R, int NRHS>
__global__ void __launch_bounds__(kThreads, sizeof(R) == 4 ? 2 : 1)
lu_solve_kernel(const cx<R>* __restrict__ LU, const int* __restrict__ perm,
                const cx<R>* __restrict__ B, cx<R>* Y, cx<R>* X, int* sync, int K,
                int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cx<R>* D = reinterpret_cast<cx<R>*>(smem_raw);
  cx<R>* rinv = D + kNB * kLd;
  R* red = reinterpret_cast<R*>(rinv + kNB);
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int nblk = (N + kNB - 1) / kNB;
  const int k = ticket % K;
  const int task = ticket / K;
  const bool back = task >= nblk;
  const int i = back ? 2 * nblk - 1 - task : task;     // the row block
  const int r0 = i * kNB;
  const int rows = min(kNB, N - r0);
  const size_t mat = static_cast<size_t>(k) * N * N;
  const cx<R>* A = LU + mat;
  const cx<R> zero = mk(R(0), R(0));
  int* fwd = sync + 1 + k;
  int* bwd = sync + 1 + K + k;

  // U's reciprocal diagonal for a back task, then the diagonal block, off the
  // chain: L's strictly lower part for a forward task, U's strictly upper
  // part with column j scaled by 1/u_jj for a back task
  if (back && tid < kNB) {
    const bool in = tid < rows;
    rinv[tid] = in ? recip(ld_stream(A + static_cast<size_t>(r0 + tid) * N + r0 + tid))
                   : zero;
  }
  __syncthreads();
  for (int idx = tid; idx < kNB * kNB; idx += kThreads) {
    const int rr = idx / kNB;
    const int cc = idx - rr * kNB;
    const bool keep = rr < rows && cc < rows && (back ? cc > rr : cc < rr);
    cx<R> a = zero;
    if (keep) {
      a = ld_stream(A + static_cast<size_t>(r0 + rr) * N + r0 + cc);
      if (back) a = mul_c(a, rinv[cc]);
    }
    D[rr * kLd + cc] = a;
  }

  // warp c < R solves column c of the diagonal block. Its right-hand side,
  // lane l holding rows l and l + 32: a forward task's gathered through
  // perm now; a back task's (the forward solution) once the forward solve
  // is complete, which the first published back block implies
  const bool solver = warp < NRHS;
  cx<R> bv[2];
  auto load_rhs = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = lane + 32 * h;
      const size_t at = static_cast<size_t>(k) * N +
                        (rr >= rows ? 0 : back ? r0 + rr
                                               : perm[static_cast<size_t>(k) * N + r0 + rr]);
      bv[h] = rr >= rows ? zero : back ? ld_l2(Y + at * NRHS + warp) : B[at * NRHS + warp];
    }
  };
  if (solver && !back) load_rhs();

  // the strip: forward blocks 0 .. i−1, or back blocks nblk−1 down to i+1
  const int nstrip = back ? nblk - 1 - i : i;
  const int* flag = back ? bwd : fwd;
  const cx<R>* src = back ? X : Y;
  cx<R> acc[kRowsPerWarp][NRHS];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int c = 0; c < NRHS; ++c) acc[q][c] = zero;
  int known = 0;
  for (int t = 0; t < nstrip; ++t) {
    const int c0 = (back ? nblk - 1 - t : t) * kNB;
    cx<R> a[kRowsPerWarp][2];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int rr = warp + kWarps * q;
      const cx<R>* row = A + static_cast<size_t>(r0 + rr) * N + c0 + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[q][h] = (rr < rows && c0 + lane + 32 * h < N) ? ld_stream(row + 32 * h) : zero;
    }
    if (t >= known) {
      known = warp_wait(flag, t + 1, lane);
      if (back && t == 0 && solver) load_rhs();
    }
    cx<R> xv[2][NRHS];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + lane + 32 * h;
#pragma unroll
      for (int c = 0; c < NRHS; ++c)
        xv[h][c] = col < N ? ld_l2(src + (static_cast<size_t>(k) * N + col) * NRHS + c)
                           : zero;
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
      for (int c = 0; c < NRHS; ++c)
        acc[q][c] = fma_c(fma_c(acc[q][c], a[q][0], xv[0][c]), a[q][1], xv[1][c]);
  }

  // the warp's row sums, lane l holding value l of (row q, column c, re/im)
  {
    constexpr int NV = kRowsPerWarp * NRHS * 2;
    R v[NV];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
      for (int c = 0; c < NRHS; ++c) {
        v[(q * NRHS + c) * 2] = acc[q][c].re;
        v[(q * NRHS + c) * 2 + 1] = acc[q][c].im;
      }
    const R tot = reduce_scatter<R, NV>(v, lane);
    if (lane < NV) {
      const int q = lane / (2 * NRHS);
      const int rest = lane - q * 2 * NRHS;
      red[((warp + kWarps * q) * NRHS) * 2 + rest] = tot;
    }
  }
  __syncthreads();
  if (!solver) return;

  // the right-hand side less the strip, then the diagonal block by
  // substitution, downward for L and upward for U: at step j, row j is
  // final and every other row takes off its multiple of it (the rows it
  // does not feed hold a 0 there); U's rows are divided by their diagonal
  // at the end
  const int c = warp;
  if (back && nstrip == 0) {
    warp_wait(fwd, i + 1, lane);
    load_rhs();
  }
  cx<R> v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const R* s = red + ((lane + 32 * h) * NRHS + c) * 2;
    v[h] = mk(bv[h].re - s[0], bv[h].im - s[1]);
  }
  const cx<R>* D0 = D + lane * kLd;
  const cx<R>* D1 = D + (lane + 32) * kLd;
#pragma unroll 4
  for (int step = 0; step < rows; ++step) {
    const int j = back ? rows - 1 - step : step;
    const int owner = j & 31;
    const cx<R> s = j < 32 ? v[0] : v[1];
    const cx<R> xj = mk(__shfl_sync(kFull, s.re, owner), __shfl_sync(kFull, s.im, owner));
    v[0] = fms_c(v[0], D0[j], xj);
    v[1] = fms_c(v[1], D1[j], xj);
  }
  cx<R>* dst = back ? X : Y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = lane + 32 * h;
    if (rr < rows)
      dst[(static_cast<size_t>(k) * N + r0 + rr) * NRHS + c] =
          back ? mul_c(v[h], rinv[rr]) : v[h];
  }
  // the hand-over: the solving warps' stores, their barrier, then the
  // release, which orders every store the barrier made visible to thread 0
  asm volatile("bar.sync 1, %0;" ::"r"(NRHS * 32) : "memory");
  if (tid == 0) st_release_gpu(back ? bwd : fwd, back ? nblk - i : i + 1);
}

// perm[k] from the sequential interchanges piv[k] (1-based), one CTA a
// matrix: thread 0 applies the N swaps to an index array in shared memory
// (in global memory where N ints do not fit a CTA).
__global__ void __launch_bounds__(kPermThreads)
lu_perm_kernel(const int* __restrict__ piv, int* __restrict__ perm, int N, int in_smem) {
  extern __shared__ int sp[];
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  int* P = in_smem ? sp : perm + off;
  for (int t = threadIdx.x; t < N; t += blockDim.x) P[t] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* pv = piv + off;
#pragma unroll 8
    for (int r = 0; r < N; ++r) {
      const int p = pv[r] - 1;
      const int a = P[r];
      P[r] = P[p];
      P[p] = a;
    }
  }
  __syncthreads();
  if (in_smem)
    for (int t = threadIdx.x; t < N; t += blockDim.x) perm[off + t] = P[t];
}

template <typename R, int NRHS>
int launch_solve(const void* LU, const void* perm, const void* B, void* Y, void* X,
                 void* sync, int K, int N, cudaStream_t st) {
  const size_t smem = solve_smem_bytes<R, NRHS>();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(lu_solve_kernel<R, NRHS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tasks = 2LL * K * ((N + kNB - 1) / kNB);
  if (K < 1 || N < 1 || tasks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  lu_solve_kernel<R, NRHS><<<static_cast<unsigned>(tasks), kThreads, smem, st>>>(
      static_cast<const cx<R>*>(LU), static_cast<const int*>(perm),
      static_cast<const cx<R>*>(B), static_cast<cx<R>*>(Y), static_cast<cx<R>*>(X),
      static_cast<int*>(sync), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream`, allocates nothing and returns cudaGetLastError()
// (0 on success).

// perm (K, N) int32 from piv (K, N) int32, 1-based sequential interchanges.
extern "C" int maus_lu_perm(const void* piv, void* perm, int K, int N, void* stream) {
  if (K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = static_cast<size_t>(N) * sizeof(int);
  const int in_smem = need <= kSmemLimit;
  const size_t smem = in_smem ? need : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lu_perm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lu_perm_kernel<<<K, kPermThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(piv), static_cast<int*>(perm), N, in_smem);
  return static_cast<int>(cudaGetLastError());
}

// X = U⁻¹·L⁻¹·B[perm] for LU (K, N, N) contiguous, complex64 (is_c128 = 0) or
// complex128 (1); B, Y (scratch: the forward solution) and X are (K, N, R)
// with R = 1 or 2; sync is 1 + 2·K int32, zero.
extern "C" int maus_lu_solve(const void* LU, const void* perm, const void* B, void* Y,
                             void* X, void* sync, int is_c128, int K, int N, int R,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 1)
    return is_c128 ? launch_solve<double, 1>(LU, perm, B, Y, X, sync, K, N, st)
                   : launch_solve<float, 1>(LU, perm, B, Y, X, sync, K, N, st);
  if (R == 2)
    return is_c128 ? launch_solve<double, 2>(LU, perm, B, Y, X, sync, K, N, st)
                   : launch_solve<float, 2>(LU, perm, B, Y, X, sync, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
