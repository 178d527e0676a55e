// Batched shifted upper-Hessenberg solve (kernel K2), the bottom-up RQ sweep
// fused with the back substitution:
//   (H + s_k I) w_k = b_k   for k = 0..K-1, one shared upper-Hessenberg H.
//
// Replaces maus_tpu/ops/pallas/hess_solve.py:158, hess_solve_batched_pallas
// (the TPU kernel behind every shifted solve of the non-Hermitian eig path,
// through maus_tpu/ops/hessenberg.py::solve_shifted_hessenberg). Same
// function and contract: complex Givens rotations c = |a|/r,
// s = sign(a)·conj(b)/r with r = sqrt(|a|² + |b|²) and the identity rotation
// when b = 0, and an exact-zero diagonal of the triangular
// factor gives inf in that row (the Ψ ladder upstream reads non-finite rows as
// failed solves). Any N >= 1, any K >= 1, complex64 or complex128.
//
// Algorithm. With M = H + sI, column rotations G_k on columns (k-1, k), for
// k = N-1 down to 1, zero M's subdiagonal from the bottom: M·G_{N-1}⋯G_1 = R,
// upper triangular. The working matrix differs from M in one column only,
// the carried column `car` (rows 0..k), so a step needs M's fresh column k-1
// and nothing else: (c, s) = givens(car[k], M[k, k-1]); R's column k,
// c·car + s·fresh, is final, so R z = b is solved for z_k at once
// (z_k = (b_k - acc_k) / R[k, k]) and R[:k, k]·z_k is added to the partial
// sums `acc`; car <- -conj(s)·car + c·fresh. R is never stored and b is never
// rotated. At the end w = G_{N-1}⋯G_1 z, a chain of 2×2 rotations: a linear
// recurrence t_k = -conj(s_k)·t_{k-1} + c_k·z_k, w_{k-1} = c_k·t_{k-1} +
// s_k·z_k, which one block runs as a scan of affine maps (chunks of N/T per
// thread, a Hillis–Steele scan of the T chunk maps in shared memory).
//
// Operands: Ht (N, N), the transpose of H (row j of Ht is column j of H; the
// wrapper makes it, so that a step reads its column coalesced); shifts (K,);
// B, W (K, N); SZ (K, 2, N): per candidate the rotations' s, then z; C (K, N)
// of the real type: the rotations' c; spill: null, or (K, N - T·RPT, 2) for
// the state of the rows past the register fit (see below).
//
// Bound: at the eig slice shape (K = 32, N = 4096, complex64) the function
// reads H's upper Hessenberg part once (67 MB) and B, and writes W; ~14·N²
// flops a candidate, 7.5 GFLOP in all, 0.112 ms at the FP32 peak. The real
// limit is the chain: N dependent steps a candidate, each a pivot (the
// rotation, R[k, k] and z_k) and a block barrier, on K of the 132 SMs; and
// a step's rows (~16 FMAs each) all run on one SM, in the same warps'
// instruction slots as the chain. The latency floor (the chain with no row
// work) is measured by maus_hess_rq_step_floor below.
//
// Design. One block of T threads per candidate. Thread t owns rows t, t+T,
// t+2T, ... (so a column read is coalesced); the first T·RPT rows keep car,
// acc and two fresh columns in registers (RPT rows a thread, a template
// parameter), the rows past that keep car and acc in shared memory when they
// fit beside the scan's 2T elements, else in the global spill scratch; the
// wrapper picks the home by shape. In step k the owner of row k-1 rotates
// that row first and computes step k-1's pivot from it, writes it to a
// double-buffered shared slot and to the scratch, while the other warps
// rotate their rows; after one __syncthreads every thread reads it. The
// pivot is divide-free (two rsqrt, see pivot() below), and its other
// inputs (M[k-1, k-2], b_{k-1}, M[k-1, k-1]) come from a queue in shared
// memory that warp 0 fills a chunk of kQ steps ahead, so no global load
// lies on the chain. Each step starts the next column's loads into the
// register set the step after next reads (the loop alternates two sets)
// and an L2 prefetch kDist columns ahead. A thread's rows go in groups of
// four: one branch skips a finished group, the rows of a group are one
// predicated block. One barrier a step; the call's scratch is O(K·N).
// Offsets into Ht, B, W and the scratch are 64-bit.

#include "hess_common.cuh"

namespace {

using namespace maus;

// columns ahead of the current step that are prefetched into L2
constexpr int kDist = 8;
// the pivots' inputs are staged through shared memory in chunks of kQ steps
constexpr int kQ = 32;

template <typename R>
__device__ __forceinline__ bool nonzero(cx<R> a) {
  return a.re != R(0) || a.im != R(0);
}

template <typename R>
__device__ __forceinline__ void prefetch_l2(const cx<R>* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One step's update of a row: R[i, k] = c·o + s·f is final, acc += R[i, k]·z,
// and the carried column's new entry is -conj(s)·o + c·f (ms = -conj(s)).
template <typename R>
__device__ __forceinline__ void rotate_row(cx<R>& car, cx<R>& acc, cx<R> f,
                                           R c, cx<R> s, cx<R> ms, cx<R> z) {
  const cx<R> o = car;
  const cx<R> rik = add(scale(c, o), mul(s, f));
  acc = add(acc, mul(rik, z));
  car = add(mul(ms, o), scale(c, f));
}

// A step's pivot, divide-free: the rotation zeroing h = M[k, k-1] against
// the carried entry a = car[k] and z_k = (b_k - acc_k) / R[k, k]. With
// ia = rsqrt(|a|²), ir = rsqrt(|a|² + |h|²) and sign(a) = a·ia (1 where
// |a|² <= tiny): c = |a|²·ia·ir = |a|/r, s = sign(a)·conj(h)·ir (the
// rotation of givens() in hess_common.cuh, identity where h = 0), R[k, k] =
// sign(a)·r, so z_k = (b_k - acc_k)·conj(sign(a))·ir; inf where
// |a|² + |h|² = 0 (R[k, k] exactly zero). With h = 0 (k = 0) this is
// z_0 = (b_0 - acc_0) / a (for |a|² > tiny). The chain is two rsqrt and a few
// multiplies: no division, no hypot.
template <typename R>
__device__ __forceinline__ void pivot(cx<R> a, cx<R> acck, cx<R> h, cx<R> bk,
                                      R& c, cx<R>& s, cx<R>& z) {
  const R a2 = a.re * a.re + a.im * a.im;
  const R h2 = h.re * h.re + h.im * h.im;
  const R r2 = a2 + h2;
  const R ir = rrsqrt(rmax(r2, tiny<R>()));
  const R ia = rrsqrt(rmax(a2, tiny<R>()));
  const cx<R> sg = a2 > tiny<R>() ? scale(ia, a) : mk(R(1), R(0));
  c = h2 > R(0) ? a2 * ia * ir : R(1);
  s = scale(ir, mul(sg, conj(h)));
  z = r2 > R(0) ? scale(ir, mul(sub(bk, acck), conj(sg)))
                : mk(rinf(R(0)), R(0));
}

// The pivot of step k as the next step reads it: c, s and z_k.
template <typename R>
struct Pivot {
  cx<R> s, z;
  R c;
};

template <typename R, int T, int RPT>
__global__ void __launch_bounds__(T)
hess_solve_rq_kernel(const cx<R>* __restrict__ Ht, const cx<R>* __restrict__ shifts,
                     const cx<R>* __restrict__ B, cx<R>* __restrict__ W,
                     cx<R>* __restrict__ SZ, R* __restrict__ Cs,
                     cx<R>* __restrict__ gspill, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cx<R>* scan = reinterpret_cast<cx<R>*>(smem_raw);  // 2·T: the rotation scan
  __shared__ Pivot<R> slot[2];                        // step k's pivot at k & 1
  const int t = threadIdx.x;
  const size_t kb = blockIdx.x;
  const size_t n = static_cast<size_t>(N);
  constexpr int kReg = T * RPT;
  // a thread's rows go in groups of kGroup: one branch skips a finished
  // group, and a group's rows are one predicated block the compiler
  // interleaves
  constexpr int kGroup = RPT < 4 ? RPT : 4;
  const int nr = N < kReg ? N : kReg;
  // rows [nr, N): (car, acc) interleaved, in shared memory after the scan
  // area or in the global scratch
  cx<R>* __restrict__ spill =
      gspill != nullptr ? gspill + kb * 2 * (n - nr) : scan + 2 * T;
  const cx<R> sh = shifts[kb];
  const cx<R>* __restrict__ b = B + kb * n;
  cx<R>* __restrict__ w = W + kb * n;
  cx<R>* __restrict__ S = SZ + kb * 2 * n;
  cx<R>* __restrict__ Z = S + n;
  R* __restrict__ C = Cs + kb * n;
  const cx<R> zero = mk(R(0), R(0));

  // the pivots' other inputs, staged through shared memory in chunks of kQ
  // (index j: M[j, j-1], b_j and H[j, j]); lane l of warp 0 holds
  // index kQ·c + l of the chunk c after the one in use, loaded a chunk ahead
  __shared__ cx<R> qh[2][kQ], qb[2][kQ], qd[2][kQ];
  cx<R> ph = zero, pb = zero, pd = zero;
  auto fetch = [&](int j) {
    ph = zero;
    pb = zero;
    pd = zero;
    if (j >= 0 && j < N) {
      if (j >= 1) ph = Ht[static_cast<size_t>(j - 1) * n + j];
      pb = b[j];
      pd = Ht[static_cast<size_t>(j) * n + j];
    }
  };

  // the carried column starts as M's column N-1
  cx<R> car[RPT], acc[RPT], fa[RPT], fb[RPT];
  {
    const cx<R>* col = Ht + (n - 1) * n;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = t + r * T;
      cx<R> v = zero;
      if (i < N) v = col[i];
      if (i == N - 1) v = add(v, sh);
      car[r] = v;
      acc[r] = zero;
      fa[r] = zero;
      fb[r] = zero;
    }
    for (int i = nr + t; i < N; i += T) {
      cx<R> v = col[i];
      if (i == N - 1) v = add(v, sh);
      spill[2 * (i - nr)] = v;
      spill[2 * (i - nr) + 1] = zero;
    }
  }
  // step N-1's fresh column N-2, the queue's first chunk, and step N-1's
  // pivot (thread 0)
  if (N >= 2) {
    const cx<R>* col = Ht + (n - 2) * n;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = t + r * T;
      if (i < N - 1) fa[r] = col[i];
    }
    const int c0 = (N - 2) / kQ;
    if (t < kQ) {
      fetch(c0 * kQ + t);
      qh[c0 & 1][t] = ph;
      qb[c0 & 1][t] = pb;
      qd[c0 & 1][t] = pd;
      fetch((c0 - 1) * kQ + t);
    }
  }
  if (t == 0) {
    Pivot<R> p;
    pivot(add(Ht[(n - 1) * n + n - 1], sh), zero,
          N >= 2 ? Ht[(n - 2) * n + n - 1] : zero, b[N - 1], p.c, p.s, p.z);
    slot[(N - 1) & 1] = p;
    C[N - 1] = p.c;
    S[N - 1] = p.s;
    Z[N - 1] = p.z;
  }
  __syncthreads();

  // Step k: rotate rows < k by step k's pivot, the owner of row k-1 first,
  // which then computes step k-1's pivot while the other warps rotate their
  // rows. `fr` holds H's column k-1 (rows < k; the shift goes on the
  // owner's diagonal entry alone), `nx` receives column k-2; the loop
  // alternates the two, so a load lands during a whole step and barrier.
  auto step = [&](const int k, cx<R>(&fr)[RPT], cx<R>(&nx)[RPT]) {
    const int km = k - 1;
    if (k >= 2) {
      const cx<R>* col = Ht + static_cast<size_t>(k - 2) * n;
#pragma unroll
      for (int g = 0; g < RPT; g += kGroup) {
        if (t + g * T >= km) break;
#pragma unroll
        for (int r = g; r < g + kGroup; ++r)
          if (t + r * T < km) nx[r] = col[t + r * T];
      }
      if (k - 2 - kDist >= 0) {
        constexpr int kLine = 128 / static_cast<int>(sizeof(cx<R>));
        const cx<R>* pc = Ht + static_cast<size_t>(k - 2 - kDist) * n;
        for (int i = t * kLine; i <= k - 1 - kDist; i += T * kLine)
          prefetch_l2(pc + i);
      }
    }
    const Pivot<R> p = slot[k & 1];
    const cx<R> ms = mk(-p.s.re, p.s.im);  // -conj(s)
    const int qc = (km / kQ) & 1, qi = km % kQ;
    if (km < nr) {
      if (t == km % T) {
        // the row's registers by selects (a runtime index would put the
        // arrays in local memory); its fresh entry is M's diagonal
        const int ro = km / T;
        cx<R> oc = car[0], oa = acc[0], of = fr[0];
#pragma unroll
        for (int r = 1; r < RPT; ++r) {
          if (r == ro) {
            oc = car[r];
            oa = acc[r];
            of = fr[r];
          }
        }
        rotate_row(oc, oa, add(of, sh), p.c, p.s, ms, p.z);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (r == ro) {
            car[r] = oc;
            acc[r] = oa;
          }
        }
        Pivot<R> q;
        pivot(oc, oa, qh[qc][qi], qb[qc][qi], q.c, q.s, q.z);
        slot[km & 1] = q;
        C[km] = q.c;
        S[km] = q.s;
        Z[km] = q.z;
      }
    } else if (t == (km - nr) % T) {
      cx<R> cr = spill[2 * (km - nr)];
      cx<R> ac = spill[2 * (km - nr) + 1];
      rotate_row(cr, ac, add(qd[qc][qi], sh), p.c, p.s, ms, p.z);
      Pivot<R> q;
      pivot(cr, ac, qh[qc][qi], qb[qc][qi], q.c, q.s, q.z);
      slot[km & 1] = q;
      C[km] = q.c;
      S[km] = q.s;
      Z[km] = q.z;
    }
#pragma unroll
    for (int g = 0; g < RPT; g += kGroup) {
      if (t + g * T >= km) break;
#pragma unroll
      for (int r = g; r < g + kGroup; ++r)
        if (t + r * T < km) rotate_row(car[r], acc[r], fr[r], p.c, p.s, ms, p.z);
    }
    if (km > nr) {
      const cx<R>* col = Ht + static_cast<size_t>(km) * n;
#pragma unroll 4
      for (int i = nr + t; i < km; i += T) {
        cx<R> cr = spill[2 * (i - nr)];
        cx<R> ac = spill[2 * (i - nr) + 1];
        rotate_row(cr, ac, col[i], p.c, p.s, ms, p.z);
        spill[2 * (i - nr)] = cr;
        spill[2 * (i - nr) + 1] = ac;
      }
    }
    // the next step's pivot index km - 1 starts a new chunk: move the
    // prefetched chunk into its buffer and fetch the one after it
    if (qi == 0 && km > 0 && t < kQ) {
      const int c = km / kQ - 1;
      qh[c & 1][t] = ph;
      qb[c & 1][t] = pb;
      qd[c & 1][t] = pd;
      fetch((c - 1) * kQ + t);
    }
    __syncthreads();
  };
  int k = N - 1;
  for (; k >= 2; k -= 2) {
    step(k, fa, fb);
    step(k - 1, fb, fa);
  }
  if (k == 1) step(1, fa, fb);

  // ---- w = G_{N-1}⋯G_1 z: the recurrence t_k = α_k t_{k-1} + β_k,
  // α_k = -conj(s_k), β_k = c_k z_k, t_0 = z_0, as a scan of affine maps ----
  const int len = (N - 1 + T - 1) / T;
  const int lo = 1 + t * len;
  const int hi = lo + len < N ? lo + len : N;
  cx<R> al = mk(R(1), R(0)), be = zero;  // this chunk's map, composed
  for (int k = lo; k < hi; ++k) {
    const cx<R> sk = S[k];
    const cx<R> ms = mk(-sk.re, sk.im);
    al = mul(ms, al);
    be = add(mul(ms, be), scale(C[k], Z[k]));
  }
  scan[2 * t] = al;
  scan[2 * t + 1] = be;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    cx<R> pa = mk(R(1), R(0)), pb = zero;
    if (t >= off) {
      pa = scan[2 * (t - off)];
      pb = scan[2 * (t - off) + 1];
    }
    __syncthreads();
    if (t >= off) {
      be = add(mul(al, pb), be);
      al = mul(al, pa);
      scan[2 * t] = al;
      scan[2 * t + 1] = be;
    }
    __syncthreads();
  }
  // this chunk's start value: the maps of the chunks before, applied to z_0
  const cx<R> z0 = Z[0];
  cx<R> tv = z0;
  if (t > 0) tv = add(mul(scan[2 * (t - 1)], z0), scan[2 * (t - 1) + 1]);
  for (int k = lo; k < hi; ++k) {
    const R ck = C[k];
    const cx<R> sk = S[k], zk = Z[k];
    w[k - 1] = add(scale(ck, tv), mul(sk, zk));
    tv = add(mul(mk(-sk.re, sk.im), tv), scale(ck, zk));
  }
  if (lo < hi && hi == N) w[N - 1] = tv;
  if (N == 1 && t == 0) w[0] = z0;
}

// The chain of one step and nothing else, `iters` times: every thread reads
// the slot; the owner of the next row rotates that row, reads the pivot's
// inputs from the shared queue, computes the next pivot and writes it to
// the slot; one barrier.
template <typename R, int T>
__global__ void __launch_bounds__(T) rq_step_floor_kernel(double* out, int iters) {
  __shared__ Pivot<R> slot[2];
  __shared__ cx<R> qh[kQ], qb[kQ];
  const int t = threadIdx.x;
  const cx<R> fresh = mk(R(0.5), R(0.25));
  cx<R> car = mk(R(1), R(0.5)), acc = mk(R(0.25), R(0));
  if (t < kQ) {
    qh[t] = mk(R(0.75), R(-0.5));
    qb[t] = mk(R(1), R(0));
  }
  __syncthreads();
  if (t == 0) pivot(car, acc, qh[0], qb[0], slot[iters & 1].c, slot[iters & 1].s,
                    slot[iters & 1].z);
  __syncthreads();
  for (int k = iters; k >= 1; --k) {
    const Pivot<R> p = slot[k & 1];
    if (t == (k - 1) % T) {
      rotate_row(car, acc, fresh, p.c, p.s, mk(-p.s.re, p.s.im), p.z);
      Pivot<R> q;
      pivot(car, acc, qh[(k - 1) % kQ], qb[(k - 1) % kQ], q.c, q.s, q.z);
      slot[(k - 1) & 1] = q;
    }
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = static_cast<double>(slot[0].z.re + car.re);
}

template <typename R, int T, int RPT>
int launch(const void* Ht, const void* shifts, const void* B, void* W, void* SZ,
           void* C, void* spill, int K, int N, cudaStream_t stream) {
  const int nr = N < T * RPT ? N : T * RPT;
  const size_t smem = sizeof(cx<R>) *
      (2 * static_cast<size_t>(T) +
       (spill != nullptr ? 0 : 2 * static_cast<size_t>(N - nr)));
  if (smem > 32 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hess_solve_rq_kernel<R, T, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hess_solve_rq_kernel<R, T, RPT><<<K, T, smem, stream>>>(
      static_cast<const cx<R>*>(Ht), static_cast<const cx<R>*>(shifts),
      static_cast<const cx<R>*>(B), static_cast<cx<R>*>(W),
      static_cast<cx<R>*>(SZ), static_cast<R*>(C), static_cast<cx<R>*>(spill), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a (threads, rows_per_thread) pair that has no
// instance. is_c128 selects the element type: 0 for complex64, 1 for
// complex128. spill: null to keep the rows past threads·rows_per_thread in
// shared memory (the wrapper passes a (K, N - threads·rows_per_thread, 2)
// buffer when they do not fit there).
extern "C" int maus_hess_solve_rq(const void* Ht, const void* shifts, const void* B,
                                  void* W, void* SZ, void* C, void* spill,
                                  int is_c128, int K, int N, int threads,
                                  int rows_per_thread, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_c128) {
    if (threads == 256 && rows_per_thread == 16)
      return launch<float, 256, 16>(Ht, shifts, B, W, SZ, C, spill, K, N, s);
    if (threads == 512 && rows_per_thread == 8)
      return launch<float, 512, 8>(Ht, shifts, B, W, SZ, C, spill, K, N, s);
    if (threads == 1024 && rows_per_thread == 4)
      return launch<float, 1024, 4>(Ht, shifts, B, W, SZ, C, spill, K, N, s);
  } else {
    if (threads == 256 && rows_per_thread == 8)
      return launch<double, 256, 8>(Ht, shifts, B, W, SZ, C, spill, K, N, s);
    if (threads == 512 && rows_per_thread == 4)
      return launch<double, 512, 4>(Ht, shifts, B, W, SZ, C, spill, K, N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The RQ kernel's latency floor: `blocks` blocks of `threads` threads, each
// running `iters` steps of the chain alone; out (blocks,) float64 keeps the
// result live.
extern "C" int maus_hess_rq_step_floor(int is_c128, int threads, int blocks,
                                       int iters, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
#define MAUS_FLOOR(R, T)                                          \
  if (threads == T) {                                             \
    rq_step_floor_kernel<R, T><<<blocks, T, 0, s>>>(o, iters);    \
    return static_cast<int>(cudaGetLastError());                  \
  }
  if (is_c128) {
    MAUS_FLOOR(double, 256)
    MAUS_FLOOR(double, 512)
    MAUS_FLOOR(double, 1024)
  } else {
    MAUS_FLOOR(float, 256)
    MAUS_FLOOR(float, 512)
    MAUS_FLOOR(float, 1024)
  }
#undef MAUS_FLOOR
  return static_cast<int>(cudaErrorInvalidValue);
}
