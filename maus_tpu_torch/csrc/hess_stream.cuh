// P1 and P2 redesigned for Hopper: the batched shifted upper-Hessenberg
// solve that keeps the triangular factor,
//   (H + s_k I) w_k = b_k   for k = 0..K-1, one shared upper-Hessenberg H,
// as two kernels: a top-down Givens sweep that streams R and the rotated
// right-hand side y out (sweep_kernel), then a blocked back substitution
// R x = y on a thread-block cluster per candidate (back_kernel). The body of
// P1 (hess_stream_v2.cu, kV3 = false: givens(), Smith division, R packed by
// rows) and P2 (hess_stream_v3.cu, kV3 = true: givens_rsqrt(), reciprocal
// diagonals, R in column tiles). K2's contract: any K, N >= 1, complex64 or
// complex128, the identity rotation when b = 0 and sign 1 when a = 0, and a
// non-finite row when R has an exact-zero diagonal.
//
// What bounds it. The function's work is K2's (14·K·N² flops, 0.112 ms at
// (32, 4096) complex64). A design that keeps R writes it once and reads it
// once: 2·K·N²/2 elements, 4.30 GB at (32, 4096) complex64, 1.28 ms at
// 3.35 TB/s. The sweep's N - 1 dependent steps (a rotation, then every
// column of a row) run on one SM per candidate: its floor is K2's chain.
//
// The sweep (one block per candidate: kThreads column threads and a pivot
// warp). Column thread t owns columns base + t + r·kThreads, r < CPT, in
// registers (base = N - kThreads·CPT, so the register columns are the last
// ones, which stay active longest, and a step's read of H's row j+1 is
// coalesced); columns left of base (N past the register fit) keep the
// carried row in shared memory, or in a global scratch when it does not fit
// there (the wrapper's plan picks). At step j the column threads rotate
// every active column by step j's rotation, store R's row j as they go, and
// load H's row j+2 into the register set the next step reads (two sets
// alternate; row j+2+kDist is prefetched into L2); the owner of column j+2
// publishes its new entry. The pivot warp meanwhile rotates column
// m = j+1's entry itself (its owner's arithmetic), takes step m's rotation
// and rotated y entry from it and writes them to a double-buffered shared
// slot: one barrier a step, and the rotation's chain (in P1 two hypot, a
// sqrt and two divides) runs beside the columns' work, not before one
// warp's share of it. The pivot's other inputs (H[m+1, m], b[m], H[m, m])
// come from a shared queue that the pivot warp fills a chunk of kQ steps
// ahead, so no global load lies on the chain. Finished columns are skipped
// by a test a register slot. R goes out with streaming stores
// (st.global.cs), so that R (2.15 GB at (32, 4096) complex64) does not
// evict the rows of H the candidates share in L2. 480 column threads and
// the pivot warp make 16 warps, which leaves 128 registers a thread (a 17th
// warp caps them at 96 and spills).
//
// The back substitution (a cluster of C CTAs per candidate, blocks of
// kBS = 64 columns from the last). CTA 0 runs each block's recurrence
// (phase B, one warp, from the block's diagonal tile in shared memory; what
// depends on the diagonal alone is taken first) and publishes x_b in global
// memory with a release flag, while its other warps stage the next block's
// diagonal tile, the tile above and its y (cp.async). Phase A splits: the
// near part (the block just solved) is one 64×64 product on CTA 0; the far
// part of target block t (the blocks b' >= t + 2) is one worker's (CTAs
// 1..C-1 take the targets in turn): a warp a set of rows, lanes along 64
// columns, R read once with streaming loads, each block as soon as its x is
// published. The workers run ahead of CTA 0 with no barrier a block, so R
// streams while CTA 0's chain runs; a worker's sum reaches CTA 0 through
// distributed shared memory with a release flag. Every flag wait traps
// after kMaxPolls polls rather than hang. Past two blocks a cluster needs a
// worker (C >= 2); the wrapper picks the largest C whose K clusters the
// card runs in one wave (cudaOccupancyMaxActiveClusters). x is read back
// through L2 (ld.global.cg). Phase A's sums run in another order than the
// plain version's product (_back_blocked): rounding-level differences only.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hess_common.cuh"

namespace maus {
namespace stream {

namespace cg = cooperative_groups;

// the sweep's column threads; with its pivot warp a block of 512 threads,
// whose 16 warps leave each of an SM's four schedulers 128 registers a thread
constexpr int kThreads = 480;
constexpr int kBackThreads = 256;       // a back-substitution CTA
constexpr int kBackWarps = kBackThreads / 32;
constexpr int kMaxCluster = 8;
// rows of a block a worker warp takes
constexpr int kRows = kBS / kBackWarps;
// polls of a flag before the kernel gives up (__trap) instead of hanging
constexpr int kMaxPolls = 1 << 24;
constexpr int kDist = 8;                // rows of H prefetched into L2 ahead
constexpr int kQ = 32;                  // the pivot queue's chunk of steps
constexpr int kTile = kBS * kTileStride;

template <typename R>
struct V2;
template <>
struct V2<float> {
  using type = float2;
};
template <>
struct V2<double> {
  using type = double2;
};

// streaming (evict-first) store and load, and a load that bypasses L1
template <typename R>
__device__ __forceinline__ void st_cs(cx<R>* p, cx<R> v) {
  typename V2<R>::type t;
  t.x = v.re;
  t.y = v.im;
  __stcs(reinterpret_cast<typename V2<R>::type*>(p), t);
}
template <typename R>
__device__ __forceinline__ cx<R> ld_cs(const cx<R>* p) {
  const auto t = __ldcs(reinterpret_cast<const typename V2<R>::type*>(p));
  return mk(t.x, t.y);
}
template <typename R>
__device__ __forceinline__ cx<R> ld_cg(const cx<R>* p) {
  const auto t = __ldcg(reinterpret_cast<const typename V2<R>::type*>(p));
  return mk(t.x, t.y);
}

template <typename R>
__device__ __forceinline__ void prefetch_l2(const cx<R>* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename R, bool kV3>
__device__ __forceinline__ void rotation(cx<R> a, cx<R> b, R& c, cx<R>& s) {
  if constexpr (kV3) {
    givens_rsqrt(a, b, c, s);
  } else {
    givens(a, b, c, s);
  }
}

// R's element (row, col) with P1's row start rb = row·N - row·(row+1)/2
template <bool kV3>
__device__ __forceinline__ size_t rpos(int row, size_t rb, int col) {
  if constexpr (kV3) {
    const unsigned uc = static_cast<unsigned>(col);
    return tile_offset(static_cast<int>(uc / kBS)) + static_cast<size_t>(row) * kBS +
           (uc % kBS);
  } else {
    return rb + static_cast<size_t>(col);
  }
}
__device__ __forceinline__ size_t row_start(int row, size_t n) {
  const size_t r = static_cast<size_t>(row);
  return r * n - r * (r + 1) / 2;
}

// Step j's rotation as the step reads it, and the y entry it rotates.
template <typename R>
struct Pivot {
  cx<R> s, y;
  R c;
};

template <typename R, bool kV3, int CPT>
__global__ void __launch_bounds__(kThreads + 32, 1)
sweep_kernel(const cx<R>* __restrict__ H, const cx<R>* __restrict__ shifts,
             const cx<R>* __restrict__ B, cx<R>* __restrict__ Y,
             cx<R>* __restrict__ Rall, cx<R>* __restrict__ gspill, int N,
             size_t r_elems) {
  constexpr int T = kThreads;  // the column threads; threads [T, T + 32): the pivot warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Pivot<R> slot[2];
  // pub[m & 1]: the carried entry of column m after step m - 2, from its
  // owner, for the pivot warp's step m - 1
  __shared__ cx<R> pub[2];
  // the pivots' inputs for index m: H[m+1, m], b[m], H[m, m]; chunk c of
  // kQ indices in buffer c & 1; lane l of the pivot warp holds index
  // kQ·c + l of the chunk after the one in use
  __shared__ cx<R> qh[2][kQ], qb[2][kQ], qd[2][kQ];
  const int t = threadIdx.x;
  const bool pivot_warp = t >= T;
  const int pl = t - T;
  const size_t kb = blockIdx.x;
  const size_t n = static_cast<size_t>(N);
  const int base = N - T * CPT;   // register column (t, r): base + t + r·T
  const int ns = base > 0 ? base : 0;  // columns [0, ns): the spill
  cx<R>* __restrict__ spill =
      gspill != nullptr ? gspill + kb * ns : reinterpret_cast<cx<R>*>(smem_raw);
  const cx<R> sh = shifts[kb];
  const cx<R>* __restrict__ b = B + kb * n;
  cx<R>* __restrict__ y = Y + kb * n;
  cx<R>* __restrict__ Rk = Rall + kb * r_elems;
  const cx<R> zero = mk(R(0), R(0));

  cx<R> ph = zero, pb = zero, pd = zero;
  auto fetch = [&](int m) {
    ph = zero;
    pb = zero;
    pd = zero;
    if (m < N) {
      if (m + 1 < N) ph = H[static_cast<size_t>(m + 1) * n + m];
      pb = b[m];
      pd = H[static_cast<size_t>(m) * n + m];
    }
  };

  // the carried row starts as row 0 of H + sI; fa holds row 1 (+ s on
  // its diagonal)
  cx<R> cur[CPT], fa[CPT], fb[CPT];
  // a register column's place in R's row j, less the row's start: the
  // column itself (P1), or its tile's offset and place in the tile's row
  // (P2; 32 bits, the entry checks that R fits)
  unsigned roff[CPT];
#pragma unroll
  for (int r = 0; r < CPT; ++r) {
    const int col = base + t + r * T;
    roff[r] = col < 0 ? 0u : static_cast<unsigned>(rpos<kV3>(0, 0, col));
    cx<R> v = zero, f = zero;
    if (!pivot_warp && col >= 0) {
      v = H[col];
      if (col == 0) v = add(v, sh);
      if (N >= 2) f = H[n + col];
      if (col == 1) f = add(f, sh);
    }
    cur[r] = v;
    fa[r] = f;
    fb[r] = zero;
  }
  if (!pivot_warp) {
    for (int i = t; i < ns; i += T) {
      cx<R> v = H[i];
      if (i == 0) v = add(v, sh);
      spill[i] = v;
    }
  } else {
    fetch(pl);
    qh[0][pl] = ph;
    qb[0][pl] = pb;
    qd[0][pl] = pd;
    fetch(kQ + pl);
  }
  // the pivot warp's lane 0 carries the pivot of the step in flight
  Pivot<R> pv;
  if (pivot_warp && pl == 0) {
    const cx<R> a0 = add(H[0], sh);
    if (N == 1) {
      st_cs(Rk, a0);
      y[0] = b[0];
    } else {
      rotation<R, kV3>(a0, H[n], pv.c, pv.s);
      pv.y = b[0];
      slot[0] = pv;
      pub[1] = H[1];
    }
  }
  if (N == 1) return;
  __syncthreads();

  // Step j: rotate rows j and j+1 of the working matrix by step j's
  // rotation (c, s): R[j, col] = c·cur[col] + s·f, cur[col] <- -conj(s)·cur
  // + c·f for the columns col >= j, f = H[j+1, col] (+ s on the diagonal).
  // The pivot warp meanwhile rotates column m = j+1's entry itself and
  // computes step m's rotation from it. `fr` holds H's row j+1, `nx`
  // receives row j+2.
  auto step = [&](const int j, cx<R>(&fr)[CPT], cx<R>(&nx)[CPT]) {
    const int m = j + 1;
    if (pivot_warp) {
      if (pl == 0) {
        const int qc = (m / kQ) & 1, qi = m % kQ;
        const Pivot<R> p = pv;
        const cx<R> ms = mk(-p.s.re, p.s.im);  // -conj(s)
        const cx<R> f = add(qd[qc][qi], sh);
        const cx<R> o = add(mul(ms, pub[m & 1]), scale(p.c, f));
        const cx<R> bm = qb[qc][qi];
        const cx<R> yn = add(mul(ms, p.y), scale(p.c, bm));
        if (m < N - 1) {
          rotation<R, kV3>(o, qh[qc][qi], pv.c, pv.s);
          pv.y = yn;
          slot[m & 1] = pv;
        } else {
          st_cs(Rk + rpos<kV3>(m, row_start(m, n), m), o);
          y[m] = yn;
        }
        y[j] = add(scale(p.c, p.y), mul(p.s, bm));
      }
      // the next step's index m + 1 starts a new chunk: move the
      // prefetched chunk into its buffer and fetch the one after it
      if ((j + 2) % kQ == 0) {
        const int c = (j + 2) / kQ;
        qh[c & 1][pl] = ph;
        qb[c & 1][pl] = pb;
        qd[c & 1][pl] = pd;
        fetch((c + 1) * kQ + pl);
      }
    } else {
      const size_t rb = row_start(j, n);
      cx<R>* __restrict__ Rj = Rk + (kV3 ? static_cast<size_t>(j) * kBS : rb);
      if (m + 1 < N) {
        const cx<R>* row = H + static_cast<size_t>(m + 1) * n;
#pragma unroll
        for (int r = 0; r < CPT; ++r) {
          const int col = base + t + r * T;
          if (col < m) continue;
          const cx<R> v = row[col];
          nx[r] = col == m + 1 ? add(v, sh) : v;
        }
        const int q = m + 1 + kDist;
        if (q < N) {
          constexpr int kLine = 128 / static_cast<int>(sizeof(cx<R>));
          const cx<R>* pr = H + static_cast<size_t>(q) * n;
          for (int i = (q - 1) / kLine * kLine + t * kLine; i < N; i += T * kLine)
            prefetch_l2(pr + i);
        }
      }
      const Pivot<R> p = slot[j & 1];
      const cx<R> ms = mk(-p.s.re, p.s.im);  // -conj(s)
#pragma unroll
      for (int r = 0; r < CPT; ++r) {
        const int col = base + t + r * T;
        if (col < j) continue;
        const cx<R> o = cur[r], f = fr[r];
        st_cs(Rj + roff[r], add(scale(p.c, o), mul(p.s, f)));
        const cx<R> v = add(mul(ms, o), scale(p.c, f));
        cur[r] = v;
        if (col == m + 1) pub[(m + 1) & 1] = v;
      }
      if (j < ns) {
        const cx<R>* row = H + static_cast<size_t>(m) * n;
        const int i0 = j + (t - j % T + T) % T;
#pragma unroll 4
        for (int i = i0; i < ns; i += T) {
          const cx<R> o = spill[i];
          cx<R> f = row[i];
          if (i == m) f = add(f, sh);
          st_cs(Rk + rpos<kV3>(j, rb, i), add(scale(p.c, o), mul(p.s, f)));
          const cx<R> v = add(mul(ms, o), scale(p.c, f));
          spill[i] = v;
          if (i == m + 1) pub[(m + 1) & 1] = v;
        }
      }
    }
    __syncthreads();
  };
  int j = 0;
  for (; j + 1 < N - 1; j += 2) {
    step(j, fa, fb);
    step(j + 1, fb, fa);
  }
  if (j < N - 1) step(j, fa, fb);
}

// dynamic shared memory of a back-substitution CTA: two diagonal tiles and
// the tile above (each padded to kTile), the workers' sums for two targets,
// rhs, x_b, near, the next block's y
template <typename R>
size_t back_smem_bytes() {
  return sizeof(cx<R>) * (3 * static_cast<size_t>(kTile) + 6 * kBS);
}

// flags between the CTAs of a cluster: a store that releases and a load
// that acquires at cluster scope, on a generic address of any CTA's shared
// memory
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cluster.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// spins until pred(flag) holds, then returns the flag; traps after
// kMaxPolls polls
template <typename Pred>
__device__ __forceinline__ int wait_flag(const int* p, Pred pred) {
  int v = ld_acquire(p);
  for (int i = 0; !pred(v); ++i) {
    if (i == kMaxPolls) __trap();
    __nanosleep(64);
    v = ld_acquire(p);
  }
  return v;
}

// an asynchronous copy of one element from global into shared memory
template <typename R>
__device__ __forceinline__ void cp_async(cx<R>* dst, const cx<R>* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(static_cast<int>(sizeof(cx<R>))));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Phase B: x = T⁻¹·rhs for one block's staged diagonal tile T (column-major,
// stride kTileStride) of width bw (kW if kW > 0, then unrolled), by one warp:
// lane l holds the rhs of rows l and l + 32 and keeps x of the same rows; at
// column jj the owning lane forms x_jj, one shuffle broadcasts it, and
// every lane subtracts T[t, jj]·x_jj from its rows. What depends on the
// diagonal alone is taken before the recurrence: P2's reciprocals
// conj(d)/|d|² (+inf on an exact zero); P1's Smith scaling s = |Re d| +
// |Im d|, d/s and |d/s|², so a column's chain holds cdiv's two divides and
// not its six. x goes to xb and to global memory at xg.
template <typename R, bool kV3, int kW>
__device__ __forceinline__ void block_solve(const cx<R>* Ts, const cx<R>* rhs,
                                            cx<R>* xb, cx<R>* xg, int bw, int lane) {
  const cx<R> zero = mk(R(0), R(0));
  const int w = kW > 0 ? kW : bw;
  cx<R> y0 = lane < w ? rhs[lane] : zero;
  cx<R> y1 = lane + 32 < w ? rhs[lane + 32] : zero;
  cx<R> x0 = zero, x1 = zero;
  const cx<R> d0 = lane < w ? Ts[lane * kTileStride + lane] : zero;
  const cx<R> d1 = lane + 32 < w ? Ts[(lane + 32) * kTileStride + lane + 32] : zero;
  // P2: rc = conj(d)/|d|², bad = inf on a zero; P1: s, ds = d/s, den
  cx<R> rc0, rc1;
  R a0, a1, bad0, bad1;
  if constexpr (kV3) {
    const R den0 = d0.re * d0.re + d0.im * d0.im;
    const R den1 = d1.re * d1.re + d1.im * d1.im;
    const R inv0 = den0 > R(0) ? R(1) / den0 : R(0);
    const R inv1 = den1 > R(0) ? R(1) / den1 : R(0);
    rc0 = mk(d0.re * inv0, -d0.im * inv0);
    rc1 = mk(d1.re * inv1, -d1.im * inv1);
    a0 = a1 = R(0);
    bad0 = den0 > R(0) ? R(0) : rinf(R(0));
    bad1 = den1 > R(0) ? R(0) : rinf(R(0));
  } else {
    a0 = rabs(d0.re) + rabs(d0.im);
    a1 = rabs(d1.re) + rabs(d1.im);
    rc0 = mk(d0.re / a0, d0.im / a0);
    rc1 = mk(d1.re / a1, d1.im / a1);
    bad0 = rc0.re * rc0.re + rc0.im * rc0.im;  // den
    bad1 = rc1.re * rc1.re + rc1.im * rc1.im;
  }
  const bool zero0 = d0.re == R(0) && d0.im == R(0);
  const bool zero1 = d1.re == R(0) && d1.im == R(0);
#pragma unroll
  for (int jj = w - 1; jj >= 0; --jj) {
    const bool hi = jj >= 32;
    const cx<R> num = hi ? y1 : y0;
    cx<R> xj;
    if constexpr (kV3) {
      const cx<R> rc = hi ? rc1 : rc0;
      const R bad = hi ? bad1 : bad0;
      xj = mk(num.re * rc.re - num.im * rc.im + bad,
              num.re * rc.im + num.im * rc.re + bad);
    } else {
      // cdiv(num, d) of hess_common.cuh with its diagonal part hoisted
      const R sc = hi ? a1 : a0, den = hi ? bad1 : bad0;
      const cx<R> ds = hi ? rc1 : rc0;
      const cx<R> n = mul(mk(num.re / sc, num.im / sc), conj(ds));
      xj = (hi ? zero1 : zero0) ? mk(rinf(R(0)), R(0)) : mk(n.re / den, n.im / den);
    }
    xj.re = __shfl_sync(0xffffffffu, xj.re, jj & 31);
    xj.im = __shfl_sync(0xffffffffu, xj.im, jj & 31);
    if (lane == (jj & 31)) {
      if (hi) {
        x1 = xj;
      } else {
        x0 = xj;
      }
    }
    const cx<R>* tcol = Ts + jj * kTileStride;
    if constexpr (kV3) {
      // no triangularity mask: the rows at and below jj are solved, and
      // rows past a ragged block's width are never read
      y0 = sub(y0, mul(tcol[lane], xj));
      y1 = sub(y1, mul(tcol[lane + 32], xj));
    } else {
      if (lane < jj) y0 = sub(y0, mul(tcol[lane], xj));
      if (lane + 32 < jj) y1 = sub(y1, mul(tcol[lane + 32], xj));
    }
  }
  xb[lane] = x0;
  xb[lane + 32] = x1;
  if (lane < w) xg[lane] = x0;
  if (lane + 32 < w) xg[lane + 32] = x1;
}

template <typename R, bool kV3>
__global__ void __launch_bounds__(kBackThreads)
back_kernel(const cx<R>* __restrict__ Rall, const cx<R>* Y, cx<R>* X, int N,
            size_t r_elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // CTA 0's flags: blocks >= solved are solved (x in global memory);
  // ready[t & 1] == t when target t's far sum is in part[t & 1]
  __shared__ int solved, ready[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cx<R>* tiles = reinterpret_cast<cx<R>*>(smem_raw);
  cx<R>* above = tiles + 2 * kTile;       // row-major, row stride kTileStride
  cx<R>* part = above + kTile;            // [target & 1][row]
  cx<R>* rhs = part + 2 * kBS;
  cx<R>* xb = rhs + kBS;
  cx<R>* nearv = xb + kBS;
  cx<R>* ynext = nearv + kBS;
  const size_t k = blockIdx.x / C;
  const size_t n = static_cast<size_t>(N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const cx<R>* __restrict__ Rk = Rall + k * r_elems;
  const cx<R>* yk = Y + k * n;
  cx<R>* xk = X + k * n;
  const cx<R> zero = mk(R(0), R(0));
  const int nb = (N + kBS - 1) / kBS;
  const int last = nb - 1;
  if (rank == 0 && tid == 0) {
    solved = nb;
    ready[0] = ready[1] = -1;
  }
  cluster.sync();  // the flags set before any CTA reads them

  if (rank > 0) {
    // ---- a worker: the far sums of its targets t (t <= nb - 3; worker w
    // takes t with (nb - 3 - t) % (C - 1) == w), from the highest: the dot
    // of the target's rows with the blocks b' >= t + 2 as each is solved,
    // a warp a set of kRows rows, lanes along 64 columns, kU blocks of
    // loads in flight
    constexpr int kU = sizeof(R) == 4 ? 2 : 1;
    const int* solved_at = cluster.map_shared_rank(&solved, 0);
    int* ready_at = cluster.map_shared_rank(ready, 0);
    cx<R>* part_at = cluster.map_shared_rank(part, 0);
    int seen = nb;  // blocks >= seen are known solved
    for (int t = nb - 3 - (rank - 1); t >= 0; t -= C - 1) {
      const int r0 = t * kBS;
      cx<R> acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] = zero;
      for (int bb = last; bb >= t + 2; bb -= kU) {
        const int lo = max(bb - kU + 1, t + 2);
        if (seen > lo) {
          if (lane == 0) seen = wait_flag(solved_at, [&](int v) { return v <= lo; });
          seen = __shfl_sync(0xffffffffu, seen, 0);
          __syncwarp();
        }
        cx<R> xv[kU][2], rv[kU][kRows][2];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = (bb - u) * kBS;
          const bool in = bb - u >= lo;
          const bool in0 = in && c + lane < N, in1 = in && c + 32 + lane < N;
          xv[u][0] = in0 ? ld_cg(xk + c + lane) : zero;
          xv[u][1] = in1 ? ld_cg(xk + c + 32 + lane) : zero;
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const int row = r0 + warp + q * kBackWarps;
            rv[u][q][0] = in0 ? ld_cs(Rk + r_index<kV3>(row, c + lane, N)) : zero;
            rv[u][q][1] = in1 ? ld_cs(Rk + r_index<kV3>(row, c + 32 + lane, N)) : zero;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int q = 0; q < kRows; ++q)
            acc[q] = add(acc[q], add(mul(rv[u][q][0], xv[u][0]), mul(rv[u][q][1], xv[u][1])));
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const cx<R> v = warp_sum(acc[q]);
        if (lane == 0) part_at[(t & 1) * kBS + warp + q * kBackWarps] = v;
      }
      __syncthreads();
      if (tid == 0) st_release(ready_at + (t & 1), t);
    }
    cluster.sync();
    return;
  }

  // ---- CTA 0: the blocks' recurrences, from the last block up ----------
  // block blk's diagonal tile into Ts (column-major, entries on and above
  // the diagonal) and, for blk < nb - 1, R[rows of blk, columns of blk + 1]
  // into `above` (row-major, zero past N) and blk's y into ynext:
  // asynchronous copies issued by threads [first, first + count), landed by
  // cp_async_wait()
  auto stage = [&](int blk, cx<R>* Ts, bool with_above, int first, int count) {
    const int c0 = blk * kBS, bw = min(kBS, N - c0);
    if (with_above && tid - first < kBS) cp_async(ynext + tid - first, yk + c0 + tid - first);
    for (int idx = tid - first; idx < kBS * kBS; idx += count) {
      const int il = idx / kBS, jc = idx % kBS;
      if (jc >= il && jc < bw)
        cp_async(Ts + jc * kTileStride + il, Rk + r_index<kV3>(c0 + il, c0 + jc, N));
      if (with_above) {
        cx<R>* d = above + il * kTileStride + jc;
        if (c0 + kBS + jc < N)
          cp_async(d, Rk + r_index<kV3>(c0 + il, c0 + kBS + jc, N));
        else
          *d = zero;
      }
    }
  };

  stage(last, tiles + (last & 1) * kTile, false, 0, kBackThreads);
  for (int i = tid; i < kBS; i += kBackThreads)
    rhs[i] = last * kBS + i < N ? ld_cg(yk + last * kBS + i) : zero;
  cp_async_wait();
  __syncthreads();
  for (int b = last; b >= 0; --b) {
    if (warp == 0) {
      // phase B, then x_b is published: its stores, then the flag
      const int c0 = b * kBS, bw = min(kBS, N - c0);
      if (bw == kBS) {
        block_solve<R, kV3, kBS>(tiles + (b & 1) * kTile, rhs, xb, xk + c0, kBS, lane);
      } else {
        block_solve<R, kV3, 0>(tiles + (b & 1) * kTile, rhs, xb, xk + c0, bw, lane);
      }
      __syncwarp();
      if (lane == 0) st_release(&solved, b);
    } else if (b >= 1) {
      stage(b - 1, tiles + ((b - 1) & 1) * kTile, true, 32, kBackThreads - 32);
    }
    if (b == 0) break;
    cp_async_wait();
    __syncthreads();  // x_b in xb, the next block's tiles and y staged
    // near: R[rows of b - 1, columns of b]·x_b, four threads a row
    {
      const int il = tid >> 2, q = tid & 3;
      cx<R> v = zero;
#pragma unroll
      for (int i = 0; i < kBS / 4; ++i)
        v = add(v, mul(above[il * kTileStride + q + 4 * i], xb[q + 4 * i]));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        v.re += __shfl_xor_sync(0xffffffffu, v.re, off);
        v.im += __shfl_xor_sync(0xffffffffu, v.im, off);
      }
      if (q == 0) nearv[il] = v;
    }
    // target b - 1's far sum, when it has one (blocks >= b + 1 exist)
    const bool far = b + 1 <= last;
    if (far && tid == 0) wait_flag(&ready[(b - 1) & 1], [&](int v) { return v == b - 1; });
    __syncthreads();
    for (int i = tid; i < kBS; i += kBackThreads) {
      cx<R> v = sub(ynext[i], nearv[i]);
      if (far) v = sub(v, part[((b - 1) & 1) * kBS + i]);
      rhs[i] = v;
    }
    __syncthreads();
  }
  cluster.sync();
}

template <typename R, bool kV3, int CPT>
int launch_sweep(const void* H, const void* shifts, const void* B, void* Y, void* Rs,
                 void* spill, int K, int N, cudaStream_t stream) {
  const int ns = N - kThreads * CPT > 0 ? N - kThreads * CPT : 0;
  const size_t smem = spill != nullptr ? 0 : sizeof(cx<R>) * static_cast<size_t>(ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<R, kV3, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sweep_kernel<R, kV3, CPT><<<K, kThreads + 32, smem, stream>>>(
      static_cast<const cx<R>*>(H), static_cast<const cx<R>*>(shifts),
      static_cast<const cx<R>*>(B), static_cast<cx<R>*>(Y), static_cast<cx<R>*>(Rs),
      static_cast<cx<R>*>(spill), N, r_elems(N, kV3));
  return static_cast<int>(cudaGetLastError());
}

template <typename R, bool kV3>
int launch_back(const void* Rs, const void* Y, void* X, int K, int N, int C,
                cudaStream_t stream) {
  // a target with a far sum (N > 2·kBS) needs a worker CTA
  if (C < 1 || C > kMaxCluster || (C == 1 && N > 2 * kBS))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = back_smem_bytes<R>();
  cudaError_t e = cudaFuncSetAttribute(back_kernel<R, kV3>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * static_cast<unsigned>(K));
  cfg.blockDim = dim3(kBackThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, back_kernel<R, kV3>, static_cast<const cx<R>*>(Rs),
                         static_cast<const cx<R>*>(Y), static_cast<cx<R>*>(X), N,
                         r_elems(N, kV3));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of C back-substitution CTAs the card runs at once
// (cudaOccupancyMaxActiveClusters), into *active.
template <typename R, bool kV3>
int back_occupancy(int C, int* active) {
  if (C < 1 || C > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = back_smem_bytes<R>();
  cudaError_t e = cudaFuncSetAttribute(back_kernel<R, kV3>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * 132u);
  cfg.blockDim = dim3(kBackThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(active, back_kernel<R, kV3>, &cfg));
}

// The C entry of P1 (kV3 = false) and P2: mode 1 runs the sweep (R and the
// rotated rhs y, into W), mode 2 the back substitution (R x = Y, x into
// W), mode 3 both (Y = W). cols is the sweep's columns a thread in
// registers (9 for complex64, 5 for complex128), cluster the back
// substitution's CTAs a candidate (1..8); anything else is refused with
// cudaErrorInvalidValue. Mode 0 writes the back substitution's
// cudaOccupancyMaxActiveClusters at cluster size `cluster` into W (an int).
template <bool kV3>
int entry(const void* H, const void* shifts, const void* B, void* W, void* Rs,
          void* spill, const void* Y, int is_c128, int K, int N, int cols,
          int cluster, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return is_c128 ? back_occupancy<double, kV3>(cluster, static_cast<int*>(W))
                   : back_occupancy<float, kV3>(cluster, static_cast<int*>(W));
  if (mode < 1 || mode > 3 || cols != (is_c128 ? 5 : 9) ||
      r_elems(N, kV3) >= (size_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode & 1) {
    const int e = is_c128 ? launch_sweep<double, kV3, 5>(H, shifts, B, W, Rs, spill, K, N, s)
                          : launch_sweep<float, kV3, 9>(H, shifts, B, W, Rs, spill, K, N, s);
    if (e != 0) return e;
  }
  if (mode & 2) {
    const void* y = mode == 3 ? W : Y;
    return is_c128 ? launch_back<double, kV3>(Rs, y, W, K, N, cluster, s)
                   : launch_back<float, kV3>(Rs, y, W, K, N, cluster, s);
  }
  return 0;
}

}  // namespace stream
}  // namespace maus
