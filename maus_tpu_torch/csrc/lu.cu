// Batched LU with partial pivoting (kernels P3 and P4): two panel
// factorizations, the panel's row interchanges fused with the unit-lower
// triangular solve, and the blocked right-looking factorization that strings
// them together with kernel K3's trailing update (csrc/cgemm.cu, same
// library).
// The Python wrapper is maus_tpu_torch/ops/kernels/lu.py.
//
// Replaces benchmarks/parked/pallas_lu.py:103, lu_factor_batched (P3, body
// _lu_kernel, :40), and benchmarks/parked/pallas_lu_blocked.py:169,
// lu_factor_batched_blocked (P4, body _blocked_lu_kernel, :41). Same
// contract: (K, N, N) matrices factored in place into packed L (unit lower,
// multipliers below the diagonal) and U, the pivot of column k the row index
// of the largest |a|² among rows >= k (ties to the lowest index, as jnp.argmax
// and LAPACK's i?amax do; a NaN counts as largest), recorded 1-based in
// torch.linalg.lu_factor's layout (the JAX kernels record it 0-based). A zero
// pivot gives zero multipliers and leaves U's diagonal 0 (pallas_lu.py:78),
// so a later solve is non-finite and the Ψ ladder reads it as a failure. The
// TPU kernels keep the whole matrix in VMEM as split f32 planes (N ≤ ~724 at
// 16 MB), the blocked one needs N % 128 == 0 (the lane tile); these take any
// K >= 1, N >= 1, complex64 or complex128 (templated on the real type), with
// 64-bit offsets.
//
// Bound of the whole factorization: 8/3·K·N³ real flops at the FP32 rate
// (67 TFLOP/s on an H100 SXM): 2.7 ms at (K, N) = (8, 2048), 21.9 ms at
// (8, 4096); the bytes (one read and one write of K·N² complex64) take 0.16
// and 0.64 ms at 3.35 TB/s. Almost all flops are the trailing updates, which
// run in kernel K3. A panel is bound by its chain of dependent column steps:
// its bytes (one read and write of a 4096 × 64 complex64 panel per matrix)
// take 10 µs at (8, 4096), but each of its 64 columns needs the pivot of the
// one before.
//
// The panel, resident in a thread-block cluster (lu_panel_cluster_kernel).
// The first design (lu_panel_kernel below, one block of 1024 threads per
// matrix, the panel in global memory) took 84 µs per column step at
// (8, 4096): every step read and wrote the 2 MB panel through L2, ended in
// two block barriers and a serial 32-way reduction, and the batch of 8 used
// 8 of 132 SMs. Here a cluster of C CTAs (C up to 16, non-portable) factors
// one matrix's panel. CTA r holds rows [s + r·R, s + (r+1)·R) of the panel
// (R = ⌈(N − s)/C⌉) in shared memory from start to end: loaded once, written
// once. A 4096 × 64 complex64 panel over 16 CTAs is 128 KB each. Per column k:
//   1. one cluster barrier (barrier.cluster arrive.release / wait.acquire):
//      each CTA has published its best (|a|², row, slot) for column k, found
//      during its rank-1 update of step k−1 (double-buffered by parity, so
//      one barrier a step suffices);
//   2. warp 0 of every CTA reads the C candidates through distributed
//      shared memory (one 16-byte load by each of C lanes), reduces them with
//      shuffles, and copies the pivot row (at most 64 values, two per lane)
//      from the winning CTA's shared memory into its own; one block barrier
//      hands both to the other warps (every warp reading the row itself put
//      C·16·64 remote loads a step on the winner's SM);
//   3. the interchange is a relabelling: every stored row carries its
//      current row index. The winner's row takes index k and is frozen: U's
//      row k is final, never written again, so other CTAs can read it
//      without a further barrier. The row that held index k takes index p.
//      No data moves until the end, where each row is written to the global
//      row its index names;
//   4. a thread per row computes its multiplier l = a·conj(d)/|d|² (|d|² = 0
//      taken as 1, so a zero pivot gives zero multipliers), applies a − l·u
//      along the row (u a broadcast; rows are padded to w + 1 entries, so that
//      a warp's 32 rows fall in different banks) and keeps the row's |a|² in
//      column k+1; a warp reduction, one block barrier and a reduction by
//      warp 0 publish the CTA's candidate.
// The arithmetic of a step is the first kernel's, so both pick the same
// pivots. On an H100 (chip_smoke.py phase 8) one cluster barrier takes
// 0.75 µs and a column step about 3 µs; at 128-211 KB a CTA one cluster of
// 10-16 CTAs fits a GPC, 7 on the card, so a batch of 8 at N − s = 4096
// runs in two waves. C is chosen by the wrapper from the shape and
// cudaOccupancyMaxActiveClusters (maus_lu_cluster_occupancy); a panel wider
// than 64 columns, or whose slice exceeds the shared memory of a CTA even at
// C = 16 (complex128 at N − s > 3520, complex64 at N − s > 7024: a single
// 16384² matrix, or the unblocked LU), takes lu_panel_kernel.
//
// lu_swap_trsm_kernel: the panel's interchanges on every column outside it,
// and U12 <- L11⁻¹·A[s:e, e:N] (unit lower, width <= 64) on the columns right
// of it, one CTA per column tile and matrix. The panel's w interchanges are
// composed once per CTA into a gather (thread 0 follows them on row indices
// in shared memory): the tile's rows [s, e) and the rows p >= e that the
// panel swaps are each read once and written once. Right of the panel the
// tile's rows [s, e) are solved in shared memory before they are written:
// a thread per column and block of 16 (complex128: 8) rows, the rows in
// registers, one barrier per block.
//
// maus_lu_factor: the blocked factorization, per panel of nb columns the panel
// kernel (cluster or block, as the wrapper's route table says), the fused
// interchange and solve, and K3's trailing update A22 −= L21·U12 on strided
// views of the factor, all launched from C on the caller's stream.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cgemm.cuh"

namespace cg = cooperative_groups;


namespace {

constexpr int kPanelThreads = 1024;
constexpr int kRowsInFlight = 4;
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxClusterWidth = 64;
constexpr int kMaxClusterSize = 16;
constexpr int kSwapTrsmThreads = 256;
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

// the multiplier x·conj(d)/den
template <typename R>
__device__ __forceinline__ cx<R> multiplier(cx<R> x, cx<R> d, R den) {
  return mk((x.re * d.re + x.im * d.im) / den, (x.im * d.re - x.re * d.im) / den);
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

// ---------------------------------------------------------------------------
// The first panel kernel: one block per matrix, the panel in global memory.
// Takes any [s, e) and any N; the wrapper routes here what the cluster
// kernel does not take, and chip_smoke.py times it beside the cluster kernel.

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
          m = multiplier(a[i * n + k], d, den);
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

// ---------------------------------------------------------------------------
// The cluster-resident panel kernel (design in the header).

// A CTA's published candidate: 16 bytes, read by one DSMEM load.
template <typename R>
struct __align__(16) Cand {
  R key;
  int row;   // current row index (the pivot's tie-break)
  int slot;  // the row's slot in the owning CTA
};

// Keep the better of (key, row, slot, cta) and lane `off` away's.
template <typename R>
__device__ __forceinline__ void reduce_step(R& key, int& row, int& slot, int& cta,
                                            int off) {
  const R ok = __shfl_xor_sync(0xffffffffu, key, off);
  const int orow = __shfl_xor_sync(0xffffffffu, row, off);
  const int oslot = __shfl_xor_sync(0xffffffffu, slot, off);
  const int octa = __shfl_xor_sync(0xffffffffu, cta, off);
  if (better(ok, orow, key, row)) {
    key = ok;
    row = orow;
    slot = oslot;
    cta = octa;
  }
}

template <typename R>
__device__ __forceinline__ void warp_best(R& key, int& row, int& slot, int& cta) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) reduce_step(key, row, slot, cta, off);
}

// put(idx, get(idx)) for idx in [tid, total) in steps of nthreads, with
// kLoadBatch loads in flight per thread before their stores.
constexpr int kLoadBatch = 8;

template <typename Get, typename Put>
__device__ __forceinline__ void stage(int total, int tid, int nthreads, Get get, Put put) {
  for (int base = tid; base < total; base += nthreads * kLoadBatch) {
    decltype(get(0)) v[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int idx = base + b * nthreads;
      if (idx < total) v[b] = get(idx);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int idx = base + b * nthreads;
      if (idx < total) put(idx, v[b]);
    }
  }
}

// dst[idx] = get(idx), as stage does.
template <typename T, typename Get>
__device__ __forceinline__ void stage_to(T* dst, int total, int tid, int nthreads, Get get) {
  stage(total, tid, nthreads, get, [&](int idx, const T& v) { dst[idx] = v; });
}

// Shared memory of a CTA: rows_per_cta rows of the panel (row-major, stride
// w + 1 entries, so that the lanes of a warp, on neighbouring rows, hit
// different banks), then rows_per_cta current row indices.
template <typename R>
size_t cluster_smem_bytes(int rows_per_cta, int w) {
  return static_cast<size_t>(rows_per_cta) * ((w + 1) * sizeof(cx<R>) + sizeof(int));
}

template <typename R>
__global__ void __launch_bounds__(kClusterThreads, 1)
lu_panel_cluster_kernel(cx<R>* LU, int* piv, int N, int s, int e, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Cand<R> pub[2];
  __shared__ Cand<R> warp_cand[kClusterWarps];
  __shared__ cx<R> s_u[kMaxClusterWidth];
  __shared__ int s_piv[3];  // the pivot's row index, CTA and slot
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = e - s;
  const int ld = w + 1;
  const int RC = rows_per_cta;
  cx<R>* P = reinterpret_cast<cx<R>*>(smem_raw);
  int* ids = reinterpret_cast<int*>(P + static_cast<size_t>(RC) * ld);

  const int64_t n = N;
  const int64_t mat = blockIdx.x / C;
  cx<R>* a = LU + mat * n * n;
  int* pv = piv + mat * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = s + rank * RC;
  const int nloc = max(0, min(RC, N - row0));

  // load the slice once; the initial candidates for column s
  stage(
      nloc * w, tid, kClusterThreads,
      [&](int idx) {
        const int q = idx / w;
        return a[(row0 + q) * n + s + idx - q * w];
      },
      [&](int idx, const cx<R>& v) {
        const int q = idx / w;
        P[q * ld + idx - q * w] = v;
      });
  __syncthreads();
  R bkey = R(-1);
  int brow = N;
  int bslot = -1;
  int bcta = rank;
  for (int q = tid; q < nloc; q += kClusterThreads) {
    ids[q] = row0 + q;
    const R key = pivot_key(P[q * ld]);
    if (better(key, row0 + q, bkey, brow)) {
      bkey = key;
      brow = row0 + q;
      bslot = q;
    }
  }
  // warp 0: the best of the warps' candidates, published for the cluster
  auto publish = [&](int par) {
    Cand<R> cc = lane < kClusterWarps ? warp_cand[lane] : Cand<R>{R(-1), N, -1};
    int dummy = 0;
    warp_best(cc.key, cc.row, cc.slot, dummy);
    if (lane == 0) pub[par] = cc;
  };
  warp_best(bkey, brow, bslot, bcta);
  if (lane == 0) warp_cand[warp] = Cand<R>{bkey, brow, bslot};
  __syncthreads();
  if (warp == 0) publish(0);

  for (int k = s; k < e; ++k) {
    const int c = k - s;
    const int par = c & 1;
    cluster.sync();

    // warp 0: the pivot, the best of the C published candidates, and its
    // row, read once from the winner's shared memory (frozen there) into
    // this CTA's
    if (warp == 0) {
      R key = R(-1);
      int row = N;
      int slot = -1;
      int cta = -1;
      if (lane < C) {
        const Cand<R> cand = *cluster.map_shared_rank(&pub[par], lane);
        key = cand.key;
        row = cand.row;
        slot = cand.slot;
        cta = lane;
      }
      warp_best(key, row, slot, cta);
      const cx<R>* prow =
          cluster.map_shared_rank(P, cta) + static_cast<size_t>(slot) * ld;
      if (lane < w) s_u[lane] = prow[lane];
      if (lane + 32 < w) s_u[lane + 32] = prow[lane + 32];
      if (lane == 0) {
        s_piv[0] = row;  // every row < k is frozen, row k is live: p >= k
        s_piv[1] = cta;
        s_piv[2] = slot;
        if (rank == 0) pv[k] = row + 1;
      }
    }
    __syncthreads();
    const int p = s_piv[0];
    const bool mine = s_piv[1] == rank;
    const int pslot = s_piv[2];
    const cx<R> d = s_u[c];
    R den = d.re * d.re + d.im * d.im;
    if (!(den > R(0))) den = R(1);

    // a thread per row: relabel, the multiplier, the row's update, and the
    // row's candidate for column c + 1
    R tkey = R(-1);
    int trow = N;
    int tslot = -1;
    for (int q = tid; q < nloc; q += kClusterThreads) {
      const int old = ids[q];
      const int id = (mine && q == pslot) ? k : (old == k ? p : old);
      if (id != old) ids[q] = id;
      if (id <= k) continue;  // frozen: U's rows
      cx<R>* prw = P + q * ld;
      const cx<R> l = multiplier(prw[c], d, den);
      prw[c] = l;
      if (c + 1 < w) {
        const cx<R> v = sub_mul(prw[c + 1], l, s_u[c + 1]);
        prw[c + 1] = v;
        const R kv = pivot_key(v);
        if (better(kv, id, tkey, trow)) {
          tkey = kv;
          trow = id;
          tslot = q;
        }
      }
#pragma unroll 4
      for (int j = c + 2; j < w; ++j) prw[j] = sub_mul(prw[j], l, s_u[j]);
    }
    if (c + 1 < w) {
      int tcta = rank;
      warp_best(tkey, trow, tslot, tcta);
      if (lane == 0) warp_cand[warp] = Cand<R>{tkey, trow, tslot};
      __syncthreads();
      if (warp == 0) publish(par ^ 1);
    }
  }

  // every row to the global row its index names
  __syncthreads();
  for (int idx = tid; idx < nloc * w; idx += kClusterThreads) {
    const int q = idx / w;
    const int j = idx - q * w;
    a[static_cast<int64_t>(ids[q]) * n + s + j] = P[q * ld + j];
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

// The cluster barrier alone, `iters` times: what one column step of the
// cluster kernel cannot go below (chip_smoke.py times it for the panel's
// latency floor).
__global__ void __launch_bounds__(kClusterThreads) cluster_barrier_kernel(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
}

// ---------------------------------------------------------------------------
// The panel's interchanges on the columns outside it, fused with the
// unit-lower solve on the columns right of it.

template <typename R>
__host__ __device__ constexpr int swap_trsm_cols() {
  return sizeof(R) == 4 ? 64 : 32;
}

template <typename R>
size_t swap_trsm_smem_bytes(int w) {
  constexpr int TC = swap_trsm_cols<R>();
  return sizeof(cx<R>) * static_cast<size_t>(w) * (w + 2 * TC) +
         sizeof(int) * static_cast<size_t>(4 * w);
}

template <typename R>
__global__ void __launch_bounds__(kSwapTrsmThreads)
lu_swap_trsm_kernel(cx<R>* LU, const int* piv, int N, int s, int e, int left_tiles) {
  constexpr int TC = swap_trsm_cols<R>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = e - s;
  cx<R>* L = reinterpret_cast<cx<R>*>(smem_raw);   // w × w
  cx<R>* X = L + w * w;                             // w × TC: rows [s, e)
  cx<R>* Y = X + w * TC;                            // w × TC: rows p >= e
  int* pr = reinterpret_cast<int*>(Y + w * TC);     // pivot rows, 0-based
  int* first = pr + w;      // first panel step that swaps the same row p >= e
  int* src = first + w;     // source of row s + i: i < w row s + i, else pr[i − w]
  int* ysrc = src + w;      // source of the row pr[j] (j its first step)
  const int64_t n = N;
  const int64_t mat = blockIdx.y;
  cx<R>* a = LU + mat * n * n;
  const int tid = threadIdx.x;
  const bool right = static_cast<int>(blockIdx.x) >= left_tiles;
  const int c0 = right ? e + (blockIdx.x - left_tiles) * TC : blockIdx.x * TC;
  const int ncols = min(TC, (right ? N : s) - c0);

  if (tid < w) pr[tid] = piv[mat * n + s + tid] - 1;
  if (right)
    stage_to(L, w * w, tid, kSwapTrsmThreads, [&](int idx) {
      const int r = idx / w;
      return a[(s + r) * n + s + idx - r * w];
    });
  __syncthreads();
  if (tid < w) {
    int f = tid;
    if (pr[tid] >= e)
      for (int q = 0; q < tid; ++q)
        if (pr[q] == pr[tid]) {
          f = q;
          break;
        }
    first[tid] = f;
    src[tid] = tid;
    ysrc[tid] = w + tid;
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < w; ++i) {
      const int p = pr[i];
      if (p == s + i) continue;
      int* other = p < e ? &src[p - s] : &ysrc[first[i]];
      const int t = src[i];
      src[i] = *other;
      *other = t;
    }
  __syncthreads();

  // gather: every source read before any row is written
  const cx<R> zero = mk(R(0), R(0));
  stage_to(X, w * TC, tid, kSwapTrsmThreads, [&](int idx) {
    const int r = idx / TC;
    const int c = idx - r * TC;
    const int v = src[r];
    return c < ncols ? a[static_cast<int64_t>(v < w ? s + v : pr[v - w]) * n + c0 + c]
                     : zero;
  });
  stage_to(Y, w * TC, tid, kSwapTrsmThreads, [&](int idx) {
    const int r = idx / TC;
    const int c = idx - r * TC;
    const int y = ysrc[r];
    return c < ncols && pr[r] >= e && first[r] == r
               ? a[static_cast<int64_t>(y < w ? s + y : pr[y - w]) * n + c0 + c]
               : zero;
  });
  __syncthreads();
  for (int idx = tid; idx < w * TC; idx += blockDim.x) {
    const int r = idx / TC;
    const int c = idx - r * TC;
    if (c < ncols && pr[r] >= e && first[r] == r)
      a[static_cast<int64_t>(pr[r]) * n + c0 + c] = Y[idx];
  }
  if (right) {
    // X <- L11⁻¹·X by blocks of BS rows: thread (column cc, group g) keeps
    // rows [g·BS, (g+1)·BS) of its column in registers, subtracts each
    // solved block's contribution, then solves its own block when its turn
    // comes; row r subtracts L[r][q]·x_q for q = 0, 1, ..., r − 1 in order,
    // as a row-by-row solve does. G barriers instead of w − 1.
    constexpr int G = kSwapTrsmThreads / TC;
    constexpr int BS = kMaxTrsmWidth / G;
    const int cc = tid % TC;
    const int g = tid / TC;
    cx<R> acc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int r = g * BS + i;
      acc[i] = r < w ? X[r * TC + cc] : zero;
    }
    for (int b = 0; b < G && b * BS < w; ++b) {
      if (g == b) {
#pragma unroll
        for (int i = 0; i < BS; ++i) {
          const int r = b * BS + i;
#pragma unroll
          for (int q = 0; q < i; ++q)
            acc[i] = sub_mul(acc[i], r < w ? L[r * w + b * BS + q] : zero, acc[q]);
          if (r < w) X[r * TC + cc] = acc[i];
        }
      }
      __syncthreads();
      if (g > b)
        for (int q = 0; q < BS && b * BS + q < w; ++q) {
          const int rq = b * BS + q;
          const cx<R> xq = X[rq * TC + cc];
#pragma unroll
          for (int i = 0; i < BS; ++i) {
            const int r = g * BS + i;
            acc[i] = sub_mul(acc[i], r < w ? L[r * w + rq] : zero, xq);
          }
        }
    }
  }
  for (int idx = tid; idx < w * TC; idx += blockDim.x) {
    const int r = idx / TC;
    const int c = idx - r * TC;
    if (c < ncols) a[(s + r) * n + c0 + c] = X[idx];
  }
}

// ---------------------------------------------------------------------------
// Launchers: each returns a cudaError_t as int (0 on success).

template <typename R>
int launch_panel(void* LU, void* piv, int K, int N, int s, int e, cudaStream_t st) {
  lu_panel_kernel<R><<<K, kPanelThreads, 0, st>>>(static_cast<cx<R>*>(LU),
                                                  static_cast<int*>(piv), N, s, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int cluster_config(int C, int rows_per_cta, int w, size_t* smem) {
  if (C < 1 || C > kMaxClusterSize || w < 1 || w > kMaxClusterWidth ||
      rows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = cluster_smem_bytes<R>(rows_per_cta, w);
  cudaError_t err = cudaFuncSetAttribute(
      lu_panel_cluster_kernel<R>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lu_panel_cluster_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
  return static_cast<int>(err);
}

template <typename R>
int launch_panel_cluster(void* LU, void* piv, int K, int N, int s, int e, int C,
                         cudaStream_t st) {
  const int rows_per_cta = (N - s + C - 1) / C;
  size_t smem = 0;
  int err = cluster_config<R>(C, rows_per_cta, e - s, &smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * K);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e2 = cudaLaunchKernelEx(&cfg, lu_panel_cluster_kernel<R>,
                                      static_cast<cx<R>*>(LU), static_cast<int*>(piv),
                                      N, s, e, rows_per_cta);
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int cluster_occupancy(int C, int rows_per_cta, int w, int* active) {
  size_t smem = 0;
  int err = cluster_config<R>(C, rows_per_cta, w, &smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(active, lu_panel_cluster_kernel<R>, &cfg));
}

template <typename R>
int launch_swap_trsm(void* LU, const void* piv, int K, int N, int s, int e,
                     cudaStream_t st) {
  constexpr int TC = swap_trsm_cols<R>();
  const int w = e - s;
  if (w > kMaxTrsmWidth) return static_cast<int>(cudaErrorInvalidValue);
  const int left = (s + TC - 1) / TC;
  const int right = (N - e + TC - 1) / TC;
  if (left + right == 0) return 0;
  const size_t smem = swap_trsm_smem_bytes<R>(w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lu_swap_trsm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(left + right, K);
  lu_swap_trsm_kernel<R><<<grid, kSwapTrsmThreads, smem, st>>>(
      static_cast<cx<R>*>(LU), static_cast<const int*>(piv), N, s, e, left);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int factor(void* LU, void* piv, int K, int N, int nb, const int* routes,
           cudaStream_t st) {
  if (nb < 1 || nb > kMaxTrsmWidth) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(LU);
  const long long n = N;
  const size_t es = sizeof(cx<R>);
  for (int i = 0, s = 0; s < N; ++i, s += nb) {
    const int e = min(s + nb, N);
    int err = routes[i] > 0 ? launch_panel_cluster<R>(LU, piv, K, N, s, e, routes[i], st)
                            : launch_panel<R>(LU, piv, K, N, s, e, st);
    if (err != 0) return err;
    err = launch_swap_trsm<R>(LU, piv, K, N, s, e, st);
    if (err != 0) return err;
    if (e < N) {
      err = maus_cgemm(base + (e * n + s) * es, base + (s * n + e) * es,
                       base + (e * n + e) * es, sizeof(R) == 8 ? 1 : 0, K, N - e,
                       N - e, e - s, n, n, n, n * n, n * n, n * n, -1.0, 0.0, 1.0,
                       0.0, st);
      if (err != 0) return err;
    }
  }
  return 0;
}

int launch_cluster_barrier(int C, int clusters, int iters, cudaStream_t st) {
  if (C < 1 || C > kMaxClusterSize || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_barrier_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * clusters);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// LU: (K, N, N) contiguous, complex64 (is_c128 = 0) or complex128 (1), factored
// in place; piv: (K, N) int32, 1-based. Columns [s, e) form the panel.

// Factor the panel: columns [s, e) of rows [s, N), pivots piv[:, s:e], with
// the one-block kernel.
extern "C" int maus_lu_panel(void* LU, void* piv, int is_c128, int K, int N, int s,
                             int e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch_panel<double>(LU, piv, K, N, s, e, st);
  return launch_panel<float>(LU, piv, K, N, s, e, st);
}

// The same with the cluster kernel, C CTAs per matrix (e - s <= 64, and the
// slice of ⌈(N − s)/C⌉ rows must fit a CTA's shared memory).
extern "C" int maus_lu_panel_cluster(void* LU, void* piv, int is_c128, int K, int N,
                                     int s, int e, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_c128) return launch_panel_cluster<double>(LU, piv, K, N, s, e, C, st);
  return launch_panel_cluster<float>(LU, piv, K, N, s, e, C, st);
}

// cudaOccupancyMaxActiveClusters of the cluster kernel with C CTAs of
// rows_per_cta rows of a w-column panel each, into *active.
extern "C" int maus_lu_cluster_occupancy(int is_c128, int C, int rows_per_cta, int w,
                                         int* active) {
  if (is_c128) return cluster_occupancy<double>(C, rows_per_cta, w, active);
  return cluster_occupancy<float>(C, rows_per_cta, w, active);
}

// The whole blocked LU of the batch in place, panels of nb <= 64 columns;
// routes[i] is the cluster size for panel i (0: the one-block kernel).
extern "C" int maus_lu_factor(void* LU, void* piv, int is_c128, int K, int N, int nb,
                              const int* routes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_c128) return factor<double>(LU, piv, K, N, nb, routes, st);
  return factor<float>(LU, piv, K, N, nb, routes, st);
}

// `clusters` clusters of C CTAs (the panel kernel's block size), each passing
// `iters` cluster barriers; for timing the barrier.
extern "C" int maus_lu_cluster_barrier(int C, int clusters, int iters, void* stream) {
  return launch_cluster_barrier(C, clusters, iters, static_cast<cudaStream_t>(stream));
}
