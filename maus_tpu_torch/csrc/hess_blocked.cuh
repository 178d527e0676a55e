// The row-loop body of P1 and P2 (their first CUDA form), kept as the
// yardstick of their redesign (hess_stream.cuh) on no solver path: the
// batched shifted upper-Hessenberg solve with a blocked back substitution,
// one block a candidate, for P1 (hess_solve_v2.cu, kV3 = false) and P2
// (hess_solve_v3.cu, kV3 = true). Both compute K2's function,
//   (H + s_k I) w_k = b_k   for k = 0..K-1, one shared upper-Hessenberg H,
// with K2's contract (hess_solve.cu): any K, N >= 1, complex64 or complex128,
// a forward sweep of complex Givens rotations (identity when b = 0, sign 1
// when a = 0), and a non-finite row when the triangular factor has an
// exact-zero diagonal. The design notes are in the two .cu files. With
// sweep_only the kernel stops after the forward sweep and W holds the
// rotated right-hand side y: the sweep's share of the time.
#pragma once

#include "hess_common.cuh"

namespace maus {
namespace blocked {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename R, bool kV3>
__global__ void __launch_bounds__(kThreads)
hess_solve_blocked_kernel(const cx<R>* __restrict__ H,
                          const cx<R>* __restrict__ shifts,
                          const cx<R>* __restrict__ B, cx<R>* __restrict__ W,
                          cx<R>* __restrict__ Rall, cx<R>* __restrict__ gcur,
                          int N, size_t r_elems, int sweep_only) {
  extern __shared__ unsigned char smem_raw[];
  cx<R>* ys = reinterpret_cast<cx<R>*>(smem_raw);  // kBS: a block's rhs
  cx<R>* Ts = ys + kBS;                            // kBS·kTileStride tile
  const size_t k = blockIdx.x;
  const size_t n = static_cast<size_t>(N);
  cx<R>* cur = gcur != nullptr ? gcur + k * n : Ts + kBS * kTileStride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const cx<R> sh = shifts[k];
  const cx<R>* b = B + k * n;
  cx<R>* w = W + k * n;
  cx<R>* Rk = Rall + k * r_elems;
  const cx<R> zero = mk(R(0), R(0));

  // ---- forward Givens sweep (K2's, with P2's rotation for kV3) -----------
  for (int col = tid; col < N; col += kThreads) {
    cx<R> v = H[col];
    if (col == 0) v = add(v, sh);
    cur[col] = v;
  }
  cx<R> ycur = b[0];
  __syncthreads();
  for (int j = 0; j < N - 1; ++j) {
    const cx<R>* hrow = H + static_cast<size_t>(j + 1) * n;
    const cx<R> a = cur[j];
    const cx<R> bb = hrow[j];  // shared subdiagonal pivot H[j+1, j]
    R c;
    cx<R> s;
    if constexpr (kV3) {
      givens_rsqrt(a, bb, c, s);
    } else {
      givens(a, bb, c, s);
    }
    const cx<R> ms = mk(-s.re, s.im);  // -conj(s)
    for (int col = j + tid; col < N; col += kThreads) {
      cx<R> f = hrow[col];
      if (col == j + 1) f = add(f, sh);
      const cx<R> o = col == j ? a : cur[col];
      Rk[r_index<kV3>(j, col, N)] = add(scale(c, o), mul(s, f));
      if (col > j) cur[col] = add(mul(ms, o), scale(c, f));
    }
    const cx<R> yn = b[j + 1];
    if (tid == 0) w[j] = add(scale(c, ycur), mul(s, yn));
    ycur = add(mul(ms, ycur), scale(c, yn));
    __syncthreads();
  }
  if (tid == 0) {
    Rk[r_index<kV3>(N - 1, N - 1, N)] = cur[N - 1];
    w[N - 1] = ycur;
  }
  if (sweep_only) return;
  __syncthreads();

  // ---- blocked back substitution -------------------------------------------
  // x[c1..N-1] lives where the carried row was; W holds y, then x.
  cx<R>* xs = cur;
  for (int c0 = ((N - 1) / kBS) * kBS; c0 >= 0; c0 -= kBS) {
    const int c1 = min(N, c0 + kBS);
    // phase A, one warp per row i of the block: stage R[i, i..c1) into the
    // tile and take the dot of R[i, c1..N) with the solved x, reading each
    // element of R once; lanes walk neighbouring columns, four loads in
    // flight each.
    for (int i = c0 + warp; i < c1; i += kWarps) {
      const int il = i - c0;
      for (int col = i + lane; col < c1; col += 32)
        Ts[(col - c0) * kTileStride + il] = Rk[r_index<kV3>(i, col, N)];
      cx<R> a0 = zero, a1 = zero, a2 = zero, a3 = zero;
      int col = c1 + lane;
      for (; col + 96 < N; col += 128) {
        const cx<R> r0 = Rk[r_index<kV3>(i, col, N)];
        const cx<R> r1 = Rk[r_index<kV3>(i, col + 32, N)];
        const cx<R> r2 = Rk[r_index<kV3>(i, col + 64, N)];
        const cx<R> r3 = Rk[r_index<kV3>(i, col + 96, N)];
        a0 = add(a0, mul(r0, xs[col]));
        a1 = add(a1, mul(r1, xs[col + 32]));
        a2 = add(a2, mul(r2, xs[col + 64]));
        a3 = add(a3, mul(r3, xs[col + 96]));
      }
      for (; col < N; col += 32) a0 = add(a0, mul(Rk[r_index<kV3>(i, col, N)], xs[col]));
      const cx<R> dot = warp_sum(add(add(a0, a1), add(a2, a3)));
      if (lane == 0) ys[il] = sub(w[i], dot);
    }
    __syncthreads();
    // phase B, one warp: the block's recurrence from the staged tile, column
    // by column (x_jj, then y_t -= T[t, jj]·x_jj for the rows above), lane l
    // holding rows l and l + 32; one shuffle per column, no block barrier.
    if (warp == 0) {
      const int bw = c1 - c0;
      cx<R> y0 = lane < bw ? ys[lane] : zero;
      cx<R> y1 = lane + 32 < bw ? ys[lane + 32] : zero;
      cx<R> rc0 = zero, rc1 = zero;
      R bad0 = R(0), bad1 = R(0);
      if constexpr (kV3) {
        // the reciprocal of each diagonal, once per block: no divide in the
        // recurrence (inf where the diagonal is an exact zero)
        const cx<R> d0 = lane < bw ? Ts[lane * kTileStride + lane] : zero;
        const cx<R> d1 = lane + 32 < bw ? Ts[(lane + 32) * kTileStride + lane + 32]
                                        : zero;
        const R den0 = d0.re * d0.re + d0.im * d0.im;
        const R den1 = d1.re * d1.re + d1.im * d1.im;
        const R inv0 = den0 > R(0) ? R(1) / den0 : R(0);
        const R inv1 = den1 > R(0) ? R(1) / den1 : R(0);
        rc0 = mk(d0.re * inv0, -d0.im * inv0);
        rc1 = mk(d1.re * inv1, -d1.im * inv1);
        bad0 = den0 > R(0) ? R(0) : rinf(R(0));
        bad1 = den1 > R(0) ? R(0) : rinf(R(0));
      }
      for (int jj = bw - 1; jj >= 0; --jj) {
        const bool hi = jj >= 32;
        const cx<R> num = hi ? y1 : y0;
        cx<R> xj;
        if constexpr (kV3) {
          const cx<R> rc = hi ? rc1 : rc0;
          const R bad = hi ? bad1 : bad0;
          xj = mk(num.re * rc.re - num.im * rc.im + bad,
                  num.re * rc.im + num.im * rc.re + bad);
        } else {
          const cx<R> d = Ts[jj * kTileStride + jj];
          xj = (d.re != R(0) || d.im != R(0)) ? cdiv(num, d)
                                              : mk(rinf(R(0)), R(0));
        }
        xj.re = __shfl_sync(0xffffffffu, xj.re, jj & 31);
        xj.im = __shfl_sync(0xffffffffu, xj.im, jj & 31);
        const cx<R>* tcol = Ts + jj * kTileStride;
        if constexpr (kV3) {
          // no triangularity mask: the rows at and below jj are solved, and
          // rows past the block's width are never read
          y0 = sub(y0, mul(tcol[lane], xj));
          y1 = sub(y1, mul(tcol[lane + 32], xj));
        } else {
          if (lane < jj) y0 = sub(y0, mul(tcol[lane], xj));
          if (lane + 32 < jj) y1 = sub(y1, mul(tcol[lane + 32], xj));
        }
        if (lane == 0) {
          xs[c0 + jj] = xj;
          w[c0 + jj] = xj;
        }
      }
    }
    __syncthreads();
  }
}

template <typename R, bool kV3>
int launch(const void* H, const void* shifts, const void* B, void* W, void* Rs,
           void* cur_scratch, int K, int N, int sweep_only, cudaStream_t stream) {
  const size_t smem = sizeof(cx<R>) *
      (kBS + kBS * kTileStride +
       (cur_scratch != nullptr ? 0 : static_cast<size_t>(N)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hess_solve_blocked_kernel<R, kV3>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hess_solve_blocked_kernel<R, kV3><<<K, kThreads, smem, stream>>>(
      static_cast<const cx<R>*>(H), static_cast<const cx<R>*>(shifts),
      static_cast<const cx<R>*>(B), static_cast<cx<R>*>(W),
      static_cast<cx<R>*>(Rs), static_cast<cx<R>*>(cur_scratch), N,
      r_elems(N, kV3), sweep_only);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace blocked
}  // namespace maus
