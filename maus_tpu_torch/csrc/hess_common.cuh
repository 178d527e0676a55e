// Complex arithmetic, the Givens rotations and the layouts of the triangular
// factor shared by the shifted-Hessenberg solves: K2 (hess_solve_rq.cu, and
// its QR form hess_solve.cu), P1 and P2 (hess_stream_v2.cu,
// hess_stream_v3.cu) and the row-loop bodies of P1 and P2 (hess_solve_v2.cu,
// hess_solve_v3.cu). Templated on the real type R (float for complex64,
// double for complex128).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace maus {

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
template <typename R>
__device__ __forceinline__ cx<R> add(cx<R> a, cx<R> b) {
  return mk(a.re + b.re, a.im + b.im);
}
template <typename R>
__device__ __forceinline__ cx<R> sub(cx<R> a, cx<R> b) {
  return mk(a.re - b.re, a.im - b.im);
}
template <typename R>
__device__ __forceinline__ cx<R> mul(cx<R> a, cx<R> b) {
  return mk(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
template <typename R>
__device__ __forceinline__ cx<R> scale(R c, cx<R> a) {
  return mk(c * a.re, c * a.im);
}
template <typename R>
__device__ __forceinline__ cx<R> conj(cx<R> a) {
  return mk(a.re, -a.im);
}

// Real-valued math of the element type R, by overload (r = real).
__device__ __forceinline__ float rhypot(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double rhypot(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float rsqroot(float a) { return sqrtf(a); }
__device__ __forceinline__ double rsqroot(double a) { return sqrt(a); }
__device__ __forceinline__ float rrsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rrsqrt(double a) { return rsqrt(a); }
__device__ __forceinline__ float rmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double rmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float rabs(float a) { return fabsf(a); }
__device__ __forceinline__ double rabs(double a) { return fabs(a); }
__device__ __forceinline__ float rinf(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double rinf(double) {
  return __longlong_as_double(0x7ff0000000000000ULL);
}

// a / d by Smith-style scaling, so a tiny or huge d neither over- nor
// underflows its squared modulus.
template <typename R>
__device__ __forceinline__ cx<R> cdiv(cx<R> a, cx<R> d) {
  const R s = rabs(d.re) + rabs(d.im);
  const cx<R> as = mk(a.re / s, a.im / s);
  const cx<R> ds = mk(d.re / s, d.im / s);
  const R den = ds.re * ds.re + ds.im * ds.im;
  const cx<R> n = mul(as, conj(ds));
  return mk(n.re / den, n.im / den);
}

// The complex Givens rotation of maus_tpu/ops/hessenberg.py::_hess_solve_scan:
// c = |a|/r, s = sign(a)·conj(b)/r with r = sqrt(|a|² + |b|²), sign(0) = 1,
// and the identity rotation when b = 0.
template <typename R>
__device__ __forceinline__ void givens(cx<R> a, cx<R> b, R& c, cx<R>& s) {
  const R absa = rhypot(a.re, a.im);
  const R absb = rhypot(b.re, b.im);
  if (absb > R(0)) {
    const R r = rsqroot(rmax(absa * absa + absb * absb, R(1e-30)));
    const cx<R> sg = absa > R(0) ? scale(R(1) / rmax(absa, R(1e-30)), a)
                                 : mk(R(1), R(0));
    c = absa / r;
    s = scale(R(1) / r, mul(sg, conj(b)));
  } else {
    c = R(1);
    s = mk(R(0), R(0));
  }
}

// Below this |a|² an entry counts as zero in a rotation's sign, and the
// floor on |a|² and |a|² + |b|² under a rsqrt.
template <typename R>
__device__ __forceinline__ R tiny();
template <>
__device__ __forceinline__ float tiny<float>() { return 1e-37f; }
template <>
__device__ __forceinline__ double tiny<double>() { return 1e-300; }

// P2's divide-free rotation (benchmarks/hess_v3_probe.py:67-81): with
// u = rsqrt(|a|²)·rsqrt(|a|² + |b|²), c = |a|²·u = |a|/r and
// s = a·conj(b)·u = sign(a)·conj(b)/r; sign 1 when |a|² <= tiny
// (s = conj(b)/r); the identity when b = 0.
template <typename R>
__device__ __forceinline__ void givens_rsqrt(cx<R> a, cx<R> b, R& c, cx<R>& s) {
  const R a2 = a.re * a.re + a.im * a.im;
  const R b2 = b.re * b.re + b.im * b.im;
  if (b2 > R(0)) {
    const R inv_r = rrsqrt(rmax(a2 + b2, tiny<R>()));
    const R u = rrsqrt(rmax(a2, tiny<R>())) * inv_r;
    c = a2 * u;
    s = a2 <= tiny<R>() ? scale(inv_r, conj(b)) : scale(u, mul(a, conj(b)));
  } else {
    c = R(1);
    s = mk(R(0), R(0));
  }
}

// ---- the triangular factor of P1 and P2 -------------------------------------
constexpr int kBS = 64;                  // back-substitution block width
constexpr int kTileStride = kBS + 1;     // a staged tile: column-major, padded

// Index of R's element (row, col), col >= row, in a candidate's triangular
// factor. P1 packs rows (row j holds columns j..N-1). P2 keeps column tiles
// of width kBS: tile t holds columns [t·kBS, (t+1)·kBS) of rows
// 0..min(N, (t+1)·kBS)-1, row-major with a row stride of kBS, so the rows
// of one block within one tile are one contiguous run.
__device__ __forceinline__ size_t tile_offset(int t) {
  const size_t tt = static_cast<size_t>(t);
  return tt * (tt + 1) / 2 * static_cast<size_t>(kBS * kBS);
}
template <bool kV3>
__device__ __forceinline__ size_t r_index(int row, int col, int N) {
  const size_t r = static_cast<size_t>(row);
  if constexpr (kV3) {
    const int t = col / kBS;
    return tile_offset(t) + r * kBS + static_cast<size_t>(col - t * kBS);
  } else {
    return r * static_cast<size_t>(N) - r * (r - 1) / 2 +
           static_cast<size_t>(col - row);
  }
}

// Elements of one candidate's triangular factor in the layout of r_index.
inline size_t r_elems(int N, bool v3) {
  const size_t n = static_cast<size_t>(N);
  if (!v3) return n * (n + 1) / 2;
  const size_t nb = (n + kBS - 1) / kBS;
  return (nb - 1) * nb / 2 * kBS * kBS + n * kBS;
}

template <typename R>
__device__ __forceinline__ cx<R> warp_sum(cx<R> v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.re += __shfl_xor_sync(0xffffffffu, v.re, off);
    v.im += __shfl_xor_sync(0xffffffffu, v.im, off);
  }
  return v;
}

}  // namespace maus
