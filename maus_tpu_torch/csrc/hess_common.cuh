// Complex arithmetic and the Givens rotation shared by the shifted-Hessenberg
// solves: K2 (hess_solve.cu) and its two variants P1 (hess_solve_v2.cu) and
// P2 (hess_solve_v3.cu). Templated on the real type R (float for complex64,
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

}  // namespace maus
