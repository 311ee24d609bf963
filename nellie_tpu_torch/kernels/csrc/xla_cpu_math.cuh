// XLA's CPU transcendentals as the port's plain torch mirrors them
// (kernels/_fp.py), for device code, bit for bit.
//
// The reference runs on XLA's CPU backend, whose exp is a Cephes polynomial
// with fused multiply-adds, whose cos is glibc's cosf (its FMA build's
// reduction, in double) and whose acos is fdlibm's atan2f of
// (sqrt((1 - x)(1 + x)), x).  Each function below is the same sequence of
// IEEE operations as its _fp counterpart: every fused multiply-add is an
// explicit __fmaf_rn, and the file that includes this header is built with
// -fmad=false and without fast math, so that the compiler contracts nothing
// else and every other add, multiply, divide and square root rounds once,
// to nearest (as the torch ops do on the CPU and on the card).  Subnormals
// are kept (no -ftz): _fp keeps them too, except where a flush is written.
//
// Constants are the float32 (or double) values the plain versions use,
// written in hexadecimal.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace xla_cpu {

constexpr float kTiny = 0x1p-126f;  // the smallest normal float32

// a subnormal result flushed to a zero of its sign (_fp.flush)
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kTiny ? __fmul_rn(x, 0.f) : x;
}

// NaN-propagating minimum and maximum (torch.minimum / torch.maximum)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// _fp.exp: XLA's CPU exp
__device__ __forceinline__ float exp(float x) {
  constexpr float kP[6] = {0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.111210p-7f,
                           0x1.555382p-5f,  0x1.555554p-3f,  0x1.0p-1f};
  x = clamp(x, -0x1.5f3334p+6f, 0x1.633334p+6f);
  float n = floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f));
  n = clamp(n, -127.f, 127.f);
  float r = __fmaf_rn(-0x1.63p-1f, n, x);
  r = __fmaf_rn(0x1.bd0106p-13f, n, r);
  float z = __fmaf_rn(r, kP[0], kP[1]);
#pragma unroll
  for (int i = 2; i < 6; ++i) z = __fmaf_rn(z, r, kP[i]);
  z = __fadd_rn(1.f, __fmaf_rn(z, __fmul_rn(r, r), r));
  const int e = n == n ? static_cast<int>(n) : 0;
  const float y = __fmul_rn(z, __int_as_float((e + 127) << 23));
  return y < kTiny ? 0.f : y;
}

// _fp._cos_poly and _fp._sin_poly (double, no contraction)
__device__ __forceinline__ double cos_poly(double x2, double sign) {
  const double x4 = __dmul_rn(x2, x2);
  const double c2 = __dadd_rn(__dmul_rn(-0x1.6c087e89a359dp-10, sign),
                              __dmul_rn(x2, __dmul_rn(0x1.99343027bf8c3p-16, sign)));
  const double c1 = __dadd_rn(__dmul_rn(0x1p0, sign),
                              __dmul_rn(x2, __dmul_rn(-0x1.ffffffd0c621cp-2, sign)));
  const double c = __dadd_rn(c1, __dmul_rn(x4, __dmul_rn(0x1.55553e1068f19p-5, sign)));
  return __dadd_rn(c, __dmul_rn(__dmul_rn(x4, x2), c2));
}

__device__ __forceinline__ double sin_poly(double x, double x2) {
  const double x3 = __dmul_rn(x, x2);
  const double s1 = __dadd_rn(0x1.1107605230bc4p-7, __dmul_rn(x2, -0x1.994eb3774cf24p-13));
  return __dadd_rn(__dadd_rn(x, __dmul_rn(x3, -0x1.555545995a603p-3)),
                   __dmul_rn(__dmul_rn(x3, x2), s1));
}

// _fp.cos: glibc's cosf, for |y| below 2**7 (the plain version's range too)
__device__ __forceinline__ float cos(float y) {
  if (y != y) return y;
  const double x = static_cast<double>(y);
  const unsigned top = (__float_as_uint(fabsf(y)) >> 20) & 0x7FF;
  if (top < 0x3f4) {  // |y| < π/4 by glibc's top-12-bit test
    if (top < 0x398) return 1.f;
    return __double2float_rn(cos_poly(__dmul_rn(x, x), 1.0));
  }
  const int n = (__double2int_rz(__dmul_rn(x, 0x1.45f306dc9c883p+23)) + 0x800000) >> 24;
  const double nd = static_cast<double>(n);
  const double r = __dsub_rn(__dsub_rn(x, __dmul_rn(nd, 0x1.921fb54442c00p+0)),
                             __dmul_rn(nd, 0x1.18p-44));
  const int quadrant = n & 3;
  const double sign = (quadrant == 1 || quadrant == 2) ? -1.0 : 1.0;
  const double table = (n & 2) ? -1.0 : 1.0;
  const double r2 = __dmul_rn(r, r);
  const double out = (n & 1) == 0 ? cos_poly(r2, table) : sin_poly(__dmul_rn(r, sign), r2);
  return __double2float_rn(out);
}

// _fp._atan_abs: fdlibm's atanf of a finite x >= 0 (float arithmetic)
__device__ __forceinline__ float atan_abs(float x) {
  constexpr float kHi[4] = {0x1.dac670p-2f, 0x1.921fb4p-1f, 0x1.f730bcp-1f, 0x1.921fb4p+0f};
  constexpr float kLo[4] = {0x1.586ed2p-28f, 0x1.4442d0p-25f, 0x1.281f68p-25f, 0x1.4442d0p-24f};
  constexpr float kT[11] = {0x1.555556p-2f,  -0x1.99999ap-3f, 0x1.24924ap-3f, -0x1.c71c70p-4f,
                            0x1.745cdcp-4f,  -0x1.3b0f2ap-4f, 0x1.10d66ap-4f, -0x1.dde2d6p-5f,
                            0x1.97b4b2p-5f,  -0x1.2b4442p-5f, 0x1.0ad3aep-6f};
  const int ix = __float_as_int(x);
  if (ix >= 0x4C000000) return 0x1.921fb6p+0f;  // f32(atan_hi[3] + atan_lo[3])
  const int band = (ix >= 0x3EE00000) + (ix >= 0x3F300000) + (ix >= 0x3F980000) +
                   (ix >= 0x401C0000);
  float xr;
  switch (band) {
    case 0: xr = x; break;
    case 1: xr = __fdiv_rn(__fsub_rn(__fmul_rn(2.f, x), 1.f), __fadd_rn(2.f, x)); break;
    case 2: xr = __fdiv_rn(__fsub_rn(x, 1.f), __fadd_rn(x, 1.f)); break;
    case 3: xr = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.f, __fmul_rn(1.5f, x))); break;
    default: xr = __fdiv_rn(-1.f, x); break;
  }
  const float z = __fmul_rn(xr, xr);
  const float w = __fmul_rn(z, z);
  float s1 = kT[10];
#pragma unroll
  for (int k = 8; k >= 0; k -= 2) s1 = __fadd_rn(kT[k], __fmul_rn(w, s1));
  float s2 = kT[9];
#pragma unroll
  for (int k = 7; k >= 1; k -= 2) s2 = __fadd_rn(kT[k], __fmul_rn(w, s2));
  const float poly = __fmul_rn(xr, __fadd_rn(__fmul_rn(z, s1), __fmul_rn(w, s2)));
  if (band == 0) return __fsub_rn(xr, poly);
  return __fsub_rn(kHi[band - 1], __fsub_rn(__fsub_rn(poly, kLo[band - 1]), xr));
}

// _fp.atan2: fdlibm's atan2f
__device__ __forceinline__ float atan2(float y, float x) {
  constexpr float kPi = 0x1.921fb6p+1f, kPiLo = -0x1.777a5cp-24f, kPiO2 = 0x1.921fb6p+0f;
  if (x != x || y != y) return __fadd_rn(x, y);
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
  if (iy == 0) {
    const int quadrant = ((hy >> 31) & 1) | ((hx >> 30) & 2);
    return quadrant < 2 ? y : (quadrant == 2 ? kPi : -kPi);
  }
  if (ix == 0) return hy < 0 ? -kPiO2 : kPiO2;
  if (hx == 0x3F800000) {
    const float a = atan_abs(fabsf(y));
    return hy < 0 ? -a : a;
  }
  const int k = (iy - ix) >> 23;
  float z = atan_abs(fabsf(__fdiv_rn(y, x)));
  if (k > 60) z = 0x1.921fb6p+0f;  // f32(π/2 + f32(π_lo / 2))
  if (hx < 0 && k < -60) z = 0.f;
  const int quadrant = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  switch (quadrant) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(kPi, __fsub_rn(z, kPiLo));
    default: return __fsub_rn(__fsub_rn(z, kPiLo), kPi);
  }
}

// _fp.acos: atan2(sqrt((1 - x)(1 + x)), x), the root correctly rounded
__device__ __forceinline__ float acos(float x) {
  return atan2(__fsqrt_rn(__fmul_rn(__fsub_rn(1.f, x), __fadd_rn(1.f, x))), x);
}

}  // namespace xla_cpu
