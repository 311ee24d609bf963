// The per-scale Frangi tail of the vesselness cascade, for Hopper (sm_90a),
// in two passes split at the frame-wide statistics.
//
// Replaces, per scale, the Hessian, the eigenvalues and the Frangi response
// of nellie_tpu/kernels/frangi.py::vesselness_frame (:151; with _frob_mask
// :93, _frangi_response :105, hessian.py::hessian_components :35 and
// eigen.py::eigvalsh3 :40 / eigvalsh2 :24), which the port's plain torch
// (kernels/frangi.py::hessian_frob_plain and frangi_response_plain over
// hessian.py and eigen.py) computes in hundreds of launches a scale, each a
// full pass over the frame.  Between the two passes the caller takes the
// frame-wide statistics in torch: the largest |Hessian component| over the
// frame, the Frobenius mask's triangle/Otsu threshold and gamma.
//
//   hessian_frob   (pass 1): each voxel's six (3D) or three (2D) Hessian
//                  components from the smoothed block, their Frobenius norm
//                  (written), and the largest |component| over the block's
//                  core box (an atomicMax on the float's bits).
//   frangi_response (pass 2): the components again, the eigenvalues sorted
//                  by |lambda|, the Frangi response, the caller's Frobenius
//                  mask, and in place vessel = max(vessel, v in the carry
//                  type), all_mask &= mask.
//
// Rounding: every step is the plain version's, which is the JAX package's
// on the CPU bit for bit.  The file is built with -fmad=false and without
// fast math; each multiply-add that XLA contracts is an explicit __fmaf_rn
// in the plain version's order, division and square root are IEEE
// (__fdiv_rn, __fsqrt_rn, which equals the plain _fp.sqrt: a float64 root
// rounded to float32), the transcendentals are xla_cpu_math.cuh's.  The
// Hessian follows np.gradient (central inside, one-sided at the block's
// edges) and XLA's fusion of the second derivative along an axis
// (hessian.py::_second_gradient: every diagonal component's edge
// differences contracted; the wrapper passes each axis's rule for the whole
// inner gradient, hessian.fused_axes, which differs between the program
// with the Frobenius mask and the one without: pass 2 with no mask takes
// the latter).  Subnormals are kept except in the
// Frobenius norm's sums, which XLA's CPU code flushes and the plain version
// flushes too (hessian.frobenius_norm); NaN propagates as in torch
// (torch.maximum, torch.clamp), and the response's NaN and infinities
// become 0 (torch.nan_to_num).
//
// What bounds it: pass 1 reads the block (4 bytes a voxel) and writes the
// norm (4); pass 2 reads the block and the mask (5), and reads and writes
// vessel (2 or 4 each way) and all_mask (1 each way).  The arithmetic is
// about 50 float32 operations a voxel in pass 1 and 300 in pass 2 (with
// two cosines in double), so both passes sit near the balance of the two.
// The design recomputes the components in pass 2 from the 5-point
// neighbourhood instead of storing six planes between the passes: that
// keeps the capacity path's peak memory down (six float32 components of a
// 266x272x384 window would be 0.67 GB).  A block of 32 x 8 threads loads
// its outputs and a halo of 2 along each axis into shared memory once (3D:
// 4 planes of 8 x 32 outputs, 8 x 12 x 36 inputs, 3.4 loads an output; 2D:
// 32 x 32 outputs), and every stencil then reads the tile; a thread owns a
// column of outputs, neighbouring threads neighbouring voxels of the last
// axis, so the tile's loads and the outputs' stores are coalesced.  Pass 1
// takes one atomicMax a block.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_cpu_math.cuh"

// The C entry points take these by pointer, so they have external linkage.
namespace frangi_tail {

struct Geometry {
  int ndim;           // 2 or 3
  int n[3];           // 3D: (z, y, x); 2D: (y, x, 1)
  float half[3];      // f32(0.5 / spacing) per axis
  float inv[3];       // f32(1 / spacing) per axis
  int fuse[3];        // per axis, whether its diagonal component fuses its whole inner
                      // gradient (every difference contracted, not the edges' alone)
  int core_lo[3], core_hi[3];  // pass 1's reduction box, [lo, hi) per axis
};

struct Response {
  float alpha_inv, beta_inv;   // f32(1 / alpha_sq), f32(1 / beta_sq)
};

}  // namespace frangi_tail

namespace {

using frangi_tail::Geometry;
using frangi_tail::Response;

// np.gradient of a line at position p (n points), as hessian.gradient
template <class Line>
__device__ __forceinline__ float grad(const Line& line, int p, int n, float half, float inv) {
  if (n < 2) return 0.f;
  if (p == 0) return __fmul_rn(__fsub_rn(line(1), line(0)), inv);
  if (p == n - 1) return __fmul_rn(__fsub_rn(line(n - 1), line(n - 2)), inv);
  return __fmul_rn(__fsub_rn(line(p + 1), line(p - 1)), half);
}

// gradient(gradient(line)) at p as XLA rounds it (hessian._second_gradient)
template <class Line>
__device__ __forceinline__ float second(const Line& line, int p, int n, float half, float inv,
                                        bool fuse) {
  auto g = [&](int q) { return grad(line, q, n, half, inv); };
  if (n < 3) return grad(g, p, n, half, inv);
  if (p == 0)
    return __fmul_rn(__fmaf_rn(__fsub_rn(line(2), line(0)), half, -g(0)), inv);
  if (p == n - 1)
    return __fmul_rn(__fmaf_rn(__fsub_rn(line(n - 1), line(n - 2)), inv, -g(n - 2)), inv);
  if (fuse && n > 3) {
    if (p <= n - 3)
      return __fmul_rn(__fmaf_rn(__fsub_rn(line(p + 2), line(p)), half, -g(p - 1)), half);
    return __fmul_rn(__fmaf_rn(__fsub_rn(line(n - 1), line(n - 2)), inv, -g(n - 3)), half);
  }
  return __fmul_rn(__fsub_rn(g(p + 1), g(p - 1)), half);
}

struct Hessian {
  float xx, xy, xz, yy, yz, zz;  // 2D: xx, xy, yy
};

// The Hessian components at voxel (i, j, k); at(a, b, c) reads the block
// at global indices (within 2 of (i, j, k) along each axis)
template <class At>
__device__ __forceinline__ Hessian hessian3(const At& at, const Geometry& geo, int i, int j,
                                            int k) {
  const int n0 = geo.n[0], n1 = geo.n[1], n2 = geo.n[2];
  // the first derivative along axis 0 (the inner gradient of hxx, hxy, hxz)
  auto g0 = [&](int a, int b, int c) {
    return grad([&](int q) { return at(q, b, c); }, a, n0, geo.half[0], geo.inv[0]);
  };
  auto g1 = [&](int a, int b, int c) {
    return grad([&](int q) { return at(a, q, c); }, b, n1, geo.half[1], geo.inv[1]);
  };
  Hessian h;
  h.xx = second([&](int q) { return at(q, j, k); }, i, n0, geo.half[0], geo.inv[0],
                geo.fuse[0] != 0);
  h.xy = grad([&](int q) { return g0(i, q, k); }, j, n1, geo.half[1], geo.inv[1]);
  h.xz = grad([&](int q) { return g0(i, j, q); }, k, n2, geo.half[2], geo.inv[2]);
  h.yy = second([&](int q) { return at(i, q, k); }, j, n1, geo.half[1], geo.inv[1],
                geo.fuse[1] != 0);
  h.yz = grad([&](int q) { return g1(i, j, q); }, k, n2, geo.half[2], geo.inv[2]);
  h.zz = second([&](int q) { return at(i, j, q); }, k, n2, geo.half[2], geo.inv[2],
                geo.fuse[2] != 0);
  return h;
}

template <class At>
__device__ __forceinline__ Hessian hessian2(const At& at, const Geometry& geo, int i, int j) {
  const int n0 = geo.n[0], n1 = geo.n[1];
  auto g0 = [&](int a, int b) {
    return grad([&](int q) { return at(q, b); }, a, n0, geo.half[0], geo.inv[0]);
  };
  Hessian h;
  h.xx = second([&](int q) { return at(q, j); }, i, n0, geo.half[0], geo.inv[0],
                geo.fuse[0] != 0);
  h.xy = grad([&](int q) { return g0(i, q); }, j, n1, geo.half[1], geo.inv[1]);
  h.yy = second([&](int q) { return at(i, q); }, j, n1, geo.half[1], geo.inv[1],
                geo.fuse[1] != 0);
  h.xz = h.yz = h.zz = 0.f;
  return h;
}

// A block's tile of the input in shared memory: its outputs and HALO
// voxels around them along each axis, indices clamped into the block (a
// clamped copy is never read: the one-sided edge formulas read inside).
// 3D: TZ planes x TY rows x TX columns of outputs, each thread a column
// (j, k) of TZ voxels; 2D: (TY * ROWS) rows x TX columns, each thread ROWS
// rows TY apart.
constexpr int HALO = 2, TX = 32, TY = 8, TZ = 4, ROWS = 4;
constexpr int SX = TX + 2 * HALO, SY3 = TY + 2 * HALO, SZ3 = TZ + 2 * HALO;
constexpr int SY2 = TY * ROWS + 2 * HALO;
constexpr int TILE3 = SZ3 * SY3 * SX, TILE2 = SY2 * SX;

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ void load_tile3(float* tile, const float* __restrict__ f,
                                           const Geometry& geo, int i0, int j0, int k0) {
  const int n0 = geo.n[0], n1 = geo.n[1], n2 = geo.n[2];
  for (int t = threadIdx.y * TX + threadIdx.x; t < TILE3; t += TX * TY) {
    const int c = t % SX, r = t / SX;
    const int b = r % SY3, a = r / SY3;
    const int gi = clampi(i0 - HALO + a, n0 - 1), gj = clampi(j0 - HALO + b, n1 - 1);
    const int gk = clampi(k0 - HALO + c, n2 - 1);
    tile[t] = __ldg(f + (static_cast<long long>(gi) * n1 + gj) * n2 + gk);
  }
}

__device__ __forceinline__ void load_tile2(float* tile, const float* __restrict__ f,
                                           const Geometry& geo, int i0, int j0) {
  const int n0 = geo.n[0], n1 = geo.n[1];
  for (int t = threadIdx.y * TX + threadIdx.x; t < TILE2; t += TX * TY) {
    const int c = t % SX, a = t / SX;
    const int gi = clampi(i0 - HALO + a, n0 - 1), gj = clampi(j0 - HALO + c, n1 - 1);
    tile[t] = __ldg(f + static_cast<long long>(gi) * n1 + gj);
  }
}

struct Tile3 {
  const float* t;
  int i0, j0, k0;
  __device__ __forceinline__ const float* ptr(int a, int b, int c) const {
    return t + ((a - i0 + HALO) * SY3 + (b - j0 + HALO)) * SX + (c - k0 + HALO);
  }
  __device__ __forceinline__ float operator()(int a, int b, int c) const { return *ptr(a, b, c); }
};

struct Tile2 {
  const float* t;
  int i0, j0;
  __device__ __forceinline__ const float* ptr(int a, int b) const {
    return t + (a - i0 + HALO) * SX + (b - j0 + HALO);
  }
  __device__ __forceinline__ float operator()(int a, int b) const { return *ptr(a, b); }
};

// hessian3 at a voxel 2 or more from every face (each axis at least 5
// long): there no edge formula applies, so the same operations, in the
// same order, read the tile at fixed offsets from the voxel, p
__device__ __forceinline__ Hessian hessian3_interior(const float* p, const Geometry& geo) {
  constexpr int sa = SY3 * SX, sb = SX;
  const float h0 = geo.half[0], h1 = geo.half[1], h2 = geo.half[2];
  auto f = [&](int da, int db, int dc) { return p[da * sa + db * sb + dc]; };
  auto d = [](float hi, float lo, float half) { return __fmul_rn(__fsub_rn(hi, lo), half); };
  auto g0 = [&](int da, int db, int dc) { return d(f(da + 1, db, dc), f(da - 1, db, dc), h0); };
  auto g1 = [&](int da, int db, int dc) { return d(f(da, db + 1, dc), f(da, db - 1, dc), h1); };
  auto g2 = [&](int dc) { return d(f(0, 0, dc + 1), f(0, 0, dc - 1), h2); };
  // an interior difference with the whole inner gradient fused
  auto fused = [](float hi, float lo, float g_lo, float half) {
    return __fmul_rn(__fmaf_rn(__fsub_rn(hi, lo), half, -g_lo), half);
  };
  Hessian h;
  h.xx = geo.fuse[0] ? fused(f(2, 0, 0), f(0, 0, 0), g0(-1, 0, 0), h0)
                          : d(g0(1, 0, 0), g0(-1, 0, 0), h0);
  h.xy = d(g0(0, 1, 0), g0(0, -1, 0), h1);
  h.xz = d(g0(0, 0, 1), g0(0, 0, -1), h2);
  h.yy = geo.fuse[1] ? fused(f(0, 2, 0), f(0, 0, 0), g1(0, -1, 0), h1)
                          : d(g1(0, 1, 0), g1(0, -1, 0), h1);
  h.yz = d(g1(0, 0, 1), g1(0, 0, -1), h2);
  h.zz = geo.fuse[2] ? fused(f(0, 0, 2), f(0, 0, 0), g2(-1), h2) : d(g2(1), g2(-1), h2);
  return h;
}

__device__ __forceinline__ Hessian hessian2_interior(const float* p, const Geometry& geo) {
  const float h0 = geo.half[0], h1 = geo.half[1];
  auto f = [&](int da, int db) { return p[da * SX + db]; };
  auto d = [](float hi, float lo, float half) { return __fmul_rn(__fsub_rn(hi, lo), half); };
  auto g0 = [&](int da, int db) { return d(f(da + 1, db), f(da - 1, db), h0); };
  auto g1 = [&](int db) { return d(f(0, db + 1), f(0, db - 1), h1); };
  auto fused = [](float hi, float lo, float g_lo, float half) {
    return __fmul_rn(__fmaf_rn(__fsub_rn(hi, lo), half, -g_lo), half);
  };
  Hessian h;
  h.xx = geo.fuse[0] ? fused(f(2, 0), f(0, 0), g0(-1, 0), h0) : d(g0(1, 0), g0(-1, 0), h0);
  h.xy = d(g0(0, 1), g0(0, -1), h1);
  h.yy = geo.fuse[1] ? fused(f(0, 2), f(0, 0), g1(-1), h1) : d(g1(1), g1(-1), h1);
  h.xz = h.yz = h.zz = 0.f;
  return h;
}

__device__ __forceinline__ bool inside(int p, int n) { return p >= 2 && p <= n - 3; }

template <int NDIM, class At>
__device__ __forceinline__ Hessian hessian_of(const At& at, const Geometry& geo, int i, int j,
                                              int k) {
  if constexpr (NDIM == 3) {
    if (inside(i, geo.n[0]) && inside(j, geo.n[1]) && inside(k, geo.n[2]))
      return hessian3_interior(at.ptr(i, j, k), geo);
    return hessian3(at, geo, i, j, k);
  } else {
    if (inside(i, geo.n[0]) && inside(j, geo.n[1])) return hessian2_interior(at.ptr(i, j), geo);
    return hessian2(at, geo, i, j);
  }
}

// Calls fn(at, i, j, k, v) for each output of this block's tile (at reads
// the tile, v is the output's linear index, k = 0 in 2D), after loading
// the tile.
template <int NDIM, class Fn>
__device__ __forceinline__ void for_each_voxel(float* tile, const float* __restrict__ f,
                                               const Geometry& geo, Fn fn) {
  if constexpr (NDIM == 3) {
    const int n0 = geo.n[0], n1 = geo.n[1], n2 = geo.n[2];
    const int k0 = blockIdx.x * TX, j0 = blockIdx.y * TY, i0 = blockIdx.z * TZ;
    load_tile3(tile, f, geo, i0, j0, k0);
    __syncthreads();
    const int k = k0 + threadIdx.x, j = j0 + threadIdx.y;
    if (k >= n2 || j >= n1) return;
    const Tile3 at{tile, i0, j0, k0};
    for (int t = 0; t < TZ && i0 + t < n0; ++t) {
      const int i = i0 + t;
      fn(at, i, j, k, (static_cast<long long>(i) * n1 + j) * n2 + k);
    }
  } else {
    const int n0 = geo.n[0], n1 = geo.n[1];
    const int j0 = blockIdx.x * TX, i0 = blockIdx.y * TY * ROWS;
    load_tile2(tile, f, geo, i0, j0);
    __syncthreads();
    const int j = j0 + threadIdx.x;
    if (j >= n1) return;
    const Tile2 at{tile, i0, j0};
    for (int t = 0; t < ROWS; ++t) {
      const int i = i0 + threadIdx.y + TY * t;
      if (i >= n0) break;
      fn(at, i, j, 0, static_cast<long long>(i) * n1 + j);
    }
  }
}

// c0^2 + c1^2 (+ c2^2) in XLA's contraction order, each result flushed
__device__ __forceinline__ float flushed_squares(float c0, float c1, float c2, bool three) {
  using xla_cpu::flush;
  float acc = flush(__fmaf_rn(c0, c0, flush(__fmul_rn(c1, c1))));
  if (three) acc = flush(__fmaf_rn(c2, c2, acc));
  return acc;
}

// hessian.frobenius_norm
__device__ __forceinline__ float frobenius(const Hessian& h, bool three) {
  const float diag = flushed_squares(h.xx, h.yy, h.zz, three);
  const float off = three ? flushed_squares(h.xy, h.xz, h.yz, true)
                          : xla_cpu::flush(__fmul_rn(h.xy, h.xy));
  return __fsqrt_rn(xla_cpu::flush(__fadd_rn(diag, __fmul_rn(2.f, off))));
}

__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(fabsf(x)); }

template <int NDIM>
__global__ void __launch_bounds__(TX * TY)
hessian_frob_kernel(const float* __restrict__ f, float* __restrict__ frob,
                    unsigned* __restrict__ largest, Geometry geo) {
  __shared__ float tile[NDIM == 3 ? TILE3 : TILE2];
  __shared__ unsigned warp_top[TX * TY / 32];
  unsigned top = 0;
  for_each_voxel<NDIM>(tile, f, geo, [&](const auto& at, int i, int j, int k, long long v) {
    const Hessian h = hessian_of<NDIM>(at, geo, i, j, k);
    frob[v] = frobenius(h, NDIM == 3);
    const bool core = i >= geo.core_lo[0] && i < geo.core_hi[0] && j >= geo.core_lo[1] &&
                      j < geo.core_hi[1] &&
                      (NDIM == 2 || (k >= geo.core_lo[2] && k < geo.core_hi[2]));
    if (core) {
      // |x| has its sign bit clear, so the bits order as the values, a NaN
      // above +inf: the maximum of the bits is torch's NaN-propagating max
      unsigned m = max(max(abs_bits(h.xx), abs_bits(h.xy)), abs_bits(h.yy));
      if (NDIM == 3) m = max(max(m, abs_bits(h.xz)), max(abs_bits(h.yz), abs_bits(h.zz)));
      top = max(top, m);
    }
  });
  // one atomicMax a block: the warps' maxima, then the block's
  const int thread = threadIdx.y * TX + threadIdx.x, lane = thread & 31, warp = thread >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) top = max(top, __shfl_xor_sync(0xffffffffu, top, off));
  if (lane == 0) warp_top[warp] = top;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int w = 1; w < TX * TY / 32; ++w) top = max(top, warp_top[w]);
    if (top != 0) atomicMax(largest, top);
  }
}

// eigen.eigvalsh2, sorted by |lambda|
__device__ __forceinline__ void eig2(const Hessian& h, float& l1, float& l2) {
  const float trace = __fadd_rn(h.xx, h.yy);
  const float diff = __fsub_rn(h.xx, h.yy);
  const float delta =
      __fsqrt_rn(__fmaf_rn(diff, diff, __fmul_rn(__fmul_rn(4.f, h.xy), h.xy)));
  const float a = __fmul_rn(0.5f, __fsub_rn(trace, delta));
  const float b = __fmul_rn(0.5f, __fadd_rn(trace, delta));
  const bool swap = fabsf(a) > fabsf(b);
  l1 = swap ? b : a;
  l2 = swap ? a : b;
}

// eigen.eigvalsh3 (the trigonometric method on the scaled matrix), sorted
// by |lambda|
__device__ __forceinline__ void eig3(const Hessian& h, float& l1, float& l2, float& l3) {
  using xla_cpu::nan_max;
  constexpr float third = 0x1.555556p-2f, sixth = 0x1.555556p-3f, two_pi_3 = 0x1.0c1524p+1f;
  const float scale = nan_max(nan_max(nan_max(fabsf(h.xx), fabsf(h.yy)),
                                      nan_max(fabsf(h.zz), fabsf(h.xy))),
                              nan_max(fabsf(h.xz), fabsf(h.yz)));
  const bool pos = scale > 0.f;
  const float s = pos ? __fdiv_rn(1.f, scale) : 1.f;
  const float a = __fmul_rn(h.xx, s), b = __fmul_rn(h.yy, s), c = __fmul_rn(h.zz, s);
  const float d = __fmul_rn(h.xy, s), e = __fmul_rn(h.xz, s), f = __fmul_rn(h.yz, s);
  const float trace = __fadd_rn(__fadd_rn(a, b), c);
  const float q = __fmul_rn(trace, third);
  const float p1 = __fmaf_rn(f, f, __fmaf_rn(d, d, __fmul_rn(e, e)));
  const float am = __fmaf_rn(-trace, third, a);
  const float bm = __fmaf_rn(-trace, third, b);
  const float cm = __fmaf_rn(-trace, third, c);
  const float p2 = __fadd_rn(__fmaf_rn(cm, cm, __fmaf_rn(am, am, __fmul_rn(bm, bm))),
                             __fmul_rn(2.f, p1));
  const float p = __fsqrt_rn(__fmul_rn(p2 < 0.f ? 0.f : p2, sixth));
  const float ps = p > 0.f ? p : 1.f;
  const float b00 = __fdiv_rn(am, ps), b11 = __fdiv_rn(bm, ps), b22 = __fdiv_rn(cm, ps);
  const float b01 = __fdiv_rn(d, ps), b02 = __fdiv_rn(e, ps), b12 = __fdiv_rn(f, ps);
  const float minor0 = __fmaf_rn(b11, b22, __fmul_rn(-b12, b12));
  const float minor1 = __fmaf_rn(b01, b22, __fmul_rn(-b12, b02));
  const float minor2 = __fmaf_rn(b01, b12, __fmul_rn(-b11, b02));
  const float det = __fmaf_rn(b02, minor2, __fmaf_rn(b00, minor0, -__fmul_rn(b01, minor1)));
  const float r = xla_cpu::clamp(__fmul_rn(det, 0.5f), -1.f, 1.f);
  const float phi = __fmul_rn(xla_cpu::acos(r), third);
  const float two_p = __fmul_rn(2.f, p);
  float e1 = __fmaf_rn(two_p, xla_cpu::cos(phi), q);
  float e3 = __fmaf_rn(two_p, xla_cpu::cos(__fadd_rn(phi, two_pi_3)), q);
  float e2 = __fsub_rn(__fsub_rn(trace, e1), e3);
  if (p == 0.f) e1 = e2 = e3 = q;
  const float inv_s = pos ? scale : 1.f;
  float x1 = __fmul_rn(e3, inv_s), x2 = __fmul_rn(e2, inv_s), x3 = __fmul_rn(e1, inv_s);
  float t;
  if (fabsf(x1) > fabsf(x2)) { t = x1; x1 = x2; x2 = t; }
  if (fabsf(x2) > fabsf(x3)) { t = x2; x2 = x3; x3 = t; }
  if (fabsf(x1) > fabsf(x2)) { t = x1; x1 = x2; x2 = t; }
  l1 = x1; l2 = x2; l3 = x3;
}

// torch.nan_to_num(v, 0, 0, 0)
__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.f; }

// frangi._frangi_response
__device__ __forceinline__ float response3(const Hessian& h, float gamma_sq, const Response& rp) {
  using xla_cpu::exp;
  constexpr float tiny12 = 0x1.197998p-40f;  // f32(1e-12)
  float l1, l2, l3;
  eig3(h, l1, l2, l3);
  const float a2 = fabsf(l2);
  const float ra = __fdiv_rn(a2, __fadd_rn(fabsf(l3), tiny12));
  const float rb = __fdiv_rn(a2, __fadd_rn(__fsqrt_rn(fabsf(__fmul_rn(l2, l3))), tiny12));
  const float ra_sq = __fmul_rn(ra, ra), rb_sq = __fmul_rn(rb, rb);
  const float s_sq = __fmaf_rn(l3, l3, __fmaf_rn(l1, l1, __fmul_rn(l2, l2)));
  float v = __fmul_rn(__fmul_rn(__fsub_rn(1.f, exp(-__fmul_rn(ra_sq, rp.alpha_inv))),
                                exp(-__fmul_rn(rb_sq, rp.beta_inv))),
                      __fsub_rn(1.f, exp(-__fdiv_rn(s_sq, gamma_sq))));
  if (l3 > 0.f || l2 > 0.f) v = 0.f;
  return finite_or_zero(v);
}

__device__ __forceinline__ float response2(const Hessian& h, float gamma_sq, const Response& rp) {
  using xla_cpu::exp;
  constexpr float tiny12 = 0x1.197998p-40f;
  float l1, l2;
  eig2(h, l1, l2);
  const float rb = __fdiv_rn(fabsf(l1), __fadd_rn(fabsf(l2), tiny12));
  const float s_sq = __fmaf_rn(l1, l1, __fmul_rn(l2, l2));
  float v = __fmul_rn(exp(-__fmul_rn(__fmul_rn(rb, rb), rp.beta_inv)),
                      __fsub_rn(1.f, exp(-__fdiv_rn(s_sq, gamma_sq))));
  if (l2 > 0.f) v = 0.f;
  return finite_or_zero(v);
}

template <int NDIM, typename Carry>
__global__ void __launch_bounds__(TX * TY)
frangi_response_kernel(const float* __restrict__ f, const bool* __restrict__ mask,
                       const float* __restrict__ gamma_sq, Carry* __restrict__ vessel,
                       bool* __restrict__ all_mask, Geometry geo, Response rp) {
  __shared__ float tile[NDIM == 3 ? TILE3 : TILE2];
  const float g2 = __ldg(gamma_sq);
  for_each_voxel<NDIM>(tile, f, geo, [&](const auto& at, int i, int j, int k, long long v) {
    const bool m = mask == nullptr || mask[v];
    float resp = 0.f;
    if (m) {
      const Hessian h = hessian_of<NDIM>(at, geo, i, j, k);
      resp = NDIM == 3 ? response3(h, g2, rp) : response2(h, g2, rp);
    }
    // vessel = torch.maximum(vessel, v.to(carry)); v is finite and >= 0
    if constexpr (sizeof(Carry) == 2) {
      const __half cur = vessel[v];
      const __half val = __float2half_rn(resp);
      vessel[v] = __hgt(val, cur) || __hisnan(val) ? val : cur;
    } else {
      vessel[v] = xla_cpu::nan_max(vessel[v], resp);
    }
    if (!m) all_mask[v] = false;
  });
}

dim3 grid_of(const Geometry& geo) {
  if (geo.ndim == 3)
    return dim3((geo.n[2] + TX - 1) / TX, (geo.n[1] + TY - 1) / TY, (geo.n[0] + TZ - 1) / TZ);
  return dim3((geo.n[1] + TX - 1) / TX, (geo.n[0] + TY * ROWS - 1) / (TY * ROWS), 1);
}

bool valid(const Geometry& geo, long long total) {
  if (geo.ndim != 2 && geo.ndim != 3) return false;
  long long n = 1;
  for (int a = 0; a < geo.ndim; ++a) {
    if (geo.n[a] < 1) return false;
    n *= geo.n[a];
  }
  const dim3 g = grid_of(geo);
  return n == total && total > 0 && g.y <= 65535 && g.z <= 65535;
}

}  // namespace

extern "C" {

// Pass 1.  f: the smoothed block, total float32 voxels in C order over
// geo.n[0..ndim); writes frob (total float32) and raises *largest (the bits
// of a non-negative float32, 0 before the first call) to the largest
// |component| over the core box.
int hessian_frob(const float* f, float* frob, unsigned* largest, const Geometry* geo,
                 long long total, void* stream) {
  if (!valid(*geo, total)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(TX, TY);
  if (geo->ndim == 3)
    hessian_frob_kernel<3><<<grid_of(*geo), block, 0, s>>>(f, frob, largest, *geo);
  else
    hessian_frob_kernel<2><<<grid_of(*geo), block, 0, s>>>(f, frob, largest, *geo);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  f as in pass 1; mask (total bools) or null for all true;
// gamma_sq: one float32 on the device; vessel: total float32 (half_carry 0)
// or float16 (half_carry 1), updated in place; all_mask: total bools,
// updated in place.
int frangi_response(const float* f, const bool* mask, const float* gamma_sq, void* vessel,
                    int half_carry, bool* all_mask, const Geometry* geo, float alpha_inv,
                    float beta_inv, long long total, void* stream) {
  if (!valid(*geo, total)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Response rp{alpha_inv, beta_inv};
  const dim3 grid = grid_of(*geo), block(TX, TY);
  if (geo->ndim == 3) {
    if (half_carry)
      frangi_response_kernel<3, __half><<<grid, block, 0, s>>>(
          f, mask, gamma_sq, static_cast<__half*>(vessel), all_mask, *geo, rp);
    else
      frangi_response_kernel<3, float><<<grid, block, 0, s>>>(
          f, mask, gamma_sq, static_cast<float*>(vessel), all_mask, *geo, rp);
  } else {
    if (half_carry)
      frangi_response_kernel<2, __half><<<grid, block, 0, s>>>(
          f, mask, gamma_sq, static_cast<__half*>(vessel), all_mask, *geo, rp);
    else
      frangi_response_kernel<2, float><<<grid, block, 0, s>>>(
          f, mask, gamma_sq, static_cast<float*>(vessel), all_mask, *geo, rp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
