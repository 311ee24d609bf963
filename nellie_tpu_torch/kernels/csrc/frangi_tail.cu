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
//                  core box (one atomicMax on the float's bits a block).
//   frangi_response (pass 2): the components again at the voxels of the
//                  caller's Frobenius mask, the eigenvalues sorted by
//                  |lambda| and the Frangi response there, and in place
//                  vessel = max(vessel, v in the carry type) (v = 0 outside
//                  the mask), all_mask &= mask.
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
// the latter).  Subnormals are kept except in the Frobenius norm's sums,
// which XLA's CPU code flushes and the plain version flushes too
// (hessian.frobenius_norm); NaN propagates as in torch (torch.maximum,
// torch.clamp), and the response's NaN and infinities become 0
// (torch.nan_to_num).
//
// What bounds it: pass 1 reads the block (4 bytes a voxel) and writes the
// norm (4); pass 2 reads the mask and reads and writes vessel and all_mask
// everywhere, and reads the block; at the mask's voxels (about a third on
// the 3D main path) it does about 280 float32 operations, with nine IEEE
// divisions, and 44 float64 ones (the two cosines).  By those counts both
// passes are bound by bytes; on the card both issue-bound stencil work and
// the latency of the eigen-solve's dependent chains hold them back (PERF.md).
// The design, in 3D:
//  * a tile is 16 x 64 output voxels of a plane and a segment of planes
//    along the first axis, which the block marches through; a persistent
//    grid of one wave walks the tiles, whose segment length the host picks
//    so that the wave's rounds come out even (pass 2, whose work follows
//    the mask, three tiles a block or more);
//  * a ring of seven input planes in shared memory (the five the stencil
//    reaches and two in flight): cp.async 16-byte copies where the last axis
//    is a multiple of 4, two planes ahead;
//  * each plane's first derivatives are computed once into shared memory
//    (along the march axis for three planes, along the other two for this
//    one), with np.gradient's edge formulas at the block's faces and the
//    same operations on the same operands as the plain version's, and every
//    output reads them four at a time with 16-byte reads; where an output
//    lies at a face along an axis, only the components that differentiate
//    along it take the edge formulas (a plane, a row or a lane at a time),
//    and where an axis is shorter than five, every component does;
//  * pass 2 appends each masked voxel's components and position to a queue
//    in shared memory (a warp's scan, one atomicAdd a warp), and when the
//    queue holds a full round for every thread, or the tile ends, every
//    thread solves dense entries (eigenvalues, response) and updates its
//    voxel's carry: the lanes never idle through a voxel outside the mask.
//    The voxels outside the mask update vessel and all_mask four at a time
//    (float4 or four halves, four bytes).
// In 2D a plane is a row, and a block loads one tile of 32 x 32 outputs and
// their halo once and computes it (pass 2 at the voxel: the 2D eigen-solve
// has no trigonometry); see "2D: one-shot tiles".
// No component planes are stored between the passes: that keeps the
// capacity path's peak memory down (six float32 components of a
// 266x272x384 window would be 0.67 GB).
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

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

// gradient(gradient(line)) at p as XLA rounds it (hessian._second_gradient),
// g(q) = grad(line, q, ...): every diagonal component's edge differences
// contracted, and with fuse its whole inner gradient
template <class Line, class Grad>
__device__ __forceinline__ float second(const Line& line, const Grad& g, int p, int n, float half,
                                        float inv, bool fuse) {
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

// Multiply, multiply-add, add and square root that flush a subnormal input
// or result to a zero of its sign (PTX's .ftz).  In the Frobenius norm's sums
// they equal xla_cpu::flush of the plain result: the sums' terms are squares
// and sums of squares, and a subnormal operand there contributes less than
// half an ulp of the other term or flushes with the product anyway.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float sqrt_ftz(float a) {
  float d;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(d) : "f"(a));
  return d;
}

// c0^2 + c1^2 (+ c2^2) in XLA's contraction order, each result flushed
__device__ __forceinline__ float flushed_squares(float c0, float c1, float c2, bool three) {
  float acc = fma_ftz(c0, c0, mul_ftz(c1, c1));
  if (three) acc = fma_ftz(c2, c2, acc);
  return acc;
}

// hessian.frobenius_norm: the root of a flushed sum (normal or 0), so the
// flushing root rounds as the IEEE one
__device__ __forceinline__ float frobenius(const Hessian& h, bool three) {
  const float diag = flushed_squares(h.xx, h.yy, h.zz, three);
  const float off = three ? flushed_squares(h.xy, h.xz, h.yz, true) : mul_ftz(h.xy, h.xy);
  return sqrt_ftz(add_ftz(diag, __fmul_rn(2.f, off)));
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

__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(fabsf(x)); }

// The largest |component| as its bits: |x| has its sign bit clear, so the
// bits order as the values, a NaN above +inf, and the maximum of the bits is
// torch's NaN-propagating max
__device__ __forceinline__ unsigned biggest(const Hessian& h, bool three) {
  unsigned m = max(max(abs_bits(h.xx), abs_bits(h.xy)), abs_bits(h.yy));
  if (three) m = max(max(m, abs_bits(h.xz)), max(abs_bits(h.yz), abs_bits(h.zz)));
  return m;
}

// One atomicMax a block of the threads' tops (the warps' maxima, then the
// block's) into *largest; warp_top holds a slot a warp
__device__ __forceinline__ void block_max(unsigned top, unsigned* warp_top, int warps,
                                          unsigned* largest) {
  const int thread = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = thread & 31, warp = thread >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) top = max(top, __shfl_xor_sync(0xffffffffu, top, off));
  if (lane == 0) warp_top[warp] = top;
  __syncthreads();
  if (thread == 0) {
    for (int w = 1; w < warps; ++w) top = max(top, warp_top[w]);
    if (top != 0) atomicMax(largest, top);
  }
}

// vessel = torch.maximum(vessel, v.to(carry)) for the carry types
__device__ __forceinline__ float carry_max(float cur, float v) { return xla_cpu::nan_max(cur, v); }

__device__ __forceinline__ __half carry_max(__half cur, float v) {
  const __half val = __float2half_rn(v);
  return __hgt(val, cur) || __hisnan(val) ? val : cur;
}

// ---------------------------------------------------------------------------
// 3D: the plane-marching tiles
// ---------------------------------------------------------------------------

// Measured on the card (NVIDIA H100 80GB HBM3, the 3D main path's largest
// calls): two planes in flight, and registers capped for three blocks an SM
// in pass 1 and two in pass 2 (three spill), beat one plane and the uncapped
// counts (about 150 registers, one block an SM in pass 2); pass 2's work
// follows the Frobenius mask, which clusters, so its blocks take three
// tiles each or more, spread over the block, where one tile a block left
// the wave waiting on the densest tiles
constexpr int AHEAD = 2;                   // input planes in flight
constexpr int RING = 5 + AHEAD;            // the input planes z - 2 .. z + 2 and those in flight
constexpr int PASS1_BLOCKS = 3, PASS2_BLOCKS = 2;  // __launch_bounds__' blocks an SM
constexpr int PASS2_ROUNDS = 3;            // pass 2's least tiles a block, where the axis allows
constexpr int PAD = 4;   // columns kept on each side of a tile (2 read): 16-byte rows

// A tile is TY rows by TX columns of outputs in each plane of a segment of
// planes along z; a thread owns four consecutive outputs of a row.  HY: the
// rows kept above and below the tile.
struct Layout {
  static constexpr int TY = 16, HY = 2, TX = 64;
  static constexpr int THREADS = TY * TX / 4;
  static constexpr int RY = TY + 2 * HY;     // rows of a ring plane
  static constexpr int RC = TX + 2 * PAD;    // columns of every plane in shared memory
  static constexpr int GH = 1;               // rows of the first derivatives beyond the tile
  static constexpr int GY = TY + 2 * GH;
  static constexpr int PLANE = RY * RC;
  static constexpr int NC = 6;               // components a queued voxel
  // the queue: less than a round for every thread left over, plus a plane
  static constexpr int QCAP = 5 * THREADS;
  // offsets in floats: the ring, three planes of d/dz, d/dy, d/dx, the queue
  static constexpr int G0_AT = RING * PLANE;
  static constexpr int G1_AT = G0_AT + 3 * GY * RC;
  static constexpr int G2_AT = G1_AT + GY * RC;
  static constexpr int Q_AT = G2_AT + TY * RC;
  static constexpr int FLOATS_PASS1 = Q_AT;
  static constexpr int FLOATS_PASS2 = Q_AT + QCAP * (NC + 1) + 4;
};

// The tiles of one launch over a (nz, ny, nx) block
struct Plan {
  int nz, ny, nx;
  int tiles_x, tiles_y, zseg;
  long long tiles;
  int vec;       // nx % 4 == 0 and every pointer 16-byte aligned: 16-byte copies, 4-wide I/O
  float h[3];    // f32(0.5 / spacing)
  float inv[3];  // f32(1 / spacing)
  int fuse[3];
  int core_lo[3], core_hi[3];
};

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int K>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

__device__ __forceinline__ int ring_slot(int z) { return (z + 2) % RING; }  // z >= -2
__device__ __forceinline__ int g0_slot(int z) { return (z + 1) % 3; }       // z >= -1

// Starts the copy of plane z of the tile at (y0, x0) into its ring slot
// (nothing for a plane outside the block); the rows and columns outside the
// block are left as they are and never read
__device__ __forceinline__ void load_plane(float* ring, const float* __restrict__ f,
                                           const Plan& p, int z, int y0, int x0) {
  using L = Layout;
  if (z < 0 || z >= p.nz) return;
  float* dst = ring + ring_slot(z) * L::PLANE;
  const float* src = f + static_cast<long long>(z) * p.ny * p.nx;
  if (p.vec) {
    constexpr int CH = L::RC / 4;
    for (int q = threadIdx.x; q < L::RY * CH; q += L::THREADS) {
      const int r = q / CH, c = (q - r * CH) * 4;
      const int y = y0 - L::HY + r, x = x0 - PAD + c;
      if (y >= 0 && y < p.ny && x >= 0 && x < p.nx)
        copy16(dst + r * L::RC + c, src + static_cast<long long>(y) * p.nx + x);
    }
  } else {
    for (int q = threadIdx.x; q < L::PLANE; q += L::THREADS) {
      const int r = q / L::RC, c = q - r * L::RC;
      const int y = y0 - L::HY + r, x = x0 - PAD + c;
      if (y >= 0 && y < p.ny && x >= 0 && x < p.nx)
        copy4(dst + q, src + static_cast<long long>(y) * p.nx + x);
    }
  }
}

__device__ __forceinline__ float diff(float hi, float lo, float half) {
  return __fmul_rn(__fsub_rn(hi, lo), half);
}

// an interior second difference with the whole inner gradient fused
__device__ __forceinline__ float fused(float hi, float lo, float g_lo, float half) {
  return __fmul_rn(__fmaf_rn(__fsub_rn(hi, lo), half, -g_lo), half);
}

struct Four {
  float v[4];
};

__device__ __forceinline__ Four ld4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return Four{{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ void st4(float* p, const Four& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

struct Six {
  float v[6];  // p[-1 .. 4]
};

__device__ __forceinline__ Six ld6(const float* p) {
  const Four m = ld4(p);
  return Six{{p[-1], m.v[0], m.v[1], m.v[2], m.v[3], p[4]}};
}

// The first derivatives of the tile as np.gradient takes them (central
// inside, one-sided at the block's faces, 0 along an axis of one point),
// over every position of its planes in shared memory (those outside the
// block are never read).  d/dz of plane z into its slot of three:
__device__ __forceinline__ void d_dz(float* smem, const Plan& p, int z) {
  using L = Layout;
  constexpr int CH = L::RC / 4;
  if (z < 0 || z >= p.nz) return;
  const bool edge = z == 0 || z == p.nz - 1;
  const float* up = smem + ring_slot(z == p.nz - 1 ? z : z + 1) * L::PLANE;
  const float* dn = smem + ring_slot(z == 0 ? z : z - 1) * L::PLANE;
  const float factor = edge ? p.inv[0] : p.h[0];
  float* g0 = smem + L::G0_AT + g0_slot(z) * L::GY * L::RC;
  for (int q = threadIdx.x; q < L::GY * CH; q += L::THREADS) {
    const int gr = q / CH, c = (q - gr * CH) * 4;
    const int at = (gr + L::HY - L::GH) * L::RC + c;
    const Four hi = ld4(up + at), lo = ld4(dn + at);
    Four out;
#pragma unroll
    for (int e = 0; e < 4; ++e) out.v[e] = p.nz < 2 ? 0.f : diff(hi.v[e], lo.v[e], factor);
    st4(g0 + gr * L::RC + c, out);
  }
}

// d/dy and d/dx of plane z
__device__ __forceinline__ void d_dy_dx(float* smem, const Plan& p, int z, int y0, int x0) {
  using L = Layout;
  constexpr int CH = L::RC / 4;
  const float* at_z = smem + ring_slot(z) * L::PLANE;
  float* g1 = smem + L::G1_AT;
  for (int q = threadIdx.x; q < L::GY * CH; q += L::THREADS) {
    const int gr = q / CH, c = (q - gr * CH) * 4;
    const int y = y0 - L::GH + gr;
    if (y < 0 || y >= p.ny) continue;
    const int at = (gr + L::HY - L::GH) * L::RC + c;
    const bool edge = y == 0 || y == p.ny - 1;
    const Four hi = ld4(at_z + at + (y == p.ny - 1 ? 0 : L::RC));
    const Four lo = ld4(at_z + at - (y == 0 ? 0 : L::RC));
    Four out;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out.v[e] = p.ny < 2 ? 0.f : diff(hi.v[e], lo.v[e], edge ? p.inv[1] : p.h[1]);
    st4(g1 + gr * L::RC + c, out);
  }
  float* g2 = smem + L::G2_AT;
  for (int q = threadIdx.x; q < L::TY * CH; q += L::THREADS) {
    const int r = q / CH, c = (q - r * CH) * 4;
    const float* row = at_z + (r + L::HY) * L::RC + c;
    // the first and last chunks have a neighbour outside the row: their
    // outermost column is never read
    const Four m = ld4(row);
    const float left = c > 0 ? row[-1] : m.v[0];
    const float right = c + 4 < L::RC ? row[4] : m.v[3];
    const float s[6] = {left, m.v[0], m.v[1], m.v[2], m.v[3], right};
    const int x = x0 - PAD + c;
    Four out;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (p.nx < 2)
        out.v[e] = 0.f;
      else if (x + e == 0)
        out.v[e] = diff(s[e + 2], s[e + 1], p.inv[2]);
      else if (x + e == p.nx - 1)
        out.v[e] = diff(s[e + 1], s[e], p.inv[2]);
      else
        out.v[e] = diff(s[e + 2], s[e], p.h[2]);
    }
    st4(g2 + r * L::RC + c, out);
  }
}

// The components of four consecutive outputs two or more from every face,
// from the first derivatives (the same operations in the same order as
// hessian3 takes inside)
__device__ __forceinline__ void interior_four(const float* smem, const Plan& p, int z, int r,
                                              int c, Hessian h[4]) {
  using L = Layout;
  const float* ring_z = smem + ring_slot(z) * L::PLANE;
  const int at_f = (r + L::HY) * L::RC + PAD + c;  // (y, x) in a ring plane
  const int at_g = (r + L::GH) * L::RC + PAD + c;  // in the planes of d/dz and d/dy
  const float* g0 = smem + L::G0_AT;
  const float* g0_z = g0 + g0_slot(z) * L::GY * L::RC;
  const float* g0_lo = g0 + g0_slot(z - 1) * L::GY * L::RC;
  Four xx_hi, xx_lo = ld4(g0_lo + at_g);
  const bool fuse0 = p.fuse[0] != 0;
  if (fuse0) {
    xx_hi = ld4(smem + ring_slot(z + 2) * L::PLANE + at_f);
  } else {
    xx_hi = ld4(g0 + g0_slot(z + 1) * L::GY * L::RC + at_g);
  }
  const Four here = ld4(ring_z + at_f);
  const Six gz_x = ld6(g0_z + at_g);
  const Six g2 = ld6(smem + L::G2_AT + r * L::RC + PAD + c);
  const Four f_lo = ld4(ring_z + at_f);  // x + 0 .. x + 5
  const float f_x[6] = {f_lo.v[0], f_lo.v[1], f_lo.v[2], f_lo.v[3], ring_z[at_f + 4],
                        ring_z[at_f + 5]};
  const bool fuse2 = p.fuse[2] != 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e].xx = fuse0 ? fused(xx_hi.v[e], here.v[e], xx_lo.v[e], p.h[0])
                    : diff(xx_hi.v[e], xx_lo.v[e], p.h[0]);
    h[e].xz = diff(gz_x.v[e + 2], gz_x.v[e], p.h[2]);
    h[e].zz = fuse2 ? fused(f_x[e + 2], f_x[e], g2.v[e], p.h[2])
                    : diff(g2.v[e + 2], g2.v[e], p.h[2]);
  }
  const Four gz_up = ld4(g0_z + at_g + L::RC), gz_dn = ld4(g0_z + at_g - L::RC);
  const float* g1 = smem + L::G1_AT;
  const Four gy_dn = ld4(g1 + at_g - L::RC);
  const Six gy_x = ld6(g1 + at_g);
  const bool fuse1 = p.fuse[1] != 0;
  Four yy_hi;
  if (fuse1)
    yy_hi = ld4(ring_z + at_f + 2 * L::RC);
  else
    yy_hi = ld4(g1 + at_g + L::RC);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e].xy = diff(gz_up.v[e], gz_dn.v[e], p.h[1]);
    h[e].yy = fuse1 ? fused(yy_hi.v[e], here.v[e], gy_dn.v[e], p.h[1])
                    : diff(yy_hi.v[e], gy_dn.v[e], p.h[1]);
    h[e].yz = diff(gy_x.v[e + 2], gy_x.v[e], p.h[2]);
  }
}

// The components at output (z, y0 + r, x0 + col) with the plain version's
// edge formulas along each axis, from the ring and the first derivatives
// (hessian_components)
__device__ __forceinline__ Hessian at_edge(const float* smem, const Plan& p, int z, int y0,
                                           int x0, int r, int col) {
  using L = Layout;
  const int y = y0 + r, x = x0 + col;
  auto f = [&](int a, int b, int c) {  // the input at block indices
    return smem[ring_slot(a) * L::PLANE + (b - y0 + L::HY) * L::RC + (c - x0 + PAD)];
  };
  auto g0 = [&](int a, int b, int c) {  // d/dz
    return smem[L::G0_AT + g0_slot(a) * L::GY * L::RC + (b - y0 + L::GH) * L::RC + (c - x0 + PAD)];
  };
  auto g1 = [&](int b, int c) {  // d/dy of plane z
    return smem[L::G1_AT + (b - y0 + L::GH) * L::RC + (c - x0 + PAD)];
  };
  auto g2 = [&](int c) { return smem[L::G2_AT + r * L::RC + (c - x0 + PAD)]; };  // d/dx
  Hessian h;
  h.xx = second([&](int q) { return f(q, y, x); }, [&](int q) { return g0(q, y, x); }, z, p.nz,
                p.h[0], p.inv[0], p.fuse[0] != 0);
  h.xy = grad([&](int q) { return g0(z, q, x); }, y, p.ny, p.h[1], p.inv[1]);
  h.xz = grad([&](int q) { return g0(z, y, q); }, x, p.nx, p.h[2], p.inv[2]);
  h.yy = second([&](int q) { return f(z, q, x); }, [&](int q) { return g1(q, x); }, y, p.ny,
                p.h[1], p.inv[1], p.fuse[1] != 0);
  h.yz = grad([&](int q) { return g1(y, q); }, x, p.nx, p.h[2], p.inv[2]);
  h.zz = second([&](int q) { return f(z, y, q); }, g2, x, p.nx, p.h[2], p.inv[2],
                p.fuse[2] != 0);
  return h;
}

// Whether np.gradient's edge formulas apply at position q of an axis of n:
// its ends, and for a fused diagonal component the one before the last end;
// elsewhere the interior formulas give the same operations
__device__ __forceinline__ bool at_face(int q, int n, int fuse) {
  return q == 0 || q == n - 1 || (fuse && q == n - 2);
}

// The components at output (z, y0 + r, x0 + c + e) for the lanes e < count
// (the row's outputs inside the block): four at a time by the interior
// formulas, then, where an output lies at a face along an axis, the
// components that differentiate along it by the edge formulas (a plane and
// a row at a time, a lane along x); every component by the edge formulas
// where an axis is shorter than 5
__device__ __forceinline__ void components(const float* smem, const Plan& p, int z, int y0,
                                           int x0, int r, int c, int count, Hessian h[4]) {
  using L = Layout;
  const int y = y0 + r, x = x0 + c;
  if (p.nz < 5 || p.ny < 5 || p.nx < 5) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < count) h[e] = at_edge(smem, p, z, y0, x0, r, c + e);
    return;
  }
  interior_four(smem, p, z, r, c, h);
  auto f = [&](int a, int b, int cc) {  // the input at block indices
    return smem[ring_slot(a) * L::PLANE + (b - y0 + L::HY) * L::RC + (cc - x0 + PAD)];
  };
  auto g0 = [&](int a, int b, int cc) {  // d/dz
    return smem[L::G0_AT + g0_slot(a) * L::GY * L::RC + (b - y0 + L::GH) * L::RC +
                (cc - x0 + PAD)];
  };
  auto g1 = [&](int b, int cc) {  // d/dy of plane z
    return smem[L::G1_AT + (b - y0 + L::GH) * L::RC + (cc - x0 + PAD)];
  };
  if (at_face(z, p.nz, p.fuse[0])) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= count) break;
      h[e].xx = second([&](int q) { return f(q, y, x + e); },
                       [&](int q) { return g0(q, y, x + e); }, z, p.nz, p.h[0], p.inv[0],
                       p.fuse[0] != 0);
    }
  }
  if (at_face(y, p.ny, p.fuse[1])) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= count) break;
      h[e].xy = grad([&](int q) { return g0(z, q, x + e); }, y, p.ny, p.h[1], p.inv[1]);
      h[e].yy = second([&](int q) { return f(z, q, x + e); },
                       [&](int q) { return g1(q, x + e); }, y, p.ny, p.h[1], p.inv[1],
                       p.fuse[1] != 0);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e >= count) break;
    if (!at_face(x + e, p.nx, p.fuse[2])) continue;
    h[e].xz = grad([&](int q) { return g0(z, y, q); }, x + e, p.nx, p.h[2], p.inv[2]);
    h[e].yz = grad([&](int q) { return g1(y, q); }, x + e, p.nx, p.h[2], p.inv[2]);
    h[e].zz = second([&](int q) { return f(z, y, q); },
                     [&](int q) { return smem[L::G2_AT + r * L::RC + (q - x0 + PAD)]; },
                     x + e, p.nx, p.h[2], p.inv[2], p.fuse[2] != 0);
  }
}

__device__ __forceinline__ void tile_origin(const Plan& p, long long t, int& za, int& zb, int& y0,
                                            int& x0) {
  using L = Layout;
  const long long rest = t / p.tiles_x;
  x0 = static_cast<int>(t - rest * p.tiles_x) * L::TX;
  y0 = static_cast<int>(rest % p.tiles_y) * L::TY;
  za = static_cast<int>(rest / p.tiles_y) * p.zseg;
  zb = min(p.nz, za + p.zseg);
}

// Marches the block's tiles plane by plane: at each output plane z the ring
// holds z - 2 .. z + 2 (z + 3 in flight) and the first derivatives are in
// place; plane(z, y0, x0) does the pass's work, tile_end(za, y0, x0) runs
// after a tile's last plane.  Every thread calls both.
template <class PlaneFn, class EndFn>
__device__ __forceinline__ void march(float* smem, const float* __restrict__ f, const Plan& p,
                                      const PlaneFn& plane, const EndFn& tile_end) {
  for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int za, zb, y0, x0;
    tile_origin(p, t, za, zb, y0, x0);
    for (int z = za - 2; z <= za + 2; ++z) load_plane(smem, f, p, z, y0, x0);
    commit();
    wait_groups<0>();
    for (int z = za + 3; z < za + 2 + AHEAD; ++z) {
      if (z <= zb + 1) load_plane(smem, f, p, z, y0, x0);
      commit();
    }
    __syncthreads();
    d_dz(smem, p, za - 1);
    d_dz(smem, p, za);
    __syncthreads();
    for (int z = za; z < zb; ++z) {
      if (z + 2 + AHEAD <= zb + 1) load_plane(smem, f, p, z + 2 + AHEAD, y0, x0);
      commit();
      wait_groups<AHEAD>();  // plane z + 2 has landed
      __syncthreads();
      d_dz(smem, p, z + 1);
      d_dy_dx(smem, p, z, y0, x0);
      __syncthreads();
      plane(z, za, y0, x0);
      __syncthreads();
    }
    tile_end(za, y0, x0);
    wait_groups<0>();
    __syncthreads();
  }
}

__global__ void __launch_bounds__(Layout::THREADS, PASS1_BLOCKS)
hessian_frob_3d(const float* __restrict__ f, float* __restrict__ frob,
                unsigned* __restrict__ largest, const Plan p) {
  using L = Layout;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned warp_top[L::THREADS / 32];
  const int r = threadIdx.x / (L::TX / 4), c = threadIdx.x % (L::TX / 4) * 4;
  unsigned top = 0;
  march(
      smem, f, p,
      [&](int z, int, int y0, int x0) {
        auto core = [&](int y, int x) {
          return z >= p.core_lo[0] && z < p.core_hi[0] && y >= p.core_lo[1] &&
                 y < p.core_hi[1] && x >= p.core_lo[2] && x < p.core_hi[2];
        };
        const int y = y0 + r, x = x0 + c;
        const int count = y < p.ny ? max(0, min(4, p.nx - x)) : 0;
        if (count == 0) return;
        Hessian h[4];
        components(smem, p, z, y0, x0, r, c, count, h);
        const long long v = (static_cast<long long>(z) * p.ny + y) * p.nx + x;
        if (count == 4 && p.vec) {
          Four f4;
#pragma unroll
          for (int e = 0; e < 4; ++e) f4.v[e] = frobenius(h[e], true);
          st4(frob + v, f4);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < count) frob[v + e] = frobenius(h[e], true);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < count && core(y, x + e)) top = max(top, biggest(h[e], true));
      },
      [](int, int, int) {});
  block_max(top, warp_top, L::THREADS / 32, largest);
}

// Four consecutive carries at p (16-byte aligned for float, 8 for half)
template <typename Carry>
struct CarryFour {
  Carry v[4];
};

template <typename Carry>
__device__ __forceinline__ CarryFour<Carry> load_carry4(const Carry* p) {
  CarryFour<Carry> out;
  if constexpr (sizeof(Carry) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out.v[0] = q.x, out.v[1] = q.y, out.v[2] = q.z, out.v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __half2 a = *reinterpret_cast<const __half2*>(&q.x), b = *reinterpret_cast<const __half2*>(&q.y);
    out.v[0] = __low2half(a), out.v[1] = __high2half(a), out.v[2] = __low2half(b),
    out.v[3] = __high2half(b);
  }
  return out;
}

template <typename Carry>
__device__ __forceinline__ void store_carry4(Carry* p, const CarryFour<Carry>& a) {
  if constexpr (sizeof(Carry) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
    const __half2 lo = __halves2half2(a.v[0], a.v[1]), hi = __halves2half2(a.v[2], a.v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  }
}

template <typename Carry>
__global__ void __launch_bounds__(Layout::THREADS, PASS2_BLOCKS)
frangi_response_3d(const float* __restrict__ f, const unsigned char* __restrict__ mask,
                   const float* __restrict__ gamma_sq, Carry* __restrict__ vessel,
                   unsigned char* __restrict__ all_mask, const Plan p, const Response rp) {
  using L = Layout;
  extern __shared__ __align__(16) float smem[];
  float* qc = smem + L::Q_AT;  // the queue: component k of entry e at qc[k * QCAP + e]
  unsigned* qpos = reinterpret_cast<unsigned*>(qc + L::NC * L::QCAP);  // the entry's voxel
  int* qcount = reinterpret_cast<int*>(qpos + L::QCAP);
  if (threadIdx.x == 0) *qcount = 0;
  __syncthreads();
  const float g2 = __ldg(gamma_sq);
  const int lane = threadIdx.x & 31;
  // the first of k places in the queue for this thread, the warp's places
  // taken with one atomicAdd (every lane of the warp calls it)
  auto enqueue = [&](int k) {
    int incl = k;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int below = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += below;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(qcount, incl);
    return __shfl_sync(0xffffffffu, base, 31) + incl - k;
  };
  // an entry: the components and the position in the tile (plane, row, column)
  auto put = [&](int e, const Hessian& h, int plane, int row, int col) {
    qc[e] = h.xx;
    qc[L::QCAP + e] = h.xy;
    qc[2 * L::QCAP + e] = h.yy;
    qc[3 * L::QCAP + e] = h.xz;
    qc[4 * L::QCAP + e] = h.yz;
    qc[5 * L::QCAP + e] = h.zz;
    qpos[e] = static_cast<unsigned>((plane * L::TY + row) * L::TX + col);
  };
  const int r = threadIdx.x / (L::TX / 4), c = threadIdx.x % (L::TX / 4) * 4;

  // entry e: the response at its voxel (tile-relative position: plane, row,
  // column) and the carry's update there
  auto solve = [&](int e, int za, int y0, int x0) {
    const unsigned pos = qpos[e];
    const int col = pos % L::TX, row = pos / L::TX % L::TY;
    const int z = za + static_cast<int>(pos / (L::TX * L::TY));
    const long long v = (static_cast<long long>(z) * p.ny + y0 + row) * p.nx + x0 + col;
    Hessian h;
    h.xx = qc[e];
    h.xy = qc[L::QCAP + e];
    h.yy = qc[2 * L::QCAP + e];
    h.xz = qc[3 * L::QCAP + e];
    h.yz = qc[4 * L::QCAP + e];
    h.zz = qc[5 * L::QCAP + e];
    vessel[v] = carry_max(vessel[v], response3(h, g2, rp));
  };
  // solves the queue's full rounds (all its entries at a tile's end) and
  // moves what is left to its front
  auto drain = [&](int za, int y0, int x0, bool all) {
    const int n = *qcount;
    const int done = all ? n : n / L::THREADS * L::THREADS;
    if (done == 0) return;
    for (int e = threadIdx.x; e < done; e += L::THREADS) solve(e, za, y0, x0);
    __syncthreads();
    const int rest = n - done;
    if (static_cast<int>(threadIdx.x) < rest) {  // rest < THREADS <= done: no overlap
#pragma unroll
      for (int k = 0; k < L::NC; ++k) qc[k * L::QCAP + threadIdx.x] = qc[k * L::QCAP + done + threadIdx.x];
      qpos[threadIdx.x] = qpos[done + threadIdx.x];
    }
    __syncthreads();
    if (threadIdx.x == 0) *qcount = rest;
    __syncthreads();
  };

  march(
      smem, f, p,
      [&](int z, int za, int y0, int x0) {
        const int y = y0 + r, x = x0 + c;
        const int count = y < p.ny ? max(0, min(4, p.nx - x)) : 0;
        const long long v = (static_cast<long long>(z) * p.ny + y) * p.nx + x;
        bool m[4] = {false, false, false, false};
        if (count == 4 && p.vec && mask != nullptr) {
          const uchar4 q = *reinterpret_cast<const uchar4*>(mask + v);
          m[0] = q.x != 0, m[1] = q.y != 0, m[2] = q.z != 0, m[3] = q.w != 0;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < count) m[e] = mask == nullptr || mask[v + e] != 0;
        }
        unsigned mine = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (m[e]) mine |= 1u << e;
        Hessian h[4];
        if (mine) components(smem, p, z, y0, x0, r, c, count, h);
        int base = enqueue(__popc(mine));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (mine >> e & 1) put(base++, h[e], z - za, r, c + e);
        // the voxels outside the mask: vessel = max(vessel, 0), all_mask = false
        int masked = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) masked += m[e];
        if (masked < count) {
          if (count == 4 && p.vec) {
            CarryFour<Carry> cur = load_carry4(vessel + v);
            uchar4 a = *reinterpret_cast<const uchar4*>(all_mask + v);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!m[e]) cur.v[e] = carry_max(cur.v[e], 0.f);
            a.x &= m[0], a.y &= m[1], a.z &= m[2], a.w &= m[3];
            store_carry4(vessel + v, cur);
            *reinterpret_cast<uchar4*>(all_mask + v) = a;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (e >= count) break;
              if (m[e]) continue;
              vessel[v + e] = carry_max(vessel[v + e], 0.f);
              all_mask[v + e] = 0;
            }
          }
        }
        __syncthreads();
        drain(za, y0, x0, false);
      },
      [&](int za, int y0, int x0) { drain(za, y0, x0, true); });
}

// ---------------------------------------------------------------------------
// 2D: one-shot tiles
// ---------------------------------------------------------------------------

// A 2D block has no axis to march along that a tile would reuse: a plane
// is a row.  A block of TX2 x TY2 threads loads a tile of its
// (TY2 * ROWS2) x TX2 outputs and HALO inputs around them once, each thread
// then takes ROWS2 rows TY2 apart.  The 2D eigen-solve is short (one root,
// no trigonometry), so pass 2 solves at the voxel and queues nothing.
// Measured on the card (NVIDIA H100 80GB HBM3, the 2D main path's largest
// calls, 1024 x 1024): tiles of one row of 256 outputs marched along the
// first axis took 1.3x (pass 1) and 2.3x (pass 2) the time of these.
constexpr int HALO = 2, TX2 = 32, TY2 = 8, ROWS2 = 4;
constexpr int SX2 = TX2 + 2 * HALO, SY2 = TY2 * ROWS2 + 2 * HALO;

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The tile at (i0, j0), its indices clamped into the block (a clamped copy
// is never read: the one-sided edge formulas read inside)
__device__ __forceinline__ void load_tile2(float* tile, const float* __restrict__ f,
                                           const Geometry& geo, int i0, int j0) {
  const int n0 = geo.n[0], n1 = geo.n[1];
  for (int t = threadIdx.y * TX2 + threadIdx.x; t < SY2 * SX2; t += TX2 * TY2) {
    const int c = t % SX2, a = t / SX2;
    const int gi = clampi(i0 - HALO + a, n0 - 1), gj = clampi(j0 - HALO + c, n1 - 1);
    tile[t] = __ldg(f + static_cast<long long>(gi) * n1 + gj);
  }
}

// hessian2 at (i, j) with np.gradient's edge formulas; at(a, b) reads the
// block at global indices within 2 of (i, j)
template <class At>
__device__ __forceinline__ Hessian hessian2(const At& at, const Geometry& geo, int i, int j) {
  const int n0 = geo.n[0], n1 = geo.n[1];
  auto g0 = [&](int a, int b) {
    return grad([&](int q) { return at(q, b); }, a, n0, geo.half[0], geo.inv[0]);
  };
  auto g1 = [&](int b) {
    return grad([&](int q) { return at(i, q); }, b, n1, geo.half[1], geo.inv[1]);
  };
  Hessian h;
  h.xx = second([&](int q) { return at(q, j); }, [&](int q) { return g0(q, j); }, i, n0,
                geo.half[0], geo.inv[0], geo.fuse[0] != 0);
  h.xy = grad([&](int q) { return g0(i, q); }, j, n1, geo.half[1], geo.inv[1]);
  h.yy = second([&](int q) { return at(i, q); }, g1, j, n1, geo.half[1], geo.inv[1],
                geo.fuse[1] != 0);
  h.xz = h.yz = h.zz = 0.f;
  return h;
}

// hessian2 at a voxel 2 or more from every face: the same operations, in
// the same order, at fixed offsets from the voxel's place in the tile, p
__device__ __forceinline__ Hessian hessian2_interior(const float* p, const Geometry& geo) {
  const float h0 = geo.half[0], h1 = geo.half[1];
  auto f = [&](int da, int db) { return p[da * SX2 + db]; };
  auto g0 = [&](int da, int db) { return diff(f(da + 1, db), f(da - 1, db), h0); };
  auto g1 = [&](int db) { return diff(f(0, db + 1), f(0, db - 1), h1); };
  Hessian h;
  h.xx = geo.fuse[0] ? fused(f(2, 0), f(0, 0), g0(-1, 0), h0) : diff(g0(1, 0), g0(-1, 0), h0);
  h.xy = diff(g0(0, 1), g0(0, -1), h1);
  h.yy = geo.fuse[1] ? fused(f(0, 2), f(0, 0), g1(-1), h1) : diff(g1(1), g1(-1), h1);
  h.xz = h.yz = h.zz = 0.f;
  return h;
}

struct Tile2 {
  const float* t;
  int i0, j0;
  __device__ __forceinline__ const float* ptr(int a, int b) const {
    return t + (a - i0 + HALO) * SX2 + (b - j0 + HALO);
  }
  __device__ __forceinline__ float operator()(int a, int b) const { return *ptr(a, b); }
  __device__ __forceinline__ Hessian hessian(const Geometry& geo, int a, int b) const {
    if (a >= 2 && a <= geo.n[0] - 3 && b >= 2 && b <= geo.n[1] - 3)
      return hessian2_interior(ptr(a, b), geo);
    return hessian2(*this, geo, a, b);
  }
};

// Loads this block's tile, then calls fn(at, i, j, v) for each of this
// thread's outputs (v: the output's linear index)
template <class Fn>
__device__ __forceinline__ void for_each_2d(float* tile, const float* __restrict__ f,
                                            const Geometry& geo, const Fn& fn) {
  const int j0 = blockIdx.x * TX2, i0 = blockIdx.y * TY2 * ROWS2;
  load_tile2(tile, f, geo, i0, j0);
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= geo.n[1]) return;
  const Tile2 at{tile, i0, j0};
  for (int t = 0; t < ROWS2; ++t) {
    const int i = i0 + threadIdx.y + TY2 * t;
    if (i >= geo.n[0]) break;
    fn(at, i, j, static_cast<long long>(i) * geo.n[1] + j);
  }
}

__global__ void __launch_bounds__(TX2 * TY2)
hessian_frob_2d(const float* __restrict__ f, float* __restrict__ frob,
                unsigned* __restrict__ largest, const Geometry geo) {
  __shared__ float tile[SY2 * SX2];
  __shared__ unsigned warp_top[TX2 * TY2 / 32];
  unsigned top = 0;
  for_each_2d(tile, f, geo, [&](const Tile2& at, int i, int j, long long v) {
    const Hessian h = at.hessian(geo, i, j);
    frob[v] = frobenius(h, false);
    if (i >= geo.core_lo[0] && i < geo.core_hi[0] && j >= geo.core_lo[1] && j < geo.core_hi[1])
      top = max(top, biggest(h, false));
  });
  block_max(top, warp_top, TX2 * TY2 / 32, largest);
}

template <typename Carry>
__global__ void __launch_bounds__(TX2 * TY2)
frangi_response_2d(const float* __restrict__ f, const unsigned char* __restrict__ mask,
                   const float* __restrict__ gamma_sq, Carry* __restrict__ vessel,
                   unsigned char* __restrict__ all_mask, const Geometry geo, const Response rp) {
  __shared__ float tile[SY2 * SX2];
  const float g2 = __ldg(gamma_sq);
  for_each_2d(tile, f, geo, [&](const Tile2& at, int i, int j, long long v) {
    const bool m = mask == nullptr || mask[v] != 0;
    vessel[v] = carry_max(vessel[v], m ? response2(at.hessian(geo, i, j), g2, rp) : 0.f);
    if (!m) all_mask[v] = 0;
  });
}

// ---------------------------------------------------------------------------
// Host side: the plan and the grid of one wave
// ---------------------------------------------------------------------------

struct WaveEntry {
  int device;
  const void* fn;
  int smem;
  int blocks;
};

std::mutex wave_lock;
WaveEntry wave_cache[64];
int wave_count = 0;

// Blocks a wave holds of `fn` with `threads` threads and `smem` bytes of
// dynamic shared memory: the SMs times the occupancy, cached by (device,
// kernel, bytes); the attribute for more than 48 KB is set once a kernel
cudaError_t wave(const void* fn, int threads, int smem, int* blocks) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(wave_lock);
  bool allowed = false;
  for (int i = 0; i < wave_count; ++i) {
    const WaveEntry& e = wave_cache[i];
    if (e.device == device && e.fn == fn) {
      allowed = true;
      if (e.smem == smem) {
        *blocks = e.blocks;
        return cudaSuccess;
      }
    }
  }
  int sms = 0, per_sm = 0, most = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if (!allowed) {
    // the block's ceiling less the kernel's static shared memory
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    most - static_cast<int>(attr.sharedSizeBytes))) !=
            cudaSuccess)
      return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) !=
      cudaSuccess)
    return err;
  *blocks = std::max(1, per_sm) * sms;
  if (wave_count < 64) wave_cache[wave_count++] = WaveEntry{device, fn, smem, *blocks};
  return cudaSuccess;
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan of a 3D block's tiles: the segment length along z that makes the
// wave's rounds times the planes a tile reads (its segment and two more)
// least, among those that give each block at least min_rounds tiles where
// there are any
Plan make_plan(const Geometry& geo, bool vec, long long wave_blocks, int min_rounds) {
  using L = Layout;
  Plan p{};
  p.nz = geo.n[0], p.ny = geo.n[1], p.nx = geo.n[2];
  for (int a = 0; a < 3; ++a) {
    p.h[a] = geo.half[a];
    p.inv[a] = geo.inv[a];
    p.fuse[a] = geo.fuse[a];
    p.core_lo[a] = geo.core_lo[a];
    p.core_hi[a] = geo.core_hi[a];
  }
  p.vec = vec && p.nx % 4 == 0;
  p.tiles_x = (p.nx + L::TX - 1) / L::TX;
  p.tiles_y = (p.ny + L::TY - 1) / L::TY;
  const long long columns = static_cast<long long>(p.tiles_x) * p.tiles_y;
  long long best = -1;
  bool best_enough = false;
  for (int segs = 1; segs <= p.nz; ++segs) {
    const int zseg = (p.nz + segs - 1) / segs;
    if (segs > 1 && zseg == (p.nz + segs - 2) / (segs - 1)) continue;  // the same split
    const long long tiles = columns * ((p.nz + zseg - 1) / zseg);
    const long long rounds = (tiles + wave_blocks - 1) / wave_blocks;
    const long long cost = rounds * (zseg + 2);
    const bool enough = rounds >= min_rounds;
    if (best < 0 || (enough && !best_enough) || (enough == best_enough && cost < best)) {
      best = cost;
      best_enough = enough;
      p.zseg = zseg;
      p.tiles = tiles;
    }
  }
  return p;
}

// The grid of a 2D block's one-shot tiles
dim3 grid_2d(const Geometry& geo) {
  return dim3((geo.n[1] + TX2 - 1) / TX2, (geo.n[0] + TY2 * ROWS2 - 1) / (TY2 * ROWS2), 1);
}

bool valid(const Geometry& geo, long long total) {
  if (geo.ndim != 2 && geo.ndim != 3) return false;
  long long n = 1;
  for (int a = 0; a < geo.ndim; ++a) {
    if (geo.n[a] < 1) return false;
    n *= geo.n[a];
  }
  return n == total && total > 0 && (geo.ndim == 3 || grid_2d(geo).y <= 65535);
}

// A 3D launch of pass 1 (Carry unused) or pass 2: the kernel, its threads
// and shared memory, the blocks a wave holds and the plan of its tiles
template <int PASS, typename Carry>
struct Launch {
  using L = Layout;
  static constexpr int smem =
      (PASS == 1 ? L::FLOATS_PASS1 : L::FLOATS_PASS2) * static_cast<int>(sizeof(float));
  static const void* fn() {
    return PASS == 1 ? reinterpret_cast<const void*>(hessian_frob_3d)
                     : reinterpret_cast<const void*>(frangi_response_3d<Carry>);
  }
  static cudaError_t plan(const Geometry& geo, bool vec, Plan* p, int* blocks) {
    const cudaError_t err = wave(fn(), L::THREADS, smem, blocks);
    if (err == cudaSuccess) *p = make_plan(geo, vec, *blocks, PASS == 1 ? 1 : PASS2_ROUNDS);
    return err;
  }
  static unsigned grid(const Plan& p, int blocks) {
    return static_cast<unsigned>(std::min<long long>(p.tiles, blocks));
  }
};

cudaError_t launch_pass1(const float* f, float* frob, unsigned* largest, const Geometry& geo,
                         cudaStream_t s) {
  if (geo.ndim == 2) {
    hessian_frob_2d<<<grid_2d(geo), dim3(TX2, TY2), 0, s>>>(f, frob, largest, geo);
    return cudaGetLastError();
  }
  using K = Launch<1, float>;
  Plan p;
  int blocks = 0;
  const cudaError_t err = K::plan(geo, aligned(f, 16) && aligned(frob, 16), &p, &blocks);
  if (err != cudaSuccess) return err;
  hessian_frob_3d<<<K::grid(p, blocks), K::L::THREADS, K::smem, s>>>(f, frob, largest, p);
  return cudaGetLastError();
}

template <typename Carry>
cudaError_t launch_pass2(const float* f, const unsigned char* mask, const float* gamma_sq,
                         Carry* vessel, unsigned char* all_mask, const Geometry& geo,
                         const Response& rp, cudaStream_t s) {
  if (geo.ndim == 2) {
    frangi_response_2d<Carry><<<grid_2d(geo), dim3(TX2, TY2), 0, s>>>(f, mask, gamma_sq, vessel,
                                                                     all_mask, geo, rp);
    return cudaGetLastError();
  }
  using K = Launch<2, Carry>;
  const bool vec = aligned(f, 16) && aligned(vessel, 4 * sizeof(Carry)) &&
                   aligned(all_mask, 4) && (mask == nullptr || aligned(mask, 4));
  Plan p;
  int blocks = 0;
  const cudaError_t err = K::plan(geo, vec, &p, &blocks);
  if (err != cudaSuccess) return err;
  frangi_response_3d<Carry><<<K::grid(p, blocks), K::L::THREADS, K::smem, s>>>(
      f, mask, gamma_sq, vessel, all_mask, p, rp);
  return cudaGetLastError();
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
  return static_cast<int>(
      launch_pass1(f, frob, largest, *geo, static_cast<cudaStream_t>(stream)));
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
  const auto* m = reinterpret_cast<const unsigned char*>(mask);
  auto* a = reinterpret_cast<unsigned char*>(all_mask);
  const cudaError_t err =
      half_carry ? launch_pass2(f, m, gamma_sq, static_cast<__half*>(vessel), a, *geo, rp, s)
                 : launch_pass2(f, m, gamma_sq, static_cast<float*>(vessel), a, *geo, rp, s);
  return static_cast<int>(err);
}

}  // extern "C"
