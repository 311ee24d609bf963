// One 1-D correlation along an axis with scipy's "reflect" edges, for
// Hopper (sm_90a): a pass of the separable Gaussian and LoG filters.
//
// Replaces the chain of fused multiply-adds of
// nellie_tpu/kernels/filters.py::correlate1d_traced (:73) and _correlate1d
// (:51), which the port's plain torch (kernels/filters.py,
// correlate1d_traced_plain and _correlate1d_plain) runs as one launch per
// tap after a padded copy of the frame: 8 to 25 full passes through device
// memory per axis.  Here each output voxel reads its taps from the input
// with the edge index computed in the kernel (numpy's "symmetric": index
// m = i mod 2n, then m or 2n - 1 - m), and sums them in XLA's order:
//
//   acc = fma(x[k0], w0, x[k1] * w1), then acc = fma(x[k], w_k, acc)
//
// over the taps the caller lists (every tap of a traced kernel, zeros
// included; only the nonzero ones for _correlate1d; a single tap is one
// product).  Where the reflected taps reach past the far end of a short
// axis, two taps of one output can read the same element with weights of
// the same magnitude; XLA's CPU code then computes that product once and
// never contracts it (filters.py::shared_products).  For _correlate1d the
// caller passes those taps as a device table of flags a position (bit k of
// 32-bit word k / 32 of the position's `words` words, or null where there
// are none), and a flagged product is rounded and added
// (filters.py::_tap_chain).  The LoG program of XLA's last fusion reads
// its centre tap (offset 0) from another pass's output
// (filters.py::log_program); the caller then passes that tensor as
// `centre`, read at the output's own index.  Where XLA pads a pass's input
// by reflection in a loop whose rounding differs from the one that computed
// the rest (Markers' sunk axis-0 pass), the caller passes the reflected
// values' tensor as `edge`: a tap whose index falls outside the axis reads
// it (reflected) in place of x.  Built with -fmad=false and
// without fast math, so the product x[k1] * w1 is rounded and every other
// step is the written __fmaf_rn.  The result is rounded to float16 and
// back when the cascade's carry is float16 (the plain version's
// .to(float16).float()), and stored as float32.
//
// What bounds it: memory, 4 bytes read and 4 written a voxel.  The design:
//  * a persistent grid of one wave (the occupancy the tile's shared memory
//    and registers allow, times the SMs) walks the tiles, and each block
//    double-buffers them with cp.async: the next tile's load is in flight
//    while this tile's taps run;
//  * the tile's shared memory is sized to the taps' reach (dynamic): a
//    3-tap pass stages 34 rows of a 32-row tile, where a fixed 128-voxel
//    margin staged 320 rows of a 64-row one;
//  * reflection only in the tiles that touch an edge (a row or chunk index
//    outside the axis); interior tiles copy with no index arithmetic;
//  * 16-byte copies, loads and stores along the inner axis where the inner
//    extent (or the line, along the last axis) is a multiple of 4;
//  * template instances for the tap counts the main paths use with
//    consecutive offsets (-r..r): the tap loop unrolled, each thread
//    streaming a window of rows (or positions) through registers into the
//    outputs it owns; any other tap list takes the run-time loop.
// Along an outer axis a tile is SEG = 32 output rows by 32 * VEC columns
// (VEC = 4 or 1), with the reach's rows above and below; a thread owns 4
// consecutive rows of VEC columns.  Along the last axis a tile is one or
// more lines of up to 256 * VEC outputs each, with the reach (rounded up to
// VEC) on both sides; a thread owns VEC consecutive outputs.  The taps reach at most 128 voxels:
// the Gaussian and LoG taps of the Filter and the Markers reach 4 sigma,
// far below that.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdlib>
#include <mutex>

namespace {

constexpr int MAX_TAPS = 256;
constexpr int THREADS = 256;
constexpr int MAX_REACH = 128;      // the taps' largest |offset|
constexpr int TX = 32;              // outer axis: threads across the columns
constexpr int TY = THREADS / TX;    // outer axis: threads down the rows
constexpr int RPT = 4;              // outer axis: output rows a thread
constexpr int SEG = TY * RPT;       // outer axis: output rows a tile
constexpr int VEC4_MAX_REACH = 64;  // outer axis: float4 tiles up to this reach
constexpr int LAST_TILE_FLOATS = 12288;  // last axis: at most 48 KB a buffer

struct Taps {
  int count;
  int offset[MAX_TAPS];  // tap k reads the input at i + offset[k]
  float weight[MAX_TAPS];
};

__device__ __forceinline__ int reflect(int idx, int n) {
  if (idx >= 0 && idx < n) return idx;
  const int period = 2 * n;
  int m = idx % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

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

__device__ __forceinline__ bool flag(const uint32_t* f, int k) {
  return (f[k >> 5] >> (k & 31)) & 1u;
}

// The first add of the chain, taps 0 and 1: a flagged product is rounded,
// the other contracted (or neither)
__device__ __forceinline__ float first_add(float x0, float w0, float x1, float w1, bool f0,
                                           bool f1) {
  if (f0 && f1) return __fadd_rn(__fmul_rn(x0, w0), __fmul_rn(x1, w1));
  if (f0) return __fmaf_rn(x1, w1, __fmul_rn(x0, w0));
  return __fmaf_rn(x0, w0, __fmul_rn(x1, w1));
}

__device__ __forceinline__ float next_add(float acc, float x, float w, bool shared) {
  return shared ? __fadd_rn(acc, __fmul_rn(x, w)) : __fmaf_rn(x, w, acc);
}

__device__ __forceinline__ float finish(float acc, bool round_half) {
  return round_half ? __half2float(__float2half_rn(acc)) : acc;
}

// The taps' sum at one output by the run-time loop; at(k) reads tap k, f:
// the position's flag words (null: none)
template <class At>
__device__ __forceinline__ float tap_loop(const Taps& taps, const At& at,
                                          const uint32_t* __restrict__ f) {
  if (taps.count == 1) return __fmul_rn(at(0), taps.weight[0]);
  if (f == nullptr) {
    float acc = __fmaf_rn(at(0), taps.weight[0], __fmul_rn(at(1), taps.weight[1]));
    for (int k = 2; k < taps.count; ++k) acc = __fmaf_rn(at(k), taps.weight[k], acc);
    return acc;
  }
  float acc = first_add(at(0), taps.weight[0], at(1), taps.weight[1], flag(f, 0), flag(f, 1));
  for (int k = 2; k < taps.count; ++k) acc = next_add(acc, at(k), taps.weight[k], flag(f, k));
  return acc;
}

// One step of a window streamed through N consecutive taps: output o of a
// thread takes tap k = w - o from window element w.  x0 keeps tap 0's value
// for the first add.
template <int N, bool FLAGS>
__device__ __forceinline__ void stream_tap(int k, float x, float& x0, float& acc,
                                           const Taps& taps, uint32_t f) {
  if (N == 1) {
    acc = __fmul_rn(x, taps.weight[0]);
  } else if (k == 0) {
    x0 = x;
  } else if (k == 1) {
    acc = FLAGS ? first_add(x0, taps.weight[0], x, taps.weight[1], f & 1u, (f >> 1) & 1u)
                : __fmaf_rn(x0, taps.weight[0], __fmul_rn(x, taps.weight[1]));
  } else {
    acc = FLAGS ? next_add(acc, x, taps.weight[k], (f >> k) & 1u)
                : __fmaf_rn(x, taps.weight[k], acc);
  }
}

// ---------------------------------------------------------------------------
// Along an outer axis: the volume as (outer, n, inner); a tile is SEG output
// rows of (outer o, segment) by 32 * VEC columns, stored with the reach's rows
// on both sides.  Tiles are numbered columns fastest.
// ---------------------------------------------------------------------------

struct Outer {
  const float* x;
  float* out;
  const uint32_t* flags;  // n x words, or null
  const float* centre;    // like x, or null
  const float* edge;      // like x, or null: read where a row index falls outside the axis
  long long inner, outer, col_tiles, tiles;
  int n, segs, reach, words, round_half;
};

template <int VEC>
__device__ __forceinline__ void outer_load(const Outer& g, long long t, float* tile) {
  constexpr int W = TX * VEC;
  const long long ct = t % g.col_tiles;
  const long long rest = t / g.col_tiles;
  const int seg0 = static_cast<int>(rest % g.segs) * SEG;
  const long long o = rest / g.segs;
  const long long j = ct * W + threadIdx.x * VEC;
  if (j >= g.inner) return;
  const int rows = min(SEG, g.n - seg0) + 2 * g.reach;
  const bool interior = seg0 - g.reach >= 0 && seg0 - g.reach + rows <= g.n;
  const float* col = g.x + o * g.n * g.inner + j;
  const float* edge_col = g.edge != nullptr ? g.edge + o * g.n * g.inner + j : col;
  float* dst = tile + threadIdx.x * VEC;
  for (int r = threadIdx.y; r < rows; r += TY) {
    const int raw = seg0 - g.reach + r;
    const bool inside = interior || (raw >= 0 && raw < g.n);
    const float* src = (inside ? col : edge_col) + (inside ? raw : reflect(raw, g.n)) * g.inner;
    if (VEC == 4)
      copy16(dst + r * W, src);
    else
      copy4(dst + r * W, src);
  }
}

template <int N, int VEC, bool FLAGS>
__device__ __forceinline__ void outer_compute(const Outer& g, const Taps& taps, long long t,
                                              const float* tile) {
  constexpr int W = TX * VEC;
  const long long ct = t % g.col_tiles;
  const long long rest = t / g.col_tiles;
  const int seg0 = static_cast<int>(rest % g.segs) * SEG;
  const long long o = rest / g.segs;
  const long long j = ct * W + threadIdx.x * VEC;
  if (j >= g.inner) return;
  const int row0 = threadIdx.y * RPT;  // this thread's first output row in the segment
  const long long at0 = (o * g.n + seg0 + row0) * g.inner + j;
  const float* col = tile + threadIdx.x * VEC;
  float acc[RPT][VEC];
  if (N > 0) {
    constexpr int C = N / 2;  // the tap at offset 0
    // window row w: segment row row0 + w - C, tile row row0 + w - C + reach
    const float* win = col + (row0 + g.reach - C) * W;
    float x0[RPT][VEC];
    uint32_t f[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m)
      f[m] = FLAGS && seg0 + row0 + m < g.n
                 ? g.flags[static_cast<long long>(seg0 + row0 + m) * g.words]
                 : 0u;
#pragma unroll
    for (int w = 0; w < RPT + N - 1; ++w) {
      float v[VEC];
      if (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(win + w * W);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
        v[0] = win[w * W];
      }
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int k = w - m;
        if (k < 0 || k >= N) continue;
        float c[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) c[e] = v[e];
        if (k == C && g.centre != nullptr && seg0 + row0 + m < g.n) {
          const float* src = g.centre + at0 + m * g.inner;
          if (VEC == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(src));
            c[0] = q.x, c[1] = q.y, c[2] = q.z, c[3] = q.w;
          } else {
            c[0] = __ldg(src);
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) stream_tap<N, FLAGS>(k, c[e], x0[m][e], acc[m][e], taps, f[m]);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int i = seg0 + row0 + m;
      if (i >= g.n) break;
      const uint32_t* f = FLAGS ? g.flags + static_cast<long long>(i) * g.words : nullptr;
      const int base = row0 + m + g.reach;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[m][e] = tap_loop(
            taps,
            [&](int k) {
              return g.centre != nullptr && taps.offset[k] == 0
                         ? __ldg(g.centre + at0 + m * g.inner + e)
                         : col[(base + taps.offset[k]) * W + e];
            },
            f);
    }
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    if (seg0 + row0 + m >= g.n) break;
    float* dst = g.out + at0 + m * g.inner;
    if (VEC == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(finish(acc[m][0], g.round_half), finish(acc[m][1], g.round_half),
                      finish(acc[m][2], g.round_half), finish(acc[m][3], g.round_half));
    } else {
      dst[0] = finish(acc[m][0], g.round_half);
    }
  }
}

// The persistent loop shared by both axes: tile t + gridDim.x is loaded
// while tile t is computed
template <class Load, class Compute>
__device__ __forceinline__ void walk_tiles(long long tiles, int tile_floats, float* smem,
                                           const Load& load, const Compute& compute) {
  long long t = blockIdx.x;
  if (t >= tiles) return;
  load(t, smem);
  commit();
  for (int buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    const long long next = t + gridDim.x;
    if (next < tiles) {
      load(next, smem + (buf ^ 1) * tile_floats);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();  // this tile's copies, from every thread, have landed
    compute(t, smem + buf * tile_floats);
    __syncthreads();  // its reads are done before the buffer is loaded again
  }
}

template <int N, int VEC>
__global__ void __launch_bounds__(THREADS)
outer_axis_kernel(const Outer g, const Taps taps) {
  extern __shared__ __align__(16) float smem[];
  const int tile_floats = (SEG + 2 * g.reach) * TX * VEC;
  if (g.flags != nullptr)
    walk_tiles(g.tiles, tile_floats, smem,
               [&](long long t, float* tile) { outer_load<VEC>(g, t, tile); },
               [&](long long t, const float* tile) {
                 outer_compute<N, VEC, true>(g, taps, t, tile);
               });
  else
    walk_tiles(g.tiles, tile_floats, smem,
               [&](long long t, float* tile) { outer_load<VEC>(g, t, tile); },
               [&](long long t, const float* tile) {
                 outer_compute<N, VEC, false>(g, taps, t, tile);
               });
}

// ---------------------------------------------------------------------------
// Along the last axis: lines of n; a tile is `lpt` lines by `span`
// positions (span = n, at most THREADS * VEC, rounded up to VEC), each line
// stored with `margin` (the reach rounded up to VEC) on both sides; a thread
// owns VEC consecutive outputs of one line.  Tiles are numbered segments
// fastest.
// ---------------------------------------------------------------------------

struct Last {
  const float* x;
  float* out;
  const uint32_t* flags;
  const float* centre;
  const float* edge;  // like x, or null: read where a position falls outside the line
  long long lines, tiles;
  int n, span, lpt, segs, reach, margin, words, round_half;
};

template <int VEC>
__device__ __forceinline__ void last_load(const Last& g, long long t, float* tile) {
  const long long line0 = t / g.segs * g.lpt;
  const int start = static_cast<int>(t % g.segs) * g.span - g.margin;
  const int stride = g.span + 2 * g.margin;  // a line's floats in the tile
  const int chunks = stride / VEC;
  const bool interior = start >= 0 && start + stride <= g.n;
  for (int q = threadIdx.x; q < g.lpt * chunks; q += THREADS) {
    const int ls = q / chunks;
    const int c = q - ls * chunks;
    if (line0 + ls >= g.lines) break;
    const float* src = g.x + (line0 + ls) * g.n;
    const float* edge = g.edge != nullptr ? g.edge + (line0 + ls) * g.n : src;
    float* dst = tile + ls * stride + c * VEC;
    const int p = start + c * VEC;
    if (VEC == 4 && (interior || (p >= 0 && p + 4 <= g.n))) {
      copy16(dst, src + p);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const bool inside = p + e >= 0 && p + e < g.n;
        copy4(dst + e, (inside ? src : edge) + reflect(p + e, g.n));
      }
    }
  }
}

template <int N, int VEC, bool FLAGS>
__device__ __forceinline__ void last_compute(const Last& g, const Taps& taps, long long t,
                                             const float* tile) {
  const int per_line = g.span / VEC;  // threads a line
  const int ls = threadIdx.x / per_line;
  const long long line = t / g.segs * g.lpt + ls;
  const int p0 = static_cast<int>(t % g.segs) * g.span + (threadIdx.x - ls * per_line) * VEC;
  if (ls >= g.lpt || line >= g.lines || p0 >= g.n) return;
  const long long at0 = line * g.n + p0;
  // win[d]: position p0 + d of the line
  const float* win = tile + ls * (g.span + 2 * g.margin) + g.margin + (p0 % g.span);
  float acc[VEC];
  if (N > 0) {
    constexpr int C = N / 2;
    float x0[VEC];
    uint32_t f[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      f[e] = FLAGS && p0 + e < g.n ? g.flags[static_cast<long long>(p0 + e) * g.words] : 0u;
#pragma unroll
    for (int w = 0; w < VEC + N - 1; ++w) {
      const float v = win[w - C];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int k = w - e;
        if (k < 0 || k >= N) continue;
        const float c = k == C && g.centre != nullptr && p0 + e < g.n ? __ldg(g.centre + at0 + e)
                                                                      : v;
        stream_tap<N, FLAGS>(k, c, x0[e], acc[e], taps, f[e]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (p0 + e >= g.n) break;
      const uint32_t* f = FLAGS ? g.flags + static_cast<long long>(p0 + e) * g.words : nullptr;
      acc[e] = tap_loop(
          taps,
          [&](int k) {
            return g.centre != nullptr && taps.offset[k] == 0 ? __ldg(g.centre + at0 + e)
                                                              : win[e + taps.offset[k]];
          },
          f);
    }
  }
  if (VEC == 4 && p0 + 4 <= g.n) {
    *reinterpret_cast<float4*>(g.out + at0) =
        make_float4(finish(acc[0], g.round_half), finish(acc[1], g.round_half),
                    finish(acc[2], g.round_half), finish(acc[3], g.round_half));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (p0 + e < g.n) g.out[at0 + e] = finish(acc[e], g.round_half);
  }
}

template <int N, int VEC>
__global__ void __launch_bounds__(THREADS)
last_axis_kernel(const Last g, const Taps taps) {
  extern __shared__ __align__(16) float smem[];
  const int tile_floats = g.lpt * (g.span + 2 * g.margin);
  if (g.flags != nullptr)
    walk_tiles(g.tiles, tile_floats, smem,
               [&](long long t, float* tile) { last_load<VEC>(g, t, tile); },
               [&](long long t, const float* tile) {
                 last_compute<N, VEC, true>(g, taps, t, tile);
               });
  else
    walk_tiles(g.tiles, tile_floats, smem,
               [&](long long t, float* tile) { last_load<VEC>(g, t, tile); },
               [&](long long t, const float* tile) {
                 last_compute<N, VEC, false>(g, taps, t, tile);
               });
}

// ---------------------------------------------------------------------------
// Host side: the instance for the tap count, its grid of one wave
// ---------------------------------------------------------------------------

// The tap counts with consecutive offsets that get their own instances,
// exactly those the main paths and the capacity path launch (chip_smoke.py
// prints them by path and fails on a count listed here that no path takes,
// or on a path's -r..r count that is not listed): the Filter's traced
// cascades (3D 3 and 5, 2D 11, capacity 7 taps), the 2D Filter's blobness
// LoG (11, 15 and 25) and the Markers' LoG (3D 3 to 13, 2D 9, 13, 17, 21
// and 23).  filters.GAUSS_UNROLLED_COUNTS reads this line.
#define GAUSS_COUNTS(X) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) X(21) X(23) X(25)

using OuterFn = void (*)(const Outer, const Taps);
using LastFn = void (*)(const Last, const Taps);

template <int VEC>
OuterFn outer_instance(int n) {
  switch (n) {
#define GAUSS_CASE(K) \
  case K:             \
    return outer_axis_kernel<K, VEC>;
    GAUSS_COUNTS(GAUSS_CASE)
#undef GAUSS_CASE
    default:
      return outer_axis_kernel<0, VEC>;
  }
}

template <int VEC>
LastFn last_instance(int n) {
  switch (n) {
#define GAUSS_CASE(K) \
  case K:             \
    return last_axis_kernel<K, VEC>;
    GAUSS_COUNTS(GAUSS_CASE)
#undef GAUSS_CASE
    default:
      return last_axis_kernel<0, VEC>;
  }
}

// Blocks a wave holds of `fn` at `smem` bytes: the SMs times the occupancy,
// cached by (device, kernel, bytes); the attribute for more than 48 KB is
// set once a kernel
struct WaveEntry {
  int device;
  const void* fn;
  int smem;
  int blocks;
};

std::mutex wave_lock;
WaveEntry wave_cache[256];
int wave_count = 0;

cudaError_t wave(const void* fn, int smem, int* blocks) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(wave_lock);
  bool allowed = false;  // the kernel's shared-memory ceiling already raised on this device
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
    if ((err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most)) !=
            cudaSuccess)
      return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem)) !=
      cudaSuccess)
    return err;
  *blocks = std::max(1, per_sm) * sms;
  if (wave_count < 256) wave_cache[wave_count++] = WaveEntry{device, fn, smem, *blocks};
  return cudaSuccess;
}

// Whether the taps are -r..r in order with a count that has its own instance
bool specialised(int count, const int* offsets) {
  switch (count) {
#define GAUSS_CASE(K) case K:
    GAUSS_COUNTS(GAUSS_CASE)
#undef GAUSS_CASE
    break;
    default:
      return false;
  }
  for (int k = 0; k < count; ++k)
    if (offsets[k] != k - count / 2) return false;
  return true;
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x and out: total float32 voxels in C order, viewed as (outer, n, inner)
// with the correlation along n; `count` taps (1 <= count <= 256) at input
// offsets `offsets` (each |offset| <= 128) with float32 `weights`, and
// their largest |offset| `reach`; round_half: round each result to float16
// and back.  flags: device table of the taps whose product is computed once
// at each output position, `words` 32-bit words a position (bit k of word
// k / 32 for tap k), or null; centre: float32 like x, read by the tap at
// offset 0 in place of x, or null; edge: float32 like x, read (reflected)
// by a tap whose index falls outside the axis in place of x, or null.  used (host, 2 values, written when the
// kernel is launched): the tap count of the unrolled instance the launch
// took (0: the run-time loop) and the bytes a copy of its tiles (16 or 4)
int gauss_axis(const float* x, float* out, long long total, long long n, long long inner,
               int count, const int* offsets, const float* weights, int reach, int round_half,
               const uint32_t* flags, int words, const float* centre, const float* edge,
               int* used, void* stream) {
  if (total < 1 || n < 1 || inner < 1 || total % (n * inner) != 0 || count < 1 ||
      count > MAX_TAPS || n > (1LL << 30) || reach < 0 || reach > MAX_REACH ||
      (flags != nullptr && words != (count + 31) / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  taps.count = count;
  for (int k = 0; k < count; ++k) {
    if (std::abs(offsets[k]) > reach) return static_cast<int>(cudaErrorInvalidValue);
    taps.offset[k] = offsets[k];
    taps.weight[k] = weights[k];
  }
  const int instance = specialised(count, offsets) ? count : 0;
  const bool vec_ok = aligned(x) && aligned(out) && aligned(centre) && aligned(edge);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long outer = total / (n * inner);
  cudaError_t err;
  int blocks = 0;
  if (inner > 1) {
    const bool vec = vec_ok && inner % 4 == 0 && reach <= VEC4_MAX_REACH;
    const int width = TX * (vec ? 4 : 1);
    Outer g{x, out, flags, centre, edge, inner, outer, (inner + width - 1) / width, 0,
            static_cast<int>(n), static_cast<int>((n + SEG - 1) / SEG), reach, words,
            round_half};
    g.tiles = g.outer * g.segs * g.col_tiles;
    const int smem = 2 * (SEG + 2 * reach) * width * static_cast<int>(sizeof(float));
    const OuterFn fn = vec ? outer_instance<4>(instance) : outer_instance<1>(instance);
    if ((err = wave(reinterpret_cast<const void*>(fn), smem, &blocks)) != cudaSuccess)
      return static_cast<int>(err);
    const long long grid = std::min<long long>(g.tiles, blocks);
    fn<<<static_cast<unsigned>(grid), dim3(TX, TY), smem, s>>>(g, taps);
    used[1] = vec ? 16 : 4;
  } else {
    const bool vec = vec_ok && n % 4 == 0;
    const int per = vec ? 4 : 1;
    const int span = static_cast<int>(std::min<long long>(n, THREADS * per) + per - 1) / per * per;
    const int margin = (reach + per - 1) / per * per;
    // lines a tile: as many as the threads cover, at most LAST_TILE_FLOATS floats a buffer
    const int lpt = std::max(1, std::min(THREADS * per / span, LAST_TILE_FLOATS / (span + 2 * margin)));
    Last g{x, out, flags, centre, edge, outer, 0, static_cast<int>(n), span, lpt,
           static_cast<int>((n + span - 1) / span), reach, margin, words, round_half};
    g.tiles = (g.lines + g.lpt - 1) / g.lpt * g.segs;
    const int smem = 2 * g.lpt * (span + 2 * margin) * static_cast<int>(sizeof(float));
    const LastFn fn = vec ? last_instance<4>(instance) : last_instance<1>(instance);
    if ((err = wave(reinterpret_cast<const void*>(fn), smem, &blocks)) != cudaSuccess)
      return static_cast<int>(err);
    const long long grid = std::min<long long>(g.tiles, blocks);
    fn<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(g, taps);
    used[1] = vec ? 16 : 4;
  }
  used[0] = instance;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
