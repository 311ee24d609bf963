// The windowed exact squared EDT as min-plus passes, for Hopper (sm_90a):
// one launch an axis, no host read.
//
// Replaces nellie_tpu/kernels/edt.py::distance_transform (edt.py:218, its
// pass _minplus_axis at :181), a chain of 2r + 1 shifted adds and minima an
// axis, and the port's plain body (kernels/edt.py::distance_transform_plain),
// one narrow, add and minimum a window offset an axis: 123 CUDA kernels a
// 3D call, 155 a 2D one.
//
// What it computes, exactly as the plain body does (built with -fmad=false).
// Axis by axis in order, with r = min(n_axis - 1, max_radius_px) (n_axis - 1
// when there is no clamp):
//   out[i] = min over |k| <= r, 0 <= i + k < n_axis of  f[i + k] + c[|k|],
// starting from f = where(mask, inf, 0); then sqrt (correctly rounded, as
// _fp.sqrt), +inf to max(shape) (nan_to_num) and 0 outside the mask.  Every
// candidate is one float32 add of the same two operands as in the plain
// body, and the minimum is exact, so any order of the candidates gives its
// bits; candidates outside the axis are +inf there and never the minimum
// unless all are, which the +inf start keeps.  c[d] = f32((d * s)^2) is the
// host's, computed in float64 and rounded (edt.py's table), passed in as a
// table and never recomputed here.
//
// What bounds it: at the Markers' clamps (11 in 3D, 21 in 2D: windows of 23
// and 43) the window's candidates, an add and a minimum each, about 290
// million for the 3D path's 64 x 256 x 256 frame, against 20 MB of mask and
// result.  One design serves every window, any r from 0 to the whole axis:
//  * a block takes a tile of 32 lines (a lane each) by TN = 64 outputs
//    along the axis, and holds the tile's positions with their halo of r
//    on either side in shared memory, read once from device memory; a
//    halo longer than CH rows is taken in chunks of CH, so r may span the
//    whole axis (no clamp);
//  * along an axis that is not the last, the 32 lines are neighbouring
//    columns, so loads and stores are coalesced as they are; along the
//    last axis the lines are 32 rows of the frame, loaded along the line
//    into the transposed tile (a pitch of 33 words keeps both sides free of
//    bank conflicts) and stored back through it;
//  * a thread keeps 8 neighbouring outputs in registers and walks the
//    positions that reach any of them once: each position's value is read
//    from shared memory once for 8 outputs, and the costs of its 8
//    offsets are a ring of 8 registers that takes one new cost a position
//    (uniform across the warp, from L1), so a candidate is one add and one
//    minimum at any r; a cost past the window is +inf, a candidate that
//    never wins;
//  * the first pass reads the mask itself (where(mask, inf, 0) is never
//    written) and the last fuses the root, the +inf replacement and the
//    mask, so the frame is read and the result written once.
//
// The kernel allocates nothing.  The C entry point launches one kernel an
// axis on the caller's stream and reads nothing back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 32;            // lines a tile, a lane each
constexpr int THREADS = 256;
constexpr int TY = THREADS / W;  // threads along the axis
constexpr int OPT = 8;           // neighbouring outputs a thread (a power of 2)
constexpr int TN = TY * OPT;     // outputs along the axis a tile
constexpr int CH = 128;          // tile rows in shared memory at once (a multiple of OPT, >= TN)
constexpr int PITCH = W + 1;     // words a tile row
constexpr int MAX_RADIUS = 1 << 29;  // the steps 2r + OPT stay an int

struct Axis {
  long long outer;  // lines before the axis (product of the leading dimensions)
  int n;            // the axis's length
  long long inner;  // elements after it (1 along the last axis)
  int r;            // the window's half width
  float max_dim;    // max(shape), for +inf
};

template <bool FIRST>
__device__ __forceinline__ float load_f(const float* in, const uint8_t* mask, long long at) {
  if (FIRST) return mask[at] ? INFINITY : 0.0f;
  return in[at];
}

template <bool FINAL>
__device__ __forceinline__ void store(float* out, const uint8_t* mask, long long at, float v,
                                      float max_dim) {
  if (FINAL) v = mask[at] ? (isinf(v) ? max_dim : __fsqrt_rn(v)) : 0.0f;
  out[at] = v;
}

// One pass along an axis.  LINE: the last axis (lines are rows of the
// frame, positions contiguous); else a strided axis (lines are neighbouring
// columns).  Tile row j is position a0 - r + j; thread (ty, lane) keeps
// outputs a0 + ty * OPT + k, k < OPT, whose candidate from tile row
// ty * OPT + m is at offset m - k - r, cost e(m - k) with e(j) = c[|j - r|]
// for 0 <= j <= 2r and +inf past it.
template <bool LINE, bool FIRST, bool FINAL>
__global__ void __launch_bounds__(THREADS)
minplus_axis(const float* __restrict__ in, const uint8_t* __restrict__ mask,
             const float* __restrict__ cost, float* __restrict__ out, Axis g) {
  __shared__ float tile[CH * PITCH];
  const long long lines = LINE ? g.outer : g.inner;  // lines of a tile's range
  const long long line_tiles = (lines + W - 1) / W;
  const int row_tiles = (g.n + TN - 1) / TN;
  long long b = blockIdx.x;
  const long long lt = b % line_tiles;
  b /= line_tiles;
  const int a0 = (int)(b % row_tiles) * TN;  // first output along the axis
  // element (line l, position p): base + p * ps + l * ls
  const long long base = LINE ? 0 : (b / row_tiles) * g.n * g.inner;
  const long long ps = LINE ? 1 : g.inner, ls = LINE ? g.n : 1;
  const long long l0 = lt * W;
  const int r = g.r;
  const int steps = (2 * r + OPT + OPT - 1) / OPT * OPT;  // m = 0 .. steps - 1
  const int span = TN - OPT + steps;                       // tile rows a thread may read
  const int lane = threadIdx.x % W, ty = threadIdx.x / W;
  float best[OPT], ring[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) best[k] = ring[k] = INFINITY;
  for (int c0 = 0; c0 < span; c0 += CH) {
    const int rows = min(CH, span - c0);
    __syncthreads();  // the last chunk is read
    for (int t = threadIdx.x; t < rows * W; t += THREADS) {
      // along the last axis consecutive threads take consecutive positions
      const int j = LINE ? t % rows : t / W, l = LINE ? t / rows : t % W;
      const int p = a0 - r + c0 + j;
      const long long line = l0 + l;
      tile[j * PITCH + l] = p >= 0 && p < g.n && line < lines
                                ? load_f<FIRST>(in, mask, base + p * ps + line * ls)
                                : INFINITY;
    }
    __syncthreads();
    const int m0 = max(0, c0 - ty * OPT), m1 = min(steps, c0 + rows - ty * OPT);
    const int row0 = ty * OPT - c0;  // the thread's step m reads tile row row0 + m
    for (int mb = m0; mb < m1; mb += OPT) {
#pragma unroll
      for (int u = 0; u < OPT; ++u) {
        const int m = mb + u;
        ring[u] = m <= 2 * r ? __ldg(cost + abs(m - r)) : INFINITY;
        const float v = tile[(row0 + m) * PITCH + lane];
#pragma unroll
        for (int k = 0; k < OPT; ++k)
          best[k] = fminf(best[k], __fadd_rn(v, ring[(u - k) & (OPT - 1)]));
      }
    }
  }
  if (!LINE) {
    const long long line = l0 + lane;
    if (line >= lines) return;
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      const int i = a0 + ty * OPT + k;
      if (i < g.n) store<FINAL>(out, mask, base + i * ps + line, best[k], g.max_dim);
    }
    return;
  }
  // along the last axis the outputs go back through the tile, stored along the line
  __syncthreads();
#pragma unroll
  for (int k = 0; k < OPT; ++k) tile[(ty * OPT + k) * PITCH + lane] = best[k];
  __syncthreads();
  for (int t = threadIdx.x; t < TN * W; t += THREADS) {
    const int j = t % TN, l = t / TN;
    const int i = a0 + j;
    const long long line = l0 + l;
    if (i < g.n && line < lines)
      store<FINAL>(out, mask, line * ls + i, tile[j * PITCH + l], g.max_dim);
  }
}

template <bool FIRST, bool FINAL>
cudaError_t launch_axis(const float* in, const uint8_t* mask, const float* cost, float* out,
                        const Axis& g, cudaStream_t s) {
  const bool line = g.inner == 1;
  const long long lines = line ? g.outer : g.inner;
  const long long blocks =
      (line ? 1 : g.outer) * ((g.n + TN - 1) / TN) * ((lines + W - 1) / W);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (line)
    minplus_axis<true, FIRST, FINAL><<<(unsigned)blocks, THREADS, 0, s>>>(in, mask, cost, out, g);
  else
    minplus_axis<false, FIRST, FINAL><<<(unsigned)blocks, THREADS, 0, s>>>(in, mask, cost, out,
                                                                           g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The distance transform of the C-order bool mask (one byte a voxel) of
// ndim (1 to 3) axes `shape` into out (float32).  radius[a]: axis a's half
// window; costs[a]: a device table of radius[a] + 1 float32 costs c[d];
// work: a float32 buffer of the frame's size apart from out (unused for one
// axis: the passes write work and out in turn, the last out).  kernels
// (host): the CUDA kernels launched, one an axis.
int edt_minplus(const void* mask, int ndim, const long long* shape, const int* radius,
                const void* const* costs, void* work, void* out, int* kernels, void* stream) {
  *kernels = 0;
  if (ndim < 1 || ndim > 3) return (int)cudaErrorInvalidValue;
  long long total = 1, max_dim = 0;
  for (int a = 0; a < ndim; ++a) {
    if (shape[a] < 1 || shape[a] > 2147483647LL || radius[a] < 0 || radius[a] >= shape[a] ||
        radius[a] > MAX_RADIUS)
      return (int)cudaErrorInvalidValue;
    total *= shape[a];
    max_dim = shape[a] > max_dim ? shape[a] : max_dim;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  // the passes write work, out, work, ... so that the last writes out
  float* bufs[2] = {(float*)work, (float*)out};
  const float* in = nullptr;
  long long outer = 1;
  for (int a = 0; a < ndim; ++a) {
    long long inner = total / outer / shape[a];
    Axis g{outer, (int)shape[a], inner, radius[a], (float)max_dim};
    float* dst = bufs[(ndim - 1 - a) % 2 == 0 ? 1 : 0];
    const float* cost = (const float*)costs[a];
    const bool first = a == 0, last = a == ndim - 1;
    cudaError_t err;
    if (first && last)
      err = launch_axis<true, true>(in, m, cost, dst, g, s);
    else if (first)
      err = launch_axis<true, false>(in, m, cost, dst, g, s);
    else if (last)
      err = launch_axis<false, true>(in, m, cost, dst, g, s);
    else
      err = launch_axis<false, false>(in, m, cost, dst, g, s);
    if (err != cudaSuccess) return (int)err;
    *kernels += 1;
    in = dst;
    outer *= shape[a];
  }
  return (int)cudaSuccess;
}

}  // extern "C"
