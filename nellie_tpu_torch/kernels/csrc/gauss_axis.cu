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
// caller passes those taps as a table of flags a position (n x count
// bytes, or null where there are none), and a flagged product is rounded
// and added (filters.py::_tap_chain).  The LoG program of XLA's last fusion
// reads its centre tap (offset 0) from another pass's output
// (filters.py::log_program); the caller then passes that tensor as
// `centre`, read at the output's own index.  Built with -fmad=false and
// without fast math, so the product
// x[k1] * w1 is rounded and every other step is the written __fmaf_rn.
// The result is rounded to float16 and back when the cascade's carry is
// float16 (the plain version's .to(float16).float()), and stored as
// float32.
//
// What bounds it: memory, 4 bytes read and 4 written a voxel.  A block
// loads a segment of lines, with the taps' reach on both sides, into shared
// memory once, and every tap reads the tile: along an outer axis 32
// neighbouring lines (one coalesced row of the inner extent a load) by 64
// outputs, each thread 8 outputs of one line; along the last axis 256
// outputs of one line, a thread each.  Blocks step over the grid's extent
// where there are more lines or segments than it holds.  The taps reach at
// most 128 voxels (the tiles' margin): the Gaussian and LoG taps of the
// Filter and the Markers reach 4 sigma, far below that.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdlib>

namespace {

constexpr int MAX_TAPS = 256;
constexpr int THREADS = 256;
constexpr int MAX_REACH = 128;        // the taps' largest |offset|: the tiles' margin
constexpr int LINES = 32, SEG = 64;   // outer-axis tile: lines x outputs a line
constexpr int ROW_SEG = THREADS;      // last-axis tile: outputs of one line

struct Taps {
  int count;
  int offset[MAX_TAPS];   // tap k reads the input at i + offset[k]
  float weight[MAX_TAPS];
};

__device__ __forceinline__ int reflect(int idx, int n) {
  const int period = 2 * n;
  int m = idx % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

// The taps' sum at one output; shared: that output position's flags of
// the taps whose product is computed once (null: none)
template <bool ROUND_HALF, class At>
__device__ __forceinline__ float tap_sum(const Taps& taps, const At& at,
                                         const uint8_t* __restrict__ shared) {
  float acc;
  if (taps.count == 1) {
    acc = __fmul_rn(at(0), taps.weight[0]);
  } else if (shared == nullptr) {
    acc = __fmaf_rn(at(0), taps.weight[0], __fmul_rn(at(1), taps.weight[1]));
    for (int k = 2; k < taps.count; ++k) acc = __fmaf_rn(at(k), taps.weight[k], acc);
  } else {
    const float p0 = __fmul_rn(at(0), taps.weight[0]);
    const float p1 = __fmul_rn(at(1), taps.weight[1]);
    if (shared[0] && shared[1])
      acc = __fadd_rn(p0, p1);
    else if (shared[0])
      acc = __fmaf_rn(at(1), taps.weight[1], p0);
    else
      acc = __fmaf_rn(at(0), taps.weight[0], p1);
    for (int k = 2; k < taps.count; ++k)
      acc = shared[k] ? __fadd_rn(acc, __fmul_rn(at(k), taps.weight[k]))
                      : __fmaf_rn(at(k), taps.weight[k], acc);
  }
  return ROUND_HALF ? __half2float(__float2half_rn(acc)) : acc;
}

// along an outer axis: block (LINES, THREADS / LINES), grid (inner tiles,
// segments, outer lines), the last two stepping over what the grid lacks
template <bool ROUND_HALF>
__global__ void __launch_bounds__(THREADS)
outer_axis_kernel(const float* __restrict__ x, float* __restrict__ out, int n, long long inner,
                  long long outer, int reach, const Taps taps,
                  const uint8_t* __restrict__ shared, const float* __restrict__ centre) {
  __shared__ float tile[(SEG + 2 * MAX_REACH) * LINES];
  const long long j = static_cast<long long>(blockIdx.x) * LINES + threadIdx.x;
  const int rows = SEG + 2 * reach;
  const int segments = (n + SEG - 1) / SEG;
  for (long long o = blockIdx.z; o < outer; o += gridDim.z) {
    const long long line0 = o * n;  // (outer, 0)
    for (int seg = blockIdx.y; seg < segments; seg += gridDim.y) {
      const int seg0 = seg * SEG;
      __syncthreads();  // the previous tile's reads are done
      for (int r = threadIdx.y; r < rows; r += blockDim.y)
        tile[r * LINES + threadIdx.x] =
            j < inner ? __ldg(x + (line0 + reflect(seg0 - reach + r, n)) * inner + j) : 0.f;
      __syncthreads();
      if (j >= inner) continue;
      for (int i = seg0 + threadIdx.y; i < seg0 + SEG && i < n; i += blockDim.y) {
        const int base = i - seg0 + reach;
        const long long at = (line0 + i) * inner + j;
        out[at] = tap_sum<ROUND_HALF>(
            taps,
            [&](int k) {
              return centre && taps.offset[k] == 0
                         ? __ldg(centre + at)
                         : tile[(base + taps.offset[k]) * LINES + threadIdx.x];
            },
            shared ? shared + static_cast<long long>(i) * taps.count : nullptr);
      }
    }
  }
}

// along the last axis: block THREADS, grid (segments, lines)
template <bool ROUND_HALF>
__global__ void __launch_bounds__(THREADS)
last_axis_kernel(const float* __restrict__ x, float* __restrict__ out, int n, long long lines,
                 int reach, const Taps taps, const uint8_t* __restrict__ shared,
                 const float* __restrict__ centre) {
  __shared__ float tile[ROW_SEG + 2 * MAX_REACH];
  const int seg0 = blockIdx.x * ROW_SEG;
  for (long long line = blockIdx.y; line < lines; line += gridDim.y) {
    const float* src = x + line * n;
    __syncthreads();  // the previous line's reads are done
    for (int t = threadIdx.x; t < ROW_SEG + 2 * reach; t += THREADS)
      tile[t] = __ldg(src + reflect(seg0 - reach + t, n));
    __syncthreads();
    const int i = seg0 + threadIdx.x;
    if (i < n)
      out[line * n + i] = tap_sum<ROUND_HALF>(
          taps,
          [&](int k) {
            return centre && taps.offset[k] == 0 ? __ldg(centre + line * n + i)
                                                 : tile[threadIdx.x + reach + taps.offset[k]];
          },
          shared ? shared + static_cast<long long>(i) * taps.count : nullptr);
  }
}

}  // namespace

extern "C" {

// x and out: total float32 voxels in C order, viewed as (outer, n, inner)
// with the correlation along n; `count` taps (1 <= count <= 256) at input
// offsets `offsets` (each |offset| <= 128) with float32 `weights`;
// round_half: round each result to float16 and back.
// shared: device flags (n x count bytes) of the taps whose product is
// computed once at each output position, or null; centre: float32 like x,
// read by the tap at offset 0 in place of x, or null
int gauss_axis(const float* x, float* out, long long total, long long n, long long inner,
               int count, const int* offsets, const float* weights, int round_half,
               const uint8_t* shared, const float* centre, void* stream) {
  if (total < 1 || n < 1 || inner < 1 || total % (n * inner) != 0 || count < 1 ||
      count > MAX_TAPS || n > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  taps.count = count;
  for (int k = 0; k < count; ++k) {
    taps.offset[k] = offsets[k];
    taps.weight[k] = weights[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int reach = 0;
  for (int k = 0; k < count; ++k) reach = std::max(reach, std::abs(offsets[k]));
  if (reach > MAX_REACH) return static_cast<int>(cudaErrorInvalidValue);
  const long long outer = total / (n * inner);
  constexpr long long GRID_YZ = 65535;
  if (inner > 1) {
    const long long segments = (n + SEG - 1) / SEG;
    const dim3 grid(static_cast<unsigned>((inner + LINES - 1) / LINES),
                    static_cast<unsigned>(std::min(segments, GRID_YZ)),
                    static_cast<unsigned>(std::min(outer, GRID_YZ)));
    const dim3 block(LINES, THREADS / LINES);
    if (round_half)
      outer_axis_kernel<true><<<grid, block, 0, s>>>(x, out, static_cast<int>(n), inner, outer,
                                                     reach, taps, shared, centre);
    else
      outer_axis_kernel<false><<<grid, block, 0, s>>>(x, out, static_cast<int>(n), inner, outer,
                                                      reach, taps, shared, centre);
  } else {
    const dim3 grid(static_cast<unsigned>((n + ROW_SEG - 1) / ROW_SEG),
                    static_cast<unsigned>(std::min(outer, GRID_YZ)));
    if (round_half)
      last_axis_kernel<true><<<grid, THREADS, 0, s>>>(x, out, static_cast<int>(n), outer, reach,
                                                      taps, shared, centre);
    else
      last_axis_kernel<false><<<grid, THREADS, 0, s>>>(x, out, static_cast<int>(n), outer, reach,
                                                       taps, shared, centre);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
