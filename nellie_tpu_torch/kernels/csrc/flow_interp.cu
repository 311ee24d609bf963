// Cost- and inverse-distance-weighted flow interpolation, for Hopper (sm_90a).
//
// Replaces the tile loop of nellie_tpu/stages/flow_interpolation.py
// (_interp_tile_body, :29-55, under _interp_all_kernel, :61-77), a masked
// (Q, M) distance matrix per tile written for the TPU, and the port's plain
// body (stages/flow_interpolation.py::_interp_tile_body), which makes about
// six launches for every four flow rows to keep XLA's rounding.  For each
// query q (physical coordinates, d = 2 or 3) and the M flow rows (anchor f,
// vector v, cost c) of its frame:
//
//   dist = |q - f|;  in = dist <= max_distance
//   dw = (any in-radius row at dist 0) ? (dist == 0) : (dist > 0 ? 1/dist : 0)
//   w = in ? (-c * dw - min_in(-c * dw)) + 1 : 0;  w /= (sum w > 0 ? sum w : 1)
//   out = sum_m w v  (NaN where no row is in the radius)
//
// Rounding: every step rounds where the plain body rounds, and the plain
// body rounds as XLA does on the CPU, so the result is the JAX package's
// bit for bit.  The file is built with -fmad=false and without fast math,
// so the compiler fuses no multiply-add of its own; each fused one below
// is written out (__fmaf_rn) and every other step is an __f*_rn intrinsic:
//   - diff = q - f; the squared norm d0*d0, then __fmaf_rn(dk, dk, acc);
//   - dist = __fsqrt_rn (correctly rounded, as XLA's sqrt);
//   - 1/dist = __fdiv_rn; w_min the minimum of the rounded products
//     -c * dw over the radius (NaN propagates, as torch.amin);
//   - w = __fmaf_rn(-c, dw, -w_min) + 1;
//   - sum w in XLA's tree order, as the JAX stages run it on flow rows
//     padded at the end to a power of two: windows of 32 consecutive rows
//     summed left to right, the window sums likewise, until at most 32
//     remain, which are summed left to right.  One accumulator per level;
//     a level's sum is added to the next at its window's end;
//   - w / sum = __fdiv_rn;
//   - sum_m w v in XLA's dot order: four lanes by m mod 4, each starting
//     with its first product and taking __fmaf_rn in m order, M padded
//     with zero rows to a multiple of 4, combined as (s0 + s1) + (s2 + s3).
// The plain body's fused multiply-adds compute in float64 and round twice
// (kernels/_fp.py::fma), so it may differ from this kernel on about one
// operation in 2**29; this kernel's are exact.
//
// Rows outside the radius add an exact +0 to sums that are never -0, so
// the weight passes skip them; the dot takes every row, since the sign of
// a zero lane depends on them.  A row is inside the radius when its
// squared norm is at most thresh, the largest float whose correctly
// rounded root is at most max_distance (the wrapper computes it): the root
// rounds monotonically, so the test is the plain body's, and the root and
// the division are taken only for rows inside.
//
// What bounds it: operations.  Each (query, row) pair costs 2d + 1 float
// operations for the squared norm in each of three passes, and 2d for the
// dot (about 19 at d = 3), against 16 + 4d bytes a query and 4(2d + 1) a
// row read once.  The design: one thread per query, rows streamed through
// shared memory in tiles of TILE rows read by every thread of the block
// (broadcast), three passes over the rows: (1) the radius flags, whether
// a row lies at distance 0, and the minimum weight under both weightings;
// (2) the weight sum; (3) the dot.  Everything stays in registers.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;     // queries per block
constexpr int TILE = 256;        // flow rows per shared-memory tile (a multiple of 32)
constexpr int MAX_LEVELS = 7;    // tree-sum levels: 32**6 < 2**31 rows

__device__ __forceinline__ float nan_min(float m, float p) {
  return (p < m || p != p) ? p : m;
}

template <int D>
__device__ __forceinline__ float squared_norm(const float* q, const float* f) {
  const float d0 = __fsub_rn(q[0], f[0]);
  float s = __fmul_rn(d0, d0);
#pragma unroll
  for (int k = 1; k < D; ++k) {
    const float dk = __fsub_rn(q[k], f[k]);
    s = __fmaf_rn(dk, dk, s);
  }
  return s;
}

// the distance weight of a row inside the radius
__device__ __forceinline__ float distance_weight(float s, bool has_zero) {
  const float dist = __fsqrt_rn(s);
  if (has_zero) return dist == 0.0f ? 1.0f : 0.0f;
  return dist > 0.0f ? __fdiv_rn(1.0f, dist) : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flow_interp_kernel(const float* __restrict__ query, const float* __restrict__ flow,
                   const float* __restrict__ vectors, const float* __restrict__ costs, int n_q,
                   int n_m, float thresh, int levels, float* __restrict__ out) {
  __shared__ float s_flow[TILE * D];
  __shared__ float s_vec[TILE * D];
  __shared__ float s_cost[TILE];

  const int qi = blockIdx.x * THREADS + threadIdx.x;
  const bool active = qi < n_q;
  float q[D];
#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = active ? query[(long long)qi * D + k] : 0.0f;

  // pass 1: any row in the radius, any at distance 0, the minimum weights
  bool any = false, has_zero = false;
  float min_inv = CUDART_INF_F, min_zero = CUDART_INF_F;
  for (int base = 0; base < n_m; base += TILE) {
    const int rows = min(TILE, n_m - base);
    for (int r = threadIdx.x; r < rows; r += THREADS) {
#pragma unroll
      for (int k = 0; k < D; ++k) s_flow[r * D + k] = flow[(long long)(base + r) * D + k];
      s_cost[r] = costs[base + r];
    }
    __syncthreads();
    if (active) {
      for (int r = 0; r < rows; ++r) {
        const float s = squared_norm<D>(q, s_flow + r * D);
        if (!(s <= thresh)) continue;
        any = true;
        const float cw = -s_cost[r];
        const float dist = __fsqrt_rn(s);
        const bool zero = dist == 0.0f;
        has_zero |= zero;
        const float inv = dist > 0.0f ? __fdiv_rn(1.0f, dist) : 0.0f;
        min_inv = nan_min(min_inv, __fmul_rn(cw, inv));
        min_zero = nan_min(min_zero, __fmul_rn(cw, zero ? 1.0f : 0.0f));
      }
    }
    __syncthreads();
  }
  const float neg_w_min = -(has_zero ? min_zero : min_inv);

  // pass 2: the weight sum in XLA's tree order
  float acc[MAX_LEVELS];
#pragma unroll
  for (int j = 0; j < MAX_LEVELS; ++j) acc[j] = 0.0f;
  for (int base = 0; base < n_m; base += TILE) {
    const int rows = min(TILE, n_m - base);
    for (int r = threadIdx.x; r < rows; r += THREADS) {
#pragma unroll
      for (int k = 0; k < D; ++k) s_flow[r * D + k] = flow[(long long)(base + r) * D + k];
      s_cost[r] = costs[base + r];
    }
    __syncthreads();
    if (active && any) {
      for (int r = 0; r < rows; ++r) {
        const float s = squared_norm<D>(q, s_flow + r * D);
        if (s <= thresh) {
          const float w = __fadd_rn(
              __fmaf_rn(-s_cost[r], distance_weight(s, has_zero), neg_w_min), 1.0f);
          acc[0] = __fadd_rn(acc[0], w);
        }
        const long long done = (long long)base + r + 1;  // rows summed so far
#pragma unroll
        for (int j = 0; j < MAX_LEVELS - 1; ++j) {  // a full window moves up a level
          if (j >= levels || (done & ((1LL << (5 * (j + 1))) - 1)) != 0) break;
          acc[j + 1] = __fadd_rn(acc[j + 1], acc[j]);
          acc[j] = 0.0f;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < MAX_LEVELS - 1; ++j)
    if (j < levels) acc[j + 1] = __fadd_rn(acc[j + 1], acc[j]);
  float w_sum = acc[0];
#pragma unroll
  for (int j = 1; j < MAX_LEVELS; ++j)
    if (j == levels) w_sum = acc[j];
  const float safe = w_sum > 0.0f ? w_sum : 1.0f;

  // pass 3: the dot with the vectors in four lanes by m mod 4
  float lane[4][D];
  const int n_m4 = (n_m + 3) & ~3;  // zero rows pad M to a multiple of 4
  for (int base = 0; base < n_m4; base += TILE) {
    const int rows = min(TILE, n_m - base);
    for (int r = threadIdx.x; r < rows; r += THREADS) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        s_flow[r * D + k] = flow[(long long)(base + r) * D + k];
        s_vec[r * D + k] = vectors[(long long)(base + r) * D + k];
      }
      s_cost[r] = costs[base + r];
    }
    __syncthreads();
    if (active && any) {
      const int rows4 = min(TILE, n_m4 - base);
      for (int r = 0; r < rows4; r += 4) {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int m = base + r + l;
          float wn = 0.0f;
          float v[D];
          if (m < n_m) {
            const float s = squared_norm<D>(q, s_flow + (r + l) * D);
            if (s <= thresh) {
              const float w = __fadd_rn(
                  __fmaf_rn(-s_cost[r + l], distance_weight(s, has_zero), neg_w_min), 1.0f);
              wn = __fdiv_rn(w, safe);
            }
#pragma unroll
            for (int k = 0; k < D; ++k) v[k] = s_vec[(r + l) * D + k];
          } else {
#pragma unroll
            for (int k = 0; k < D; ++k) v[k] = 0.0f;
          }
#pragma unroll
          for (int k = 0; k < D; ++k)
            lane[l][k] = m < 4 ? __fmul_rn(wn, v[k]) : __fmaf_rn(wn, v[k], lane[l][k]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < D; ++k)
    out[(long long)qi * D + k] =
        any ? __fadd_rn(__fadd_rn(lane[0][k], lane[1][k]), __fadd_rn(lane[2][k], lane[3][k]))
            : __int_as_float(0x7fc00000);  // torch's NaN
}

}  // namespace

extern "C" {

// out (Q, d) float32 = the interpolated flow at each query (Q, d) from the
// flow rows' anchors (M, d), vectors (M, d) and costs (M,), all float32 and
// C-contiguous.  thresh: the largest squared norm inside the radius;
// levels: the tree sum's window levels (0 when M <= 32).
int flow_interp_f32(const void* query, const void* flow, const void* vectors, const void* costs,
                    int n_q, int n_m, int dim, float thresh, int levels, void* out,
                    void* stream) {
  if (n_q < 1 || n_m < 1 || levels < 0 || levels >= MAX_LEVELS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n_q + THREADS - 1) / THREADS;
  const float* q = (const float*)query;
  const float* f = (const float*)flow;
  const float* v = (const float*)vectors;
  const float* c = (const float*)costs;
  if (dim == 2)
    flow_interp_kernel<2><<<blocks, THREADS, 0, s>>>(q, f, v, c, n_q, n_m, thresh, levels,
                                                     (float*)out);
  else if (dim == 3)
    flow_interp_kernel<3><<<blocks, THREADS, 0, s>>>(q, f, v, c, n_q, n_m, thresh, levels,
                                                     (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
