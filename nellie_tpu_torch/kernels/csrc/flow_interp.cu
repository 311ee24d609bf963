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
// is written out (__fmaf_rn, one rounding, as the plain body's _fp.fma)
// and every other step is an __f*_rn intrinsic:
//   - diff = q - f; the squared norm d0*d0, then __fmaf_rn(dk, dk, acc);
//   - dist = __fsqrt_rn (correctly rounded, as XLA's sqrt);
//   - 1/dist = __fdiv_rn; w_min the minimum of the rounded products
//     -c * dw over the radius (NaN propagates, as torch.amin);
//   - w = __fmaf_rn(-c, dw, -w_min) + 1;
//   - sum w in XLA's tree order, as the JAX stages run it on flow rows
//     padded at the end to a power of two: windows of 32 consecutive rows
//     summed left to right, the window sums likewise, until at most 32
//     remain, which are summed left to right;
//   - w / sum = __fdiv_rn;
//   - sum_m w v in XLA's dot order: four lanes by m mod 4, each starting
//     with its first product and taking __fmaf_rn in m order, M padded
//     with zero rows to a multiple of 4, combined as (s0 + s1) + (s2 + s3).
//
// A row is inside the radius when its squared norm is at most thresh, the
// largest float whose correctly rounded root is at most max_distance (the
// wrapper computes it): the root rounds monotonically, so the test is the
// plain body's, and the root and the division are taken only for rows
// inside.
//
// What bounds it: operations.  Every (query, row) pair needs its squared
// norm (3d - 1 flops); only the pairs inside the radius, a few per query,
// need the weight and the dot.  The design:
//
// 1. The row table (anchor and cost as one float4 a row) is loaded into
//    shared memory once per block when it fits (16 bytes a row: 10 KB at
//    M = 648, 70 KB at M = 4,391; up to the 227 KB a block may opt into).
//    Blocks are as many as stay resident (of 128 threads, or 512 when the
//    table is over 32 KB, so that the two blocks of a 70 KB table still
//    give an SM 32 warps), and each warp walks over items of 32 queries
//    dealt to the blocks in turn, so the load is paid once per block,
//    every SM gets as many items, and no barrier stands in the row loop.
//    A larger table streams through two shared tiles filled with cp.async
//    while the other is read; then the block walks over items of 128
//    queries together.
// 2. A thread holds one query.  Two or four queries a thread, each
//    shared-memory read feeding them all, ran slower at both main-path
//    shapes (fewer warps to hide the pair loop's latency).
// 3. One pass over every pair takes the radius test and appends each row
//    inside it to a per-query list of LIST row indices in shared memory;
//    nothing else runs inside that loop's branch, which a warp takes
//    wherever one of its queries has a row in the radius.
// 4. The rest runs over the list only: the distance-0 flag and the minimum
//    weights (NaN propagates through the minimum, so its order does not
//    matter), then:
//    - the tree sum keeps one accumulator per level and, between two
//      listed rows, moves each level forward across every window boundary
//      that lies between them (a skipped row would add +0 to a sum that is
//      never -0: exact);
//    - each dot lane starts at -0, the identity of a sum, and takes the
//      listed rows' products.  A skipped row adds +0 * v, which leaves a
//      nonzero lane as it is; a lane that stayed zero is -0 only when every
//      row it skipped has v's sign bit set, and NaN when one of them has a
//      v that is not finite.  Both follow from per-lane counts of such rows
//      (taken per block from the vectors) less those of the listed rows.
// 5. A query with more than LIST rows inside the radius takes three passes
//    over every row in order instead: the statistics, the weight sum with
//    window bookkeeping on each row, and the dot on each row with +0
//    weights outside the radius, reading the rows from the shared table or
//    from global memory.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // a block of the tiled path, and the smallest one
constexpr int MAX_THREADS = 512;
constexpr int LIST = 32;        // in-radius rows a query lists before it overflows
constexpr int TILE = 2048;      // rows per shared tile when the table does not fit
constexpr int MAX_LEVELS = 7;   // tree-sum levels: 32**6 < 2**31 rows
constexpr unsigned SIGN = 0x80000000u;
constexpr unsigned EXPONENT = 0x7f800000u;

// a query's statistics over its rows in the radius
struct Pass {
  bool has_zero;
  float min_inv, min_zero;
};

__device__ __forceinline__ float nan_min(float m, float p) {
  return (p < m || p != p) ? p : m;
}

template <int D>
__device__ __forceinline__ float squared_norm(const float (&q)[D], float4 a) {
  const float d0 = __fsub_rn(q[0], a.x);
  const float d1 = __fsub_rn(q[1], a.y);
  float s = __fmaf_rn(d1, d1, __fmul_rn(d0, d0));
  if (D == 3) {
    const float d2 = __fsub_rn(q[D - 1], a.z);
    s = __fmaf_rn(d2, d2, s);
  }
  return s;
}

// anchor (x, y[, z]) and cost (w) of row m: from the shared table, or from
// global memory when rows is null
template <int D>
__device__ __forceinline__ float4 row_at(const float4* rows, const float* __restrict__ flow,
                                         const float* __restrict__ costs, int m) {
  if (rows) return rows[m];
  const float* f = flow + (long long)m * D;
  return make_float4(__ldg(f), __ldg(f + 1), D == 3 ? __ldg(f + D - 1) : 0.0f, __ldg(costs + m));
}

// the weight of a row inside the radius: fma(-c, dw, -w_min) + 1
__device__ __forceinline__ float weight(float s, float cost, bool has_zero, float neg_w_min) {
  const float dist = __fsqrt_rn(s);
  const float dw = has_zero ? (dist == 0.0f ? 1.0f : 0.0f)
                            : (dist > 0.0f ? __fdiv_rn(1.0f, dist) : 0.0f);
  return __fadd_rn(__fmaf_rn(-cost, dw, neg_w_min), 1.0f);
}

// the radius statistics of one row inside it
__device__ __forceinline__ void note(Pass& p, float s, float cost) {
  const float cw = -cost;
  const float dist = __fsqrt_rn(s);
  const bool zero = dist == 0.0f;
  p.has_zero |= zero;
  const float inv = dist > 0.0f ? __fdiv_rn(1.0f, dist) : 0.0f;
  p.min_inv = nan_min(p.min_inv, __fmul_rn(cw, inv));
  p.min_zero = nan_min(p.min_zero, __fmul_rn(cw, zero ? 1.0f : 0.0f));
}

// the tree sum's accumulators after every window boundary in (prev, m]
__device__ __forceinline__ void cross(float (&acc)[MAX_LEVELS], int prev, int m, int levels) {
#pragma unroll
  for (int j = 0; j < MAX_LEVELS - 1; ++j) {
    const int shift = 5 * (j + 1);
    if (j >= levels || (m >> shift) <= (prev >> shift)) break;
    acc[j + 1] = __fadd_rn(acc[j + 1], acc[j]);
    acc[j] = 0.0f;
  }
}

__device__ __forceinline__ float tree_total(float (&acc)[MAX_LEVELS], int levels) {
#pragma unroll
  for (int j = 0; j < MAX_LEVELS - 1; ++j)
    if (j < levels) acc[j + 1] = __fadd_rn(acc[j + 1], acc[j]);
  float total = acc[0];
#pragma unroll
  for (int j = 1; j < MAX_LEVELS; ++j)
    if (j == levels) total = acc[j];
  return total;
}

__device__ __forceinline__ float combine(float l0, float l1, float l2, float l3) {
  return __fadd_rn(__fadd_rn(l0, l1), __fadd_rn(l2, l3));
}

// weight sum and dot over the listed rows of one query
template <int D, typename ListT>
__device__ __forceinline__ void finish_list(const float (&q)[D], int count, const ListT* list,
                                            int stride, const float4* rows,
                                            const float* __restrict__ flow,
                                            const float* __restrict__ vectors,
                                            const float* __restrict__ costs, int n_m, int levels,
                                            const int* lane_signed, const int* lane_nonfinite,
                                            float* out) {
  Pass p = {false, CUDART_INF_F, CUDART_INF_F};
  for (int j = 0; j < count; ++j) {
    const float4 a = row_at<D>(rows, flow, costs, (int)list[j * stride]);
    note(p, squared_norm<D>(q, a), a.w);
  }
  const float neg_w_min = -(p.has_zero ? p.min_zero : p.min_inv);
  float acc[MAX_LEVELS];
#pragma unroll
  for (int j = 0; j < MAX_LEVELS; ++j) acc[j] = 0.0f;
  int prev = -1;
  for (int j = 0; j < count; ++j) {
    const int m = (int)list[j * stride];
    const float4 a = row_at<D>(rows, flow, costs, m);
    const float w = weight(squared_norm<D>(q, a), a.w, p.has_zero, neg_w_min);
    if (prev >= 0) cross(acc, prev, m, levels);
    acc[0] = __fadd_rn(acc[0], w);
    prev = m;
  }
  cross(acc, prev, n_m, levels);
  const float w_sum = tree_total(acc, levels);
  const float safe = w_sum > 0.0f ? w_sum : 1.0f;

  float lane[4][D];
  int listed[4], signed_[4][D], nonfinite[4][D];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    listed[l] = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      lane[l][k] = -0.0f;
      signed_[l][k] = 0;
      nonfinite[l][k] = 0;
    }
  }
  for (int j = 0; j < count; ++j) {
    const int m = (int)list[j * stride];
    const float4 a = row_at<D>(rows, flow, costs, m);
    const float wn =
        __fdiv_rn(weight(squared_norm<D>(q, a), a.w, p.has_zero, neg_w_min), safe);
    float v[D];
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = __ldg(vectors + (long long)m * D + k);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      if (l != (m & 3)) continue;
      ++listed[l];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const unsigned bits = __float_as_uint(v[k]);
        lane[l][k] = __fmaf_rn(wn, v[k], lane[l][k]);
        signed_[l][k] += (int)(bits >> 31);
        nonfinite[l][k] += (bits & EXPONENT) == EXPONENT;
      }
    }
  }
  const int per_lane = (n_m + 3) >> 2;  // zero padding rows included, never signed
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (lane_nonfinite[l * D + k] > nonfinite[l][k])
        lane[l][k] = __int_as_float(0x7fc00000);  // +0 * inf or NaN
      else if (__float_as_uint(lane[l][k]) == SIGN &&
               lane_signed[l * D + k] - signed_[l][k] != per_lane - listed[l])
        lane[l][k] = 0.0f;  // a skipped +0 product
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) out[k] = combine(lane[0][k], lane[1][k], lane[2][k], lane[3][k]);
}

// weight sum and dot over every row, for a query whose list overflowed
template <int D>
__device__ __forceinline__ void finish_scan(const float (&q)[D], const float4* rows,
                                            const float* __restrict__ flow,
                                            const float* __restrict__ vectors,
                                            const float* __restrict__ costs, int n_m,
                                            float thresh, int levels, float* out) {
  Pass p = {false, CUDART_INF_F, CUDART_INF_F};
  for (int m = 0; m < n_m; ++m) {
    const float4 a = row_at<D>(rows, flow, costs, m);
    const float s = squared_norm<D>(q, a);
    if (s <= thresh) note(p, s, a.w);
  }
  const float neg_w_min = -(p.has_zero ? p.min_zero : p.min_inv);
  float acc[MAX_LEVELS];
#pragma unroll
  for (int j = 0; j < MAX_LEVELS; ++j) acc[j] = 0.0f;
  for (int m = 0; m < n_m; ++m) {
    const float4 a = row_at<D>(rows, flow, costs, m);
    const float s = squared_norm<D>(q, a);
    if (s <= thresh) acc[0] = __fadd_rn(acc[0], weight(s, a.w, p.has_zero, neg_w_min));
    const long long done = (long long)m + 1;  // rows summed so far
#pragma unroll
    for (int j = 0; j < MAX_LEVELS - 1; ++j) {  // a full window moves up a level
      if (j >= levels || (done & ((1LL << (5 * (j + 1))) - 1)) != 0) break;
      acc[j + 1] = __fadd_rn(acc[j + 1], acc[j]);
      acc[j] = 0.0f;
    }
  }
  const float w_sum = tree_total(acc, levels);
  const float safe = w_sum > 0.0f ? w_sum : 1.0f;

  float lane[4][D];
  const int n_m4 = (n_m + 3) & ~3;
  for (int base = 0; base < n_m4; base += 4) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int m = base + l;
      float wn = 0.0f;
      float v[D];
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = 0.0f;
      if (m < n_m) {
        const float4 a = row_at<D>(rows, flow, costs, m);
        const float s = squared_norm<D>(q, a);
        if (s <= thresh) wn = __fdiv_rn(weight(s, a.w, p.has_zero, neg_w_min), safe);
#pragma unroll
        for (int k = 0; k < D; ++k) v[k] = __ldg(vectors + (long long)m * D + k);
      }
#pragma unroll
      for (int k = 0; k < D; ++k)
        lane[l][k] = m < 4 ? __fmul_rn(wn, v[k]) : __fmaf_rn(wn, v[k], lane[l][k]);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) out[k] = combine(lane[0][k], lane[1][k], lane[2][k], lane[3][k]);
}

// per dot lane (row mod 4) and component: rows whose vector has its sign
// bit set, and rows whose vector is not finite; into shared counters
template <int D>
__device__ void lane_counts(const float* __restrict__ vectors, int n_m, int* lane_signed,
                            int* lane_nonfinite) {
  if (threadIdx.x < 4 * D) lane_signed[threadIdx.x] = lane_nonfinite[threadIdx.x] = 0;
  __syncthreads();
  int sg[D], nf[D];
#pragma unroll
  for (int k = 0; k < D; ++k) sg[k] = nf[k] = 0;
  for (int m = threadIdx.x; m < n_m; m += blockDim.x) {  // m & 3 == threadIdx.x & 3
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const unsigned bits = __float_as_uint(__ldg(vectors + (long long)m * D + k));
      sg[k] += (int)(bits >> 31);
      nf[k] += (bits & EXPONENT) == EXPONENT;
    }
  }
  const int l = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (sg[k]) atomicAdd(lane_signed + l * D + k, sg[k]);
    if (nf[k]) atomicAdd(lane_nonfinite + l * D + k, nf[k]);
  }
}

// the query of this thread, NaN past the last (a NaN query lies in no radius)
template <int D>
__device__ __forceinline__ void load_query(const float* __restrict__ query, int n_q, int qi,
                                           float (&q)[D]) {
#pragma unroll
  for (int k = 0; k < D; ++k)
    q[k] = qi < n_q ? __ldg(query + (long long)qi * D + k) : CUDART_NAN_F;
}

// the query's output from its count of rows in the radius: NaN without
// one, the list path with at most LIST, else the three passes
template <int D, typename ListT>
__device__ __forceinline__ void finish_query(int n_q, int qi, const float (&q)[D], int count,
                                             const ListT* list, int stride, const float4* rows,
                                             const float* __restrict__ flow,
                                             const float* __restrict__ vectors,
                                             const float* __restrict__ costs, int n_m,
                                             float thresh, int levels, const int* lane_signed,
                                             const int* lane_nonfinite, float* __restrict__ out) {
  if (qi >= n_q) return;
  float r[D];
  if (count == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) r[k] = __int_as_float(0x7fc00000);  // torch's NaN
  } else if (count <= LIST) {
    finish_list<D>(q, count, list, stride, rows, flow, vectors, costs, n_m, levels, lane_signed,
                   lane_nonfinite, r);
  } else {
    finish_scan<D>(q, rows, flow, vectors, costs, n_m, thresh, levels, r);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) out[(long long)qi * D + k] = r[k];
}

// the row table resident in shared memory; each warp takes items of 32
// queries (a query a lane), the items dealt to the blocks in turn (item g
// to block g mod gridDim.x), so that every block, and every SM, gets as
// many as the others
template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
interp_resident(const float* __restrict__ query, const float* __restrict__ flow,
                const float* __restrict__ vectors, const float* __restrict__ costs, int n_q,
                int n_m, float thresh, int levels, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* rows = smem;
  uint16_t* lists = reinterpret_cast<uint16_t*>(smem + n_m);  // [warp][LIST][32]
  __shared__ int lane_signed[4 * D], lane_nonfinite[4 * D];
  for (int m = threadIdx.x; m < n_m; m += blockDim.x)
    rows[m] = make_float4(flow[m * D], flow[m * D + 1], D == 3 ? flow[m * D + D - 1] : 0.0f,
                          costs[m]);
  lane_counts<D>(vectors, n_m, lane_signed, lane_nonfinite);
  __syncthreads();

  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31, warps = blockDim.x >> 5;
  uint16_t* list = lists + warp * LIST * 32 + t;
  const int items = (n_q + 31) / 32;
  for (int g = blockIdx.x + warp * gridDim.x; g < items; g += gridDim.x * warps) {
    const int qi = g * 32 + t;
    float q[D];
    load_query<D>(query, n_q, qi, q);
    int count = 0;
#pragma unroll 8
    for (int m = 0; m < n_m; ++m) {  // eight rows' shared loads in flight
      if (squared_norm<D>(q, rows[m]) <= thresh) {
        if (count < LIST) list[count * 32] = (uint16_t)m;
        ++count;
      }
    }
    finish_query<D>(n_q, qi, q, count, list, 32, rows, flow, vectors, costs, n_m, thresh, levels,
                    lane_signed, lane_nonfinite, out);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int D>
__device__ __forceinline__ void fetch_tile(float4* buf, const float* __restrict__ flow,
                                           const float* __restrict__ costs, int base, int rows) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const long long m = (long long)base + r;
    float* dst = reinterpret_cast<float*>(buf + r);
    cp_async4(dst, flow + m * D);
    cp_async4(dst + 1, flow + m * D + 1);
    if (D == 3) cp_async4(dst + 2, flow + m * D + D - 1);
    cp_async4(dst + 3, costs + m);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// the row table streamed through two shared tiles; the block walks over
// items of THREADS queries together (query t of item g: g * THREADS + t)
template <int D>
__global__ void __launch_bounds__(THREADS)
interp_tiled(const float* __restrict__ query, const float* __restrict__ flow,
             const float* __restrict__ vectors, const float* __restrict__ costs, int n_q,
             int n_m, float thresh, int levels, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* tiles[2] = {smem, smem + TILE};
  int* lists = reinterpret_cast<int*>(smem + 2 * TILE);  // [LIST][THREADS]
  __shared__ int lane_signed[4 * D], lane_nonfinite[4 * D];
  lane_counts<D>(vectors, n_m, lane_signed, lane_nonfinite);
  __syncthreads();

  int* list = lists + threadIdx.x;
  const int items = (n_q + THREADS - 1) / THREADS;
  const int n_tiles = (n_m + TILE - 1) / TILE;
  for (int g = blockIdx.x; g < items; g += gridDim.x) {
    const int qi = g * THREADS + threadIdx.x;
    float q[D];
    load_query<D>(query, n_q, qi, q);
    int count = 0;
    fetch_tile<D>(tiles[0], flow, costs, 0, min(TILE, n_m));
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int base = tile * TILE;
      if (tile + 1 < n_tiles) {
        fetch_tile<D>(tiles[(tile + 1) & 1], flow, costs, base + TILE,
                      min(TILE, n_m - base - TILE));
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const float4* rows = tiles[tile & 1];
      const int n_rows = min(TILE, n_m - base);
#pragma unroll 4
      for (int r = 0; r < n_rows; ++r) {
        if (squared_norm<D>(q, rows[r]) <= thresh) {
          if (count < LIST) list[count * THREADS] = base + r;
          ++count;
        }
      }
      __syncthreads();  // every thread is done with the tile before it is refilled
    }
    finish_query<D>(n_q, qi, q, count, list, THREADS, nullptr, flow, vectors, costs, n_m, thresh,
                    levels, lane_signed, lane_nonfinite, out);
  }
}

// The host state below is shared by every call on every host thread and
// holds no lock of its own: callers serialise their calls (the Python
// wrapper holds its lock across the call, since ctypes releases the GIL).
constexpr int MAX_DEVICES = 64;

// a device's multiprocessors and the dynamic shared memory a block may opt
// in to (less this file's static shared memory)
struct Device {
  int sms;
  int max_shared;
};
Device devices[MAX_DEVICES];

cudaError_t device_info(int device, Device* info) {
  Device& d = devices[device];
  if (!d.sms) {
    int sms = 0, max_shared = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&max_shared, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    // static shared memory (the lane counters) comes out of the same budget
    d.max_shared = max_shared - 2 * 4 * 3 * (int)sizeof(int);
    d.sms = sms;
  }
  *info = d;
  return cudaSuccess;
}

// one kernel's state per device: whether its dynamic shared memory limit is
// raised (once, to the device's maximum, and never lowered: a launch on
// another thread never sees a limit below its size) and its resident blocks
// per SM for the last block and size asked, so that a caller's repeated
// calls make no attribute or occupancy query
struct LaunchCache {
  bool opted_in[MAX_DEVICES];
  size_t shared[MAX_DEVICES];
  int threads[MAX_DEVICES];
  int per_sm[MAX_DEVICES];
};

template <typename Kernel>
cudaError_t launch(Kernel kernel, LaunchCache& cache, int device, const Device& info,
                   int threads, size_t shared, long long blocks_needed, const float* q,
                   const float* f, const float* v, const float* c, int n_q, int n_m,
                   float thresh, int levels, float* out, cudaStream_t s) {
  if (!cache.opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           info.max_shared);
    if (err != cudaSuccess) return err;
    cache.opted_in[device] = true;
  }
  if (shared != cache.shared[device] || threads != cache.threads[device]) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cache.per_sm + device,
                                                                    kernel, threads, shared);
    if (err != cudaSuccess) return err;
    cache.shared[device] = shared;
    cache.threads[device] = threads;
  }
  const int per_sm = cache.per_sm[device];
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * info.sms;
  const int grid = (int)(blocks_needed < resident ? blocks_needed : resident);
  kernel<<<grid, threads, shared, s>>>(q, f, v, c, n_q, n_m, thresh, levels, out);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const float* q, const float* f, const float* v, const float* c, int n_q,
                     int n_m, float thresh, int levels, float* out, cudaStream_t s) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Device info;
  err = device_info(device, &info);
  if (err != cudaSuccess) return err;
  static LaunchCache resident_cache, tiled_cache;  // one each for this D
  // a table that limits the blocks an SM holds gets larger blocks, so that
  // each SM still runs many warps
  const size_t table = (size_t)n_m * sizeof(float4);
  const int threads = table > 32 * 1024 ? MAX_THREADS : THREADS;
  const size_t resident = table + (size_t)(threads / 32) * LIST * 32 * sizeof(uint16_t);
  if (n_m <= 65535 && resident <= (size_t)info.max_shared) {
    const long long warps_needed = ((long long)n_q + 31) / 32;
    return launch(interp_resident<D>, resident_cache, device, info, threads, resident,
                  (warps_needed + threads / 32 - 1) / (threads / 32), q, f, v, c, n_q, n_m,
                  thresh, levels, out, s);
  }
  const size_t tiled = 2 * TILE * sizeof(float4) + (size_t)LIST * THREADS * sizeof(int);
  return launch(interp_tiled<D>, tiled_cache, device, info, THREADS, tiled,
                ((long long)n_q + THREADS - 1) / THREADS, q, f, v, c, n_q, n_m, thresh, levels,
                out, s);
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
  if (n_q < 1 || n_m < 1 || levels < 0 || levels >= MAX_LEVELS || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  const float* q = (const float*)query;
  const float* f = (const float*)flow;
  const float* v = (const float*)vectors;
  const float* c = (const float*)costs;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dim == 2 ? dispatch<2>(q, f, v, c, n_q, n_m, thresh, levels, (float*)out, s)
                        : dispatch<3>(q, f, v, c, n_q, n_m, thresh, levels, (float*)out, s));
}

}  // extern "C"
