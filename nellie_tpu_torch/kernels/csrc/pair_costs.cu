// The tracker's z-scored pair costs and their row and column minima, for
// Hopper (sm_90a): a memset and one launch a call, no host read.
//
// Replaces nellie_tpu/kernels/matching.py::pair_costs (matching.py:61-87),
// jnp over the (N_post, N_pre) pairs of a padded tile, and the port's plain
// body (kernels/matching.py::pair_costs_plain): one fma_f32 launch and a few
// small ops a feature over the whole cost matrix (dozens of CUDA kernels a
// call), then torch.min over both axes.
//
// What it computes, exactly as the plain body does (built with -fmad=false):
// the gate of pair_gate.cuh, and for a gated pair only
//   cost = (dist / max_distance - mean[0]) / std[0]
//   then for each feature f in order: d = |post[i][f] - pre[j][f]|,
//   z = (d - mean[1 + f]) / std[1 + f],  cost = fma(z, w_f, cost)
// with w_f = float32(1 / n_stats) for the statistics and float32(1 / n_hu)
// for the Hu features (the host computes them as the plain body does).
// Every other pair costs +inf and is never computed.  Then each row's and
// each column's minimum and its index with torch.min(dim)'s semantics: a NaN
// is the minimum, -0 equals +0, and a tie keeps the first index; a row or
// column whose pairs all cost +inf (gated or not) gives (+inf, 0).
//
// What bounds it: the gate of every pair (at the 2D path's 4.8 million
// pairs, a root a pair, a few microseconds of issue) and the latency of the
// loads around it; the costs are few (1.0 % of the 3D path's pairs are
// gated, 0.32 % of the 2D path's).  What the design does about it:
//  * the blocks, the staging, the gate and the list of gated pairs are
//    pair_sums.cu's (pair_gate.cuh); then a thread a gated pair computes its
//    cost (its distance again, with the gate's arithmetic; the features
//    from device memory);
//  * a minimum is an ordered 64-bit key, (the cost's order, index): NaN
//    orders first, -0 as +0, and the smaller index wins a tie.  The block
//    reduces its keys in shared memory (an atomicMin a row and a column),
//    then makes one 64-bit atomic a row or column it touched in device
//    memory (keys stored inverted, so that the memset's 0 is "none", and
//    taken by atomicMax);
//  * the block that finishes last (a counter, fenced) turns the keys into
//    values and indices, 16 keys' loads in flight a thread: the value is
//    the cost at the chosen index, decoded from its order where that is
//    exact and recomputed for a zero (its sign) or a NaN (its bits).  The
//    values and indices land in one buffer that the caller copies to the
//    host in one read.

#include "pair_gate.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using pair_gate::THREADS;
using pair_gate::Tile;
using pair_gate::W;

constexpr int MAX_SUMS = 64;  // 1 + n_feat: the launch carries the moments and weights
constexpr unsigned ORD_ZERO = 0x80000000u;  // the order of -0 and +0
constexpr unsigned ORD_INF = 0xff800000u;   // the order of +inf
constexpr unsigned long long NO_KEY = ~0ULL;

struct Params {
  float mean[MAX_SUMS], stdv[MAX_SUMS];  // the distance's, then each feature's
  float w[MAX_SUMS];                     // each feature's weight
};

struct Job {
  Tile t;
  unsigned long long* keys;  // n_post row keys, n_pre column keys (inverted; 0 none)
  unsigned* done;            // blocks finished
  float* vals;               // n_post row minima, n_pre column minima
  long long* idx;            // their indices
};

// torch.min's order of a float32 as an unsigned key: NaN first, -0 as +0.
__device__ __forceinline__ unsigned order_of(float x) {
  if (x != x) return 0u;
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The cost of a gated pair at distance dist, features fi and fj (device
// memory).
__device__ __forceinline__ float pair_cost(float dist, const float* fi, const float* fj, int F,
                                           float max_d, const Params& p) {
  float cost = __fdiv_rn(__fsub_rn(pair_gate::pair_dn(dist, max_d), p.mean[0]), p.stdv[0]);
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float d = fabsf(__fsub_rn(__ldg(fi + f), __ldg(fj + f)));
    const float z = __fdiv_rn(__fsub_rn(d, p.mean[1 + f]), p.stdv[1 + f]);
    cost = __fmaf_rn(z, p.w[f], cost);
  }
  return cost;
}

__device__ __forceinline__ unsigned long long key_of(float cost, long long index) {
  return ((unsigned long long)order_of(cost) << 32) | (unsigned long long)index;
}

constexpr int DECODE_BATCH = 16;  // keys a thread of the last block loads at once
constexpr int QUEUE = 1024;       // keys the last block queues for their cost's bits

// The last block: every row's and column's key as (value, index), the
// keys loaded DECODE_BATCH a thread at a time; the few whose value needs
// the cost's own bits (a NaN or a zero) are queued and recomputed after.
template <int D>
__device__ void decode(const Job& job, const Params& p, int* queue, int* queued) {
  const Tile& t = job.t;
  const int n = t.n_post + t.n_pre, F = t.n_feat;
  if (threadIdx.x == 0) *queued = 0;
  __syncthreads();
  for (int k0 = threadIdx.x; k0 < n; k0 += DECODE_BATCH * blockDim.x) {
    unsigned long long stored[DECODE_BATCH];
#pragma unroll
    for (int b = 0; b < DECODE_BATCH; ++b) {
      const int k = k0 + b * blockDim.x;
      stored[b] = k < n ? __ldcg(job.keys + k) : 0ULL;
    }
#pragma unroll
    for (int b = 0; b < DECODE_BATCH; ++b) {
      const int k = k0 + b * blockDim.x;
      if (k < n) {
        const unsigned long long key = ~stored[b];
        const unsigned o = (unsigned)(key >> 32);
        const bool none = !stored[b] || o == ORD_INF;  // a minimum of +inf is (+inf, 0)
        job.vals[k] = none ? __int_as_float(0x7f800000) : from_order(o);
        job.idx[k] = none ? 0 : (long long)(key & 0xffffffffu);
        if (!none && (o == 0u || o == ORD_ZERO)) {
          const int slot = atomicAdd(queued, 1);
          if (slot < QUEUE) queue[slot] = k;
        }
      }
    }
  }
  __syncthreads();
  // a NaN or a zero: the cost's own bits (past the queue, a second walk)
  const int m = *queued;
  for (int e = threadIdx.x; e < (m <= QUEUE ? m : n); e += blockDim.x) {
    const int k = m <= QUEUE ? queue[e] : e;
    const unsigned long long stored = __ldcg(job.keys + k);
    const unsigned long long key = ~stored;
    const unsigned o = (unsigned)(key >> 32);
    if (!stored || (o != 0u && o != ORD_ZERO)) continue;
    const long long index = (long long)(key & 0xffffffffu);
    const long long i = k < t.n_post ? k : index, j = k < t.n_post ? index : k - t.n_post;
    job.vals[k] = pair_cost(pair_gate::pair_dist<D>(t.cpost + i * D, t.cpre + j * D),
                            t.fpost + i * F, t.fpre + j * F, F, t.max_d, p);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    pair_costs_kernel(Job job, const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  __shared__ pair_gate::Pairs pairs;
  __shared__ unsigned long long keys[W * (pair_gate::MAX_K + 1)];  // rows, then columns
  __shared__ bool last;
  __shared__ int queue[QUEUE], queued;
  const Tile& t = job.t;
  const int F = t.n_feat;
  const pair_gate::Staged st = pair_gate::carve(reinterpret_cast<float*>(smem4), D);
  const pair_gate::Block b = pair_gate::block_of(t);
  for (int k = threadIdx.x; k < W * (pair_gate::MAX_K + 1); k += THREADS) keys[k] = NO_KEY;
  const int total = pair_gate::gate_block<D>(t, b, st, pairs, nullptr);
  // the gated pairs' costs, a thread a pair; each pair's row and column key
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int ij = pairs.list[e];
    const int i = pair_gate::pair_row(ij);
    const int c = pair_gate::pair_window(ij) * W + pair_gate::pair_col(ij);
    const float dist = pair_gate::pair_dist<D>(st.row_c + i * D, st.col_c + c * D);
    const float cost = pair_cost(dist, t.fpost + (long long)(b.r0 + i) * F,
                                 t.fpre + (long long)(b.c0 + c) * F, F, t.max_d, p);
    atomicMin(keys + i, key_of(cost, b.c0 + c));
    atomicMin(keys + W + c, key_of(cost, b.r0 + i));
  }
  __syncthreads();
  // one device atomic a row or column the block touched
  for (int k = threadIdx.x; k < W * (t.k + 1); k += THREADS) {
    const unsigned long long key = keys[k];
    if (key != NO_KEY)
      atomicMax(job.keys + (k < W ? b.r0 + k : t.n_post + b.c0 + k - W), ~key);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(job.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  decode<D>(job, p, queue, &queued);
}

}  // namespace

extern "C" {

// Max features a launch takes (its moments and weights are launch arguments).
int pair_costs_max_features() { return MAX_SUMS - 1; }

// uint64 words of the keys' scratch: a key a row and a column, a counter.
long long pair_costs_key_words(int n_post, int n_pre) { return (long long)n_post + n_pre + 1; }

// The z-scored costs' row and column minima over C-contiguous float32 device
// arrays: coords (n, ndim), feats (n, n_feat); mean and stdv (n_feat + 1)
// and w (n_feat) on the host; keys pair_costs_key_words uint64, cleared here
// by a memset; out: the n_post + n_pre float32 minima (rows, then columns)
// in (n_post + n_pre + 1) / 2 uint64 words, then their n_post + n_pre int64
// indices.  kernels (host): the CUDA kernels launched (the memset aside).
int pair_costs(const void* cpost, const void* cpre, const void* fpost, const void* fpre,
               int n_post, int n_pre, int ndim, int n_feat, float max_distance,
               const float* mean, const float* stdv, const float* w, void* keys, void* out,
               int* kernels, void* stream) {
  *kernels = 0;
  if (ndim < 1 || ndim > 3 || n_feat < 0 || n_feat + 1 > MAX_SUMS || n_post < 1 || n_pre < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int f = 0; f <= n_feat; ++f) {
    p.mean[f] = mean[f];
    p.stdv[f] = stdv[f];
  }
  for (int f = 0; f < n_feat; ++f) p.w[f] = w[f];
  Job job;
  job.t.cpost = (const float*)cpost;
  job.t.cpre = (const float*)cpre;
  job.t.fpost = (const float*)fpost;
  job.t.fpre = (const float*)fpre;
  job.t.n_post = n_post;
  job.t.n_pre = n_pre;
  job.t.n_feat = n_feat;
  job.t.max_d = max_distance;
  job.t.win_rows = (n_post + W - 1) / W;
  job.t.win_cols = (n_pre + W - 1) / W;
  job.t.k = pair_gate::windows_a_block((long long)job.t.win_rows * job.t.win_cols);
  job.t.groups = (job.t.win_cols + job.t.k - 1) / job.t.k;
  job.t.aligned = (((uintptr_t)cpost | (uintptr_t)cpre) & 15) == 0;
  const long long n = (long long)n_post + n_pre;
  job.keys = (unsigned long long*)keys;
  job.done = (unsigned*)(job.keys + n);
  job.vals = (float*)out;
  job.idx = (long long*)out + (n + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(keys, 0, 8 * pair_costs_key_words(n_post, n_pre), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * pair_gate::staged_floats(ndim, job.t.k);
  void (*kernel)(Job, const Params) = ndim == 1 ? pair_costs_kernel<1>
                                    : (ndim == 2 ? pair_costs_kernel<2> : pair_costs_kernel<3>);
  if ((err = pair_gate::allow_shared(kernel, smem)) != cudaSuccess) return (int)err;
  kernel<<<job.t.win_rows * job.t.groups, THREADS, smem, st>>>(job, p);
  *kernels = 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
