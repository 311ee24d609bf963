// The tracker's distance-gated pair sums, for Hopper (sm_90a): a memset and
// one or two launches a call, and one copy to the host.
//
// Replaces nellie_tpu/kernels/matching.py::pair_stats (matching.py:40-60),
// jnp sums over the (N_post, N_pre) pairs of a padded tile, and the port's
// plain body (kernels/matching.py::pair_stats_plain): a Python loop over the
// 32 x 32 elements of XLA's first reduction window, then the later levels
// one launch an add (about 12,300 CUDA kernels a call on the main paths).
//
// What it computes, exactly as the plain body does (built with -fmad=false,
// every contraction an explicit __fmaf_rn, every division and root IEEE).
// The gate and the normalised distance are pair_gate.cuh's.  Feature 0 is
// that distance and feature f = 1..F is |feats_post[i][f-1] -
// feats_pre[j][f-1]|; a gated pair adds d to the feature's sum and d * d
// (rounded on its own) to its sum of squares, any other pair adds +0.
//
// Each sum is XLA's CPU tree reduction of the padded tile (kernels/_fp.py::
// tree_sum_2d), kept in its order:
//  * level 1: every 32 x 32 window of pairs summed in row-major order.  The
//    window grid is the reference's padded tile over 32 (rows x cols);
//    windows past the real pairs are zero windows;
//  * while either axis of the window sums is longer than 32: windows of
//    32 x 32 summed in row-major order (zero padded at the ends), except
//    where the last axis is 4 or 8 long and there are more than 32 rows:
//    there LLVM vectorises the 32-row window across 8 or 4 row lanes (lane
//    l sums the rows l, l + lanes, ... of the window, each row's columns in
//    order) and adds the lanes in halves (_fp._window_sums_2d, _WINDOW_LANES);
//  * at most 32 x 32 left: added one at a time in row-major order.
// Every term is +0, positive or NaN (a distance, an absolute difference, a
// square, or a sum of such), and a sum that is not -0 plus +0 is that sum,
// bit for bit.  So every chain here starts from +0 and adds its nonzero
// terms (the gated pairs' at level 1), in the reference's order, and gives
// the plain body's bits at every level (the reference's lanes 1..7 start
// from -0 but add at least one term; the card's add returns its canonical
// NaN, which a start from +0 and an add reproduce for a first term that is
// NaN).
//
// What bounds it: the latency of the dependent adds and of the loads
// before them, not bytes (the inputs are a few hundred kilobytes), and at
// the 2D path's 4.8 million pairs the gate's issue (a root a pair).  1.0 %
// of the 3D path's pairs and 0.32 % of the 2D path's are gated.  What the
// design does about it:
//  * level 1 (pair_gate.cuh): a block stages its windows' coordinates in
//    shared memory in 16-byte loads, several in flight a thread; its warps
//    gate every pair (a lane a column, four rows in flight, a ballot a
//    row) and list each window's gated pairs in row-major order.  A block
//    takes one window where the tile has few (the 3D path's 121: one an
//    SM, its four warps on 8 rows each) and 4 or 8 where it has many (the
//    2D path's 4,761: 8, so that the blocks fit on the card at once).  On
//    the paths the gated pairs crowd the windows near the diagonal (a
//    frame's markers come in raster order), so a window's chain can be a
//    few hundred pairs long: a batch of listed pairs at a time, every
//    pair's terms (the normalised distance, each feature's absolute
//    difference, the features read from device memory for those pairs
//    only) are computed at once into shared memory, then the block's
//    (window, sum or sum of squares, feature) chains, spread over its
//    threads, add them in row-major order out of shared memory.  The gated
//    pairs are counted with integer atomics;
//  * the later levels run across the grid: a second launch takes one block
//    an (output window, sum) of the first later level and loads the
//    operand window to shared memory in 16-byte loads; a warp finds its
//    rows that hold a nonzero element and one lane adds their nonzero
//    elements, 16 bytes a load ahead of the adds.  The block that finishes
//    last (a counter, fenced) runs what is left (further levels, where a
//    tile is wider than 32,768 markers, and the final row-major sum of at
//    most 32 x 32, a thread a sum from shared memory).  Without a later
//    level the first launch's last block takes the final sum;
//  * the count, the sums and the sums of squares land in one buffer that
//    the wrapper copies to the host in one read.

#include "pair_gate.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using pair_gate::THREADS;
using pair_gate::Tile;
using pair_gate::W;

constexpr int LATER_THREADS = 64;
constexpr int MAX_CHAINS = 8;  // chains a thread of level 1 runs, at most
// terms that level 1 computes at once from a block's listed pairs (a batch
// of pairs at a time), so that their loads are in flight together and the
// serial chains after them read shared memory
constexpr int TERMS = 4096;
// features a call takes: a block's chains, 2 (F + 1) a window, fit
constexpr int MAX_FEATURES = MAX_CHAINS * THREADS / pair_gate::MAX_K / 2 - 1;

struct Job {
  Tile t;
  int rows, cols;    // the level-1 window grid: the padded tile over 32
  int ld1;           // row stride of a level-1 plane: win_cols rounded up to 4
  float* level1;     // 2 (F + 1) planes of win_rows x ld1
  bool later;        // a later window level follows level 1
  int lanes2;        // the first later level: 8 or 4 row lanes, or 0
  int vr2, vc2;      // its output windows that hold real sums
  int ld2;           // row stride of its planes: vc2 rounded up to 4
  float* level2;     // 2 (F + 1) planes of vr2 x ld2
  float* spare[2];   // as large as level2, for the levels after it
  unsigned long long* count;
  float* sums;       // F + 1
  float* sumsqs;     // F + 1
  unsigned* done;    // blocks finished: [0] level 1, [1] the later level
  int terms_at;      // where level 1's terms start in its dynamic shared memory
  int stage_floats;  // level 1's dynamic shared memory, in floats
};

__host__ __device__ __forceinline__ int lanes_of(int rows, int cols) {
  return rows > W ? (cols == 4 ? 8 : (cols == 8 ? 4 : 0)) : 0;
}

// A 32-row window vectorised across LANES row lanes, the lanes then added
// in halves; at(i, c) the window's element (row i < nr, column c < nc;
// everything else is +0).
template <int LANES, class At>
__device__ __forceinline__ float lanes_sum(At at, int nr, int nc) {
  float lane[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) lane[l] = 0.f;
  for (int step = 0; step < W / LANES; ++step)
    for (int c = 0; c < nc; ++c)
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        const int i = step * LANES + l;
        if (i < nr) {
          const float v = at(i, c);
          if (v != 0.f) lane[l] = __fadd_rn(lane[l], v);
        }
      }
#pragma unroll
  for (int half = LANES / 2; half >= 1; half /= 2)
#pragma unroll
    for (int l = 0; l < half; ++l) lane[l] = __fadd_rn(lane[l], lane[l + half]);
  return lane[0];
}

// The row-major chain over rows of a window in shared memory: x[i * ld +
// j] for i < nr, j < nc (nc at most 32, ld a multiple of 4), from +0, its
// nonzero elements added.  Rows with no nonzero element (bit i of `rows`
// clear) are skipped; the others are read 16 bytes a load ahead of the
// adds.
__device__ __forceinline__ float rows_sum(const float* x, int ld, int nc, unsigned rows) {
  float acc = 0.f;
  while (rows) {
    const int i = __ffs(rows) - 1;
    rows &= rows - 1;
    const float4* r = reinterpret_cast<const float4*>(x + i * ld);
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (4 * k < nc) v[k] = r[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (4 * k + m < nc && e[m] != 0.f) acc = __fadd_rn(acc, e[m]);
    }
  }
  return acc;
}

// Bit i: row i (< nr) of the window x (row stride ld, nc columns) holds a
// nonzero element; computed by one warp, a lane a row.
__device__ __forceinline__ unsigned nonzero_rows(const float* x, int ld, int nr, int nc) {
  const int lane = threadIdx.x % W;
  bool any = false;
  if (lane < nr)
    for (int j = 0; j < nc; ++j) any |= x[lane * ld + j] != 0.f;
  return __ballot_sync(pair_gate::FULL, any);
}

// Stage floats [0, n) of src (16-byte aligned) into dst, BATCH 16-byte
// loads in flight a thread.
__device__ __forceinline__ void stage_flat(float* dst, const float* src, long long n) {
  constexpr int BATCH = 8;
  const long long vec = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (long long k0 = threadIdx.x; k0 < vec; k0 += BATCH * blockDim.x) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      if (k0 + b * blockDim.x < vec) v[b] = __ldcg(s4 + k0 + b * blockDim.x);
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      if (k0 + b * blockDim.x < vec) d4[k0 + b * blockDim.x] = v[b];
  }
  for (long long k = vec * 4 + threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldcg(src + k);
}

// One output window of a level after the first later one, by one thread
// from device memory (tiles wider than 32,768 markers): nr x nc elements
// that may be nonzero, in the reference's order, the nonzero ones added.
template <class At>
__device__ __forceinline__ float window_sum(At at, int nr, int nc, int lanes) {
  if (lanes == 8) return lanes_sum<8>(at, nr, nc);
  if (lanes == 4) return lanes_sum<4>(at, nr, nc);
  float acc = 0.f;
  for (int i = 0; i < nr; ++i)
    for (int j = 0; j < nc; ++j) {
      const float v = at(i, j);
      if (v != 0.f) acc = __fadd_rn(acc, v);
    }
  return acc;
}

// The final row-major sum of each plane's vr x vc elements (at most 32 x
// 32; row stride ld, a multiple of 4, planes back to back), by the one
// block that runs it: groups of planes staged through `stage`
// (stage_floats floats, at least vr * ld), then a thread a plane, its
// nonzero elements added.
__device__ void final_sums(const Job& job, const float* src, int vr, int vc, int ld,
                           float* stage, int stage_floats) {
  const int S = job.t.n_feat + 1, Q = 2 * S, plane = vr * ld;
  const int group = min(Q, stage_floats / plane);
  for (int q0 = 0; q0 < Q; q0 += group) {
    const int g = min(group, Q - q0);
    stage_flat(stage, src + (long long)q0 * plane, (long long)g * plane);
    __syncthreads();
    for (int qq = threadIdx.x; qq < g; qq += blockDim.x) {
      const float acc = rows_sum(stage + qq * plane, ld, vc, vr == W ? pair_gate::FULL
                                                                     : (1u << vr) - 1);
      const int q = q0 + qq;
      if (q < S)
        job.sums[q] = acc;
      else
        job.sumsqs[q - S] = acc;
    }
    __syncthreads();
  }
}

// Whether this block is the last of the launch to finish (after a fence
// that makes its writes visible to that block).
__device__ __forceinline__ bool last_block(unsigned* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <int D>
__global__ void __launch_bounds__(THREADS) level1_kernel(Job job) {
  extern __shared__ float4 smem4[];
  __shared__ pair_gate::Pairs pairs;
  __shared__ int block_count;
  const Tile& t = job.t;
  const int F = t.n_feat, S = F + 1, Q = 2 * S;
  float* smem = reinterpret_cast<float*>(smem4);
  const pair_gate::Staged st = pair_gate::carve(smem, D);
  const pair_gate::Block b = pair_gate::block_of(t);
  const int total = pair_gate::gate_block<D>(t, b, st, pairs, &block_count);
  // the block's chains, MAX_CHAINS a thread at most: (window, sum or sum
  // of squares, feature), each over its window's gated pairs in row-major
  // order, from +0.  A batch of pairs at a time, their S terms (the
  // normalised distance, then each feature's absolute difference) are
  // computed first, every term at once, into shared memory.
  float* terms = smem + job.terms_at;
  const int batch = TERMS / S, chains = b.windows * Q;
  float acc[MAX_CHAINS];
#pragma unroll
  for (int k = 0; k < MAX_CHAINS; ++k) acc[k] = 0.f;
  for (int e0 = 0; e0 < total; e0 += batch) {
    const int n = min(batch, total - e0);
#pragma unroll 4
    for (int x = threadIdx.x; x < n * S; x += THREADS) {
      const int ij = pairs.list[e0 + x / S], f = x % S;
      const int i = pair_gate::pair_row(ij);
      const int c = pair_gate::pair_window(ij) * W + pair_gate::pair_col(ij);
      terms[x] = f ? fabsf(__fsub_rn(__ldg(t.fpost + (long long)(b.r0 + i) * F + f - 1),
                                     __ldg(t.fpre + (long long)(b.c0 + c) * F + f - 1)))
                   : pair_gate::pair_dn(pair_gate::pair_dist<D>(st.row_c + i * D,
                                                                st.col_c + c * D),
                                        t.max_d);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_CHAINS; ++k) {
      const int c = threadIdx.x + k * THREADS;
      if (c < chains) {
        const int w = c / Q, q = c % Q;
        const float* x = terms + q % S;
        const int lo = max(e0, pairs.first[w]) - e0, hi = min(e0 + n, pairs.first[w + 1]) - e0;
        float a = acc[k];
        if (q < S) {
#pragma unroll 4
          for (int e = lo; e < hi; ++e) a = __fadd_rn(a, x[e * S]);
        } else {
#pragma unroll 4
          for (int e = lo; e < hi; ++e) a = __fadd_rn(a, __fmul_rn(x[e * S], x[e * S]));
        }
        acc[k] = a;
      }
    }
    __syncthreads();
  }
  const long long plane = (long long)t.win_rows * job.ld1;
#pragma unroll
  for (int k = 0; k < MAX_CHAINS; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < chains)
      job.level1[(c % Q) * plane + (long long)b.wr * job.ld1 + b.wc0 + c / Q] = acc[k];
  }
  if (threadIdx.x == 0) atomicAdd(job.count, (unsigned long long)block_count);
  if (job.later || !last_block(job.done)) return;
  final_sums(job, job.level1, t.win_rows, t.win_cols, job.ld1, smem, job.stage_floats);
}

// The first later level: a block an (output window, plane).  Its last
// block runs the rest.
__global__ void __launch_bounds__(LATER_THREADS) later_kernel(Job job) {
  __shared__ float4 win4[W * W / 4];
  float* win = reinterpret_cast<float*>(win4);
  const int vr = job.t.win_rows, vc = job.t.win_cols, ld = job.ld1;
  const int n_out = job.vr2 * job.vc2, lanes = job.lanes2;
  const int q = blockIdx.x / n_out, o = blockIdx.x % n_out;
  const int orow = o / job.vc2, ocol = o % job.vc2;
  const int wcols = lanes ? job.cols : W;  // 4, 8 or 32 columns
  const int r0 = orow * W, c0 = lanes ? 0 : ocol * W;
  const int nr = min(W, vr - r0), nc = min(wcols, vc - c0);
  const float* x = job.level1 + (long long)q * vr * ld;
  // the operand window, 16 bytes a load (ld is a multiple of 4); columns
  // from win_cols to ld were never written
  const int per_row = wcols / 4;
  for (int k = threadIdx.x; k < W * per_row; k += blockDim.x) {
    const int i = k / per_row, c = 4 * (k % per_row);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nr && c < nc) {
      v = __ldcg(reinterpret_cast<const float4*>(x + (long long)(r0 + i) * ld + c0 + c));
      if (c + 1 >= nc) v.y = 0.f;
      if (c + 2 >= nc) v.z = 0.f;
      if (c + 3 >= nc) v.w = 0.f;
    }
    win4[k] = v;
  }
  __syncthreads();
  float* out = job.level2 + (long long)q * job.vr2 * job.ld2 + orow * job.ld2 + ocol;
  if (lanes) {
    if (threadIdx.x == 0)
      *out = window_sum([&](int i, int j) { return win[i * wcols + j]; }, nr, nc, lanes);
  } else if (threadIdx.x < W) {
    const unsigned rows = nonzero_rows(win, W, nr, nc);
    if (threadIdx.x == 0) *out = rows_sum(win, W, nc, rows);
  }
  if (!last_block(job.done + 1)) return;
  // the levels after it, one thread an (output window, plane), then the
  // final sum
  const int S = job.t.n_feat + 1, Q = 2 * S;
  int rows = (job.rows + W - 1) / W, cols = lanes ? 1 : (job.cols + W - 1) / W;
  int svr = job.vr2, svc = job.vc2, sld = job.ld2, which = 0;
  const float* src = job.level2;
  while (rows > W || cols > W) {
    const int l = lanes_of(rows, cols);
    const int ovr = (svr + W - 1) / W, ovc = l ? 1 : (svc + W - 1) / W, old = (ovc + 3) / 4 * 4;
    float* dst = job.spare[which];
    for (int task = threadIdx.x; task < Q * ovr * ovc; task += blockDim.x) {
      const int qq = task / (ovr * ovc), oo = task % (ovr * ovc);
      const int rr = (oo / ovc) * W, cc = l ? 0 : (oo % ovc) * W;
      const float* xs = src + (long long)qq * svr * sld;
      dst[(long long)qq * ovr * old + (oo / ovc) * old + oo % ovc] = window_sum(
          [&](int i, int j) { return __ldcg(xs + (long long)(rr + i) * sld + cc + j); },
          min(W, svr - rr), min(l ? cols : W, svc - cc), l);
    }
    __threadfence_block();
    __syncthreads();
    src = dst;
    which ^= 1;
    rows = (rows + W - 1) / W;
    cols = l ? 1 : (cols + W - 1) / W;
    svr = ovr;
    svc = ovc;
    sld = old;
  }
  final_sums(job, src, svr, svc, sld, win, W * W);
}

}  // namespace

extern "C" {

// Features a call takes, at most.
int pair_sums_max_features() { return MAX_FEATURES; }

// Float32 scratch of a call: the level-1 window sums of the real windows
// and, where later levels follow, three buffers of the first later
// level's real output windows.
long long pair_sums_scratch(int n_feat, int rows, int cols, int n_post, int n_pre) {
  const long long q = 2LL * (n_feat + 1);
  const int vr = (n_post + W - 1) / W, vc = (n_pre + W - 1) / W;
  long long n = q * vr * ((vc + 3) / 4 * 4);
  if (rows > W || cols > W) {
    const int vc2 = lanes_of(rows, cols) ? 1 : (vc + W - 1) / W;
    n += 3 * q * ((vr + W - 1) / W) * ((vc2 + 3) / 4 * 4);
  }
  return n;
}

// Int32 words of the packed result: the count (uint64), the sums, the sums
// of squares (n_feat + 1 float32 each), then two block counters; a multiple
// of 4, so that scratch placed after it starts on 16 bytes.
long long pair_sums_packed_words(int n_feat) { return (2 + 2LL * (n_feat + 1) + 2 + 3) / 4 * 4; }

// Gated pair sums over C-contiguous float32 device arrays: coords (n, ndim),
// feats (n, n_feat); rows x cols the padded tile over 32 (each at least the
// real pairs' windows); scratch pair_sums_scratch floats; packed
// pair_sums_packed_words int32 words, cleared here by a memset and filled
// with the count and the sums.  kernels (host): the CUDA kernels launched
// (the memset aside).
int pair_sums(const void* cpost, const void* cpre, const void* fpost, const void* fpre,
              int n_post, int n_pre, int ndim, int n_feat, float max_distance, int rows,
              int cols, void* scratch, void* packed, int* kernels, void* stream) {
  *kernels = 0;
  if (ndim < 1 || ndim > 3 || n_feat < 0 || n_feat > MAX_FEATURES || n_post < 0 || n_pre < 0)
    return (int)cudaErrorInvalidValue;
  const int win_rows = (n_post + W - 1) / W, win_cols = (n_pre + W - 1) / W;
  if (rows < win_rows || cols < win_cols || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  const int S = n_feat + 1;
  Job job;
  job.t.cpost = (const float*)cpost;
  job.t.cpre = (const float*)cpre;
  job.t.fpost = (const float*)fpost;
  job.t.fpre = (const float*)fpre;
  job.t.n_post = n_post;
  job.t.n_pre = n_pre;
  job.t.n_feat = n_feat;
  job.t.max_d = max_distance;
  job.t.win_rows = win_rows;
  job.t.win_cols = win_cols;
  job.t.k = pair_gate::windows_a_block((long long)win_rows * win_cols);
  job.t.groups = (win_cols + job.t.k - 1) / job.t.k;
  job.t.aligned = (((uintptr_t)cpost | (uintptr_t)cpre) & 15) == 0;
  job.rows = rows;
  job.cols = cols;
  job.ld1 = (win_cols + 3) / 4 * 4;
  job.level1 = (float*)scratch;
  job.later = rows > W || cols > W;
  job.lanes2 = lanes_of(rows, cols);
  job.vr2 = (win_rows + W - 1) / W;
  job.vc2 = job.lanes2 ? 1 : (win_cols + W - 1) / W;
  job.ld2 = (job.vc2 + 3) / 4 * 4;
  const long long level2 = 2LL * S * job.vr2 * job.ld2;
  job.level2 = job.level1 + 2LL * S * win_rows * job.ld1;
  job.spare[0] = job.level2 + level2;
  job.spare[1] = job.spare[0] + level2;
  int* words = (int*)packed;
  job.count = (unsigned long long*)words;
  job.sums = (float*)(words + 2);
  job.sumsqs = job.sums + S;
  job.done = (unsigned*)(words + 2 + 2 * S);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(packed, 0, 4 * pair_sums_packed_words(n_feat), st);
  if (err != cudaSuccess) return (int)err;
  if (win_rows == 0 || win_cols == 0) return 0;  // no pair: the count and sums are +0
  // the staged coordinates and the terms, or the final sum's staging when
  // that is larger: a plane of level-1 sums at least, every plane where
  // 48 KB hold them
  const int plane1 = win_rows * job.ld1;
  job.terms_at = pair_gate::staged_floats(ndim, job.t.k);
  job.stage_floats = max(job.terms_at + TERMS,
                         job.later ? 0 : max(plane1, min(2 * S * plane1, 12 * 1024)));
  const size_t smem = sizeof(float) * job.stage_floats;
  void (*level1)(Job) = ndim == 1 ? level1_kernel<1>
                                  : (ndim == 2 ? level1_kernel<2> : level1_kernel<3>);
  if ((err = pair_gate::allow_shared(level1, smem)) != cudaSuccess) return (int)err;
  level1<<<win_rows * job.t.groups, THREADS, smem, st>>>(job);
  *kernels = 1;
  if ((err = cudaGetLastError()) != cudaSuccess || !job.later) return (int)err;
  later_kernel<<<2 * S * job.vr2 * job.vc2, LATER_THREADS, 0, st>>>(job);
  *kernels = 2;
  return (int)cudaGetLastError();
}

}  // extern "C"
