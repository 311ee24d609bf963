// The tracker's distance-gated pair sums, for Hopper (sm_90a): one launch a
// call.
//
// Replaces nellie_tpu/kernels/matching.py::pair_stats (matching.py:40-60),
// jnp sums over the (N_post, N_pre) pairs of a padded tile, and the port's
// plain body (kernels/matching.py::pair_stats_plain): a Python loop over the
// 32 x 32 elements of XLA's first reduction window, then the later levels
// one launch an add (about 12,300 CUDA kernels a call on the main paths).
//
// What it computes, exactly as the plain body does (built with -fmad=false,
// every contraction an explicit __fmaf_rn, every division and root IEEE).
// For pair (i, j): the coordinate differences d_a = post[i][a] - pre[j][a],
// their squares summed as XLA's reduction loop rounds them,
//   s = d_0 * d_0, then s = fma(d_a, d_a, s) for a = 1, 2,
// dist = sqrt(s) correctly rounded, the gate dist < max_distance (strict,
// and both indices inside the real rows and columns), and the normalised
// distance dist / max_distance.  Feature 0 is that distance and feature
// f = 1..F is |feats_post[i][f-1] - feats_pre[j][f-1]|; a gated pair adds d
// to the feature's sum and d * d (rounded on its own) to its sum of squares,
// any other pair adds +0.
//
// Each sum is XLA's CPU tree reduction of the padded tile (kernels/_fp.py::
// tree_sum_2d), kept in its order:
//  * level 1: every 32 x 32 window of pairs summed one pair at a time in
//    row-major order, from its element (0, 0).  The window grid is the
//    reference's padded tile over 32 (rows x cols); windows past the real
//    pairs are zero windows;
//  * while either axis of the window sums is longer than 32: windows of
//    32 x 32 summed in row-major order (zero padded at the ends), except
//    where the last axis is 4 or 8 long and there are more than 32 rows:
//    there LLVM vectorises the 32-row window across 8 or 4 row lanes (lane
//    l sums the rows l, l + lanes, ... of the window, each row's columns in
//    order; lane 0 starts at +0, the others at -0) and adds the lanes in
//    halves (_fp._window_sums_2d, _WINDOW_LANES);
//  * at most 32 x 32 left: added one at a time in row-major order.
// A sum that starts from its first element equals one that starts from -0
// (the additive identity of round-to-nearest), which the loops use.
//
// What bounds it: the latency of its dependent adds, not bytes (the inputs
// are a few hundred kilobytes).  Each sum is a chain of 1,024 adds at level
// 1 and up to 1,024 more at each later level.  What the design does about
// it: level 1 runs every window at once, a block a window: the block loads
// its 32 rows and 32 columns to shared memory, gates its 1,024 pairs with
// every thread, then one thread a feature runs the feature's two chains
// (sum and squares, side by side) over shared memory.  The gated pairs are
// counted with atomics, which are exact.  The block that finishes last
// (a counter that grows, with a fence before it) runs the later levels,
// one thread an output window a level, with a block barrier between
// levels.  One launch a call; the C entry point clears the counters with a
// memset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 32;  // XLA's CPU tree-reduction window
constexpr int THREADS = 128;
constexpr int MAX_DIMS = 3;

struct Job {
  const float* cpost;  // (n_post, ndim)
  const float* cpre;   // (n_pre, ndim)
  const float* fpost;  // (n_post, n_feat)
  const float* fpre;   // (n_pre, n_feat)
  int n_post, n_pre, ndim, n_feat;
  float max_d;
  int rows, cols;          // the level-1 window grid: the padded tile over 32
  int win_rows, win_cols;  // the windows that hold real pairs
  float* level[2];         // 2 (n_feat + 1) rows cols floats each
  unsigned long long* counters;  // [0] gated pairs, [1] blocks done
  float* sums;                   // n_feat + 1
  float* sumsqs;                 // n_feat + 1
};

// element (r, c) of one (rows, cols) plane of window sums, +0 outside the
// valid (vr, vc) part (the zero windows and the padding to 32)
__device__ __forceinline__ float at(const float* x, int r, int c, int cols, int vr, int vc) {
  return (r < vr && c < vc) ? __ldcg(x + (long long)r * cols + c) : 0.f;
}

// the levels after the first and the final row-major sum, in one block
__device__ void later_levels(const Job& job) {
  const int planes = 2 * (job.n_feat + 1);
  int rows = job.rows, cols = job.cols, vr = job.win_rows, vc = job.win_cols;
  const float* src = job.level[0];
  float* dst = job.level[1];
  while (rows > W || cols > W) {
    const int lanes = rows > W ? (cols == 4 ? 8 : (cols == 8 ? 4 : 0)) : 0;
    const int out_r = (rows + W - 1) / W;
    const int out_c = lanes ? 1 : (cols + W - 1) / W;
    const long long in_plane = (long long)rows * cols, out_plane = (long long)out_r * out_c;
    for (long long task = threadIdx.x; task < planes * out_plane; task += blockDim.x) {
      const int q = (int)(task / out_plane);
      const long long o = task % out_plane;
      const int orow = (int)(o / out_c), ocol = (int)(o % out_c);
      const float* x = src + q * in_plane;
      float acc;
      if (lanes) {
        float lane[8];
        lane[0] = 0.f;
        for (int l = 1; l < 8; ++l) lane[l] = -0.f;
        for (int step = 0; step < W / lanes; ++step)
          for (int c = 0; c < cols; ++c)
            for (int l = 0; l < lanes; ++l)
              lane[l] = __fadd_rn(lane[l], at(x, orow * W + step * lanes + l, c, cols, vr, vc));
        for (int half = lanes / 2; half >= 1; half /= 2)
          for (int l = 0; l < half; ++l) lane[l] = __fadd_rn(lane[l], lane[l + half]);
        acc = lane[0];
      } else {
        acc = -0.f;
        for (int i = 0; i < W; ++i) {
#pragma unroll 8
          for (int j = 0; j < W; ++j)
            acc = __fadd_rn(acc, at(x, orow * W + i, ocol * W + j, cols, vr, vc));
        }
      }
      dst[q * out_plane + o] = acc;
    }
    __syncthreads();
    const float* done = dst;
    dst = (float*)src;
    src = done;
    rows = vr = out_r;
    cols = vc = out_c;
  }
  const int n_sums = job.n_feat + 1;
  for (int q = threadIdx.x; q < planes; q += blockDim.x) {
    const float* x = src + (long long)q * rows * cols;
    float acc = -0.f;
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < cols; ++c) acc = __fadd_rn(acc, at(x, r, c, cols, vr, vc));
    if (q < n_sums)
      job.sums[q] = acc;
    else
      job.sumsqs[q - n_sums] = acc;
  }
}

__global__ void __launch_bounds__(THREADS) pair_sums_kernel(Job job) {
  extern __shared__ float smem[];
  __shared__ int block_count;
  __shared__ bool last;
  const int D = job.ndim, F = job.n_feat, S = F + 1;
  float* row_c = smem;             // W x D
  float* col_c = row_c + W * D;    // W x D
  float* row_f = col_c + W * D;    // W x F
  float* col_f = row_f + W * F;    // W x F
  float* dn = col_f + W * F;       // W x W normalised distances
  unsigned char* gate = (unsigned char*)(dn + W * W);  // W x W
  const int t = threadIdx.x;
  if (blockIdx.x < job.win_rows * job.win_cols) {
    const int wr = blockIdx.x / job.win_cols, wc = blockIdx.x % job.win_cols;
    const int r0 = wr * W, c0 = wc * W;
    if (t == 0) block_count = 0;
    for (int k = t; k < W * D; k += THREADS) {
      const int i = k / D;
      row_c[k] = r0 + i < job.n_post ? job.cpost[(long long)r0 * D + k] : 0.f;
      col_c[k] = c0 + i < job.n_pre ? job.cpre[(long long)c0 * D + k] : 0.f;
    }
    for (int k = t; k < W * F; k += THREADS) {
      const int i = k / F;
      row_f[k] = r0 + i < job.n_post ? job.fpost[(long long)r0 * F + k] : 0.f;
      col_f[k] = c0 + i < job.n_pre ? job.fpre[(long long)c0 * F + k] : 0.f;
    }
    __syncthreads();
    int mine = 0;
    for (int e = t; e < W * W; e += THREADS) {
      const int i = e / W, j = e % W;
      const float d0 = __fsub_rn(row_c[i * D], col_c[j * D]);
      float s = __fmul_rn(d0, d0);
      for (int a = 1; a < D; ++a) {
        const float da = __fsub_rn(row_c[i * D + a], col_c[j * D + a]);
        s = __fmaf_rn(da, da, s);
      }
      const float dist = __fsqrt_rn(s);
      const bool m = dist < job.max_d && r0 + i < job.n_post && c0 + j < job.n_pre;
      dn[e] = __fdiv_rn(dist, job.max_d);
      gate[e] = m;
      mine += m;
    }
    atomicAdd(&block_count, mine);
    __syncthreads();
    const long long plane = (long long)job.rows * job.cols;
    const long long cell = (long long)wr * job.cols + wc;
    for (int f = t; f < S; f += THREADS) {
      float acc = -0.f, acc2 = -0.f;
      for (int i = 0; i < W; ++i) {
        const float a = f ? row_f[i * F + f - 1] : 0.f;
#pragma unroll 8
        for (int j = 0; j < W; ++j) {
          const int e = i * W + j;
          const float d = f ? fabsf(__fsub_rn(a, col_f[j * F + f - 1])) : dn[e];
          const bool m = gate[e];
          acc = __fadd_rn(acc, m ? d : 0.f);
          acc2 = __fadd_rn(acc2, m ? __fmul_rn(d, d) : 0.f);
        }
      }
      job.level[0][f * plane + cell] = acc;
      job.level[0][(S + f) * plane + cell] = acc2;
    }
    if (t == 0) atomicAdd(job.counters, (unsigned long long)block_count);
  }
  // the block that finishes last runs the later levels
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(job.counters + 1, 1ULL) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  later_levels(job);
}

}  // namespace

extern "C" {

// Float32 scratch the call needs: two buffers of 2 (n_feat + 1) window sums
// a cell of the (rows, cols) grid.
long long pair_sums_scratch(int n_feat, int rows, int cols) {
  return 4LL * (n_feat + 1) * rows * cols;
}

// Gated pair sums over C-contiguous float32 device arrays: coords (n, ndim),
// feats (n, n_feat); rows x cols the padded tile over 32 (each at least the
// real pairs' windows); scratch pair_sums_scratch floats; counters two
// uint64 (out: [0] the gated pairs); sums and sumsqs n_feat + 1 float32
// each.  kernels (host): the CUDA kernels launched (the memset aside).
int pair_sums(const void* cpost, const void* cpre, const void* fpost, const void* fpre,
              int n_post, int n_pre, int ndim, int n_feat, float max_distance, int rows,
              int cols, void* scratch, void* counters, void* sums, void* sumsqs,
              int* kernels, void* stream) {
  *kernels = 0;
  if (ndim < 1 || ndim > MAX_DIMS || n_feat < 0 || n_post < 0 || n_pre < 0)
    return (int)cudaErrorInvalidValue;
  const int win_rows = (n_post + W - 1) / W, win_cols = (n_pre + W - 1) / W;
  if (rows < win_rows || cols < win_cols || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  Job job;
  job.cpost = (const float*)cpost;
  job.cpre = (const float*)cpre;
  job.fpost = (const float*)fpost;
  job.fpre = (const float*)fpre;
  job.n_post = n_post;
  job.n_pre = n_pre;
  job.ndim = ndim;
  job.n_feat = n_feat;
  job.max_d = max_distance;
  job.rows = rows;
  job.cols = cols;
  job.win_rows = win_rows;
  job.win_cols = win_cols;
  const long long half = 2LL * (n_feat + 1) * rows * cols;
  job.level[0] = (float*)scratch;
  job.level[1] = (float*)scratch + half;
  job.counters = (unsigned long long*)counters;
  job.sums = (float*)sums;
  job.sumsqs = (float*)sumsqs;
  const size_t smem = sizeof(float) * (2 * W * ndim + 2 * W * n_feat + W * W) + W * W;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(pair_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), st)) != cudaSuccess)
    return (int)err;
  const int grid = win_rows * win_cols > 0 ? win_rows * win_cols : 1;
  pair_sums_kernel<<<grid, THREADS, smem, st>>>(job);
  *kernels = 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
