// The tracker's distance gate, the staging of a block's markers and the
// list of a block's gated pairs, shared by pair_sums.cu and pair_costs.cu
// (the matcher's two kernels, which run over the same tiles of (later,
// earlier) marker pairs with the same gate).
//
// A window is 32 later markers (rows) by 32 earlier ones (columns), the
// first level of XLA's CPU tree reduction over the pair tile.  A block of
// WARPS warps takes K windows side by side in one window row (K = 1, 4 or
// 8, chosen at launch: 1 where the tile has few windows, so that they
// spread over the SMs; more where it has many, so that the blocks fit on
// the card at once); the WARPS / K warps of a window share its 32 rows, or
// a warp takes K / WARPS windows.  The gate of pair (i, j), exactly as the plain
// body rounds it (kernels/matching.py::_pair_mask_and_dist; the kernels are
// built with -fmad=false, every contraction explicit):
//   d_a = post[i][a] - pre[j][a],  s = d_0 * d_0, then s = fma(d_a, d_a, s)
//   for a = 1, 2 (XLA's reduction loop), dist = sqrt(s) correctly rounded,
//   gated: dist < max_distance (strict), i and j both real markers.
// A kernel that needs a gated pair's distance again recomputes it with
// pair_dist, which gives the same bits; the normalised distance
// dist / max_distance is taken for gated pairs only (pair_dn).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair_gate {

constexpr int W = 32;      // XLA's CPU tree-reduction window, and a warp
constexpr int WARPS = 4;   // warps of a block
constexpr int THREADS = W * WARPS;
constexpr int MAX_K = 8;   // windows of a block, at most
constexpr int BATCH = 4;   // 16-byte loads a thread keeps in flight while staging
constexpr unsigned FULL = 0xffffffffu;

struct Tile {
  const float* cpost;  // (n_post, ndim)
  const float* cpre;   // (n_pre, ndim)
  const float* fpost;  // (n_post, n_feat)
  const float* fpre;   // (n_pre, n_feat)
  int n_post, n_pre, n_feat;
  float max_d;
  int win_rows, win_cols;  // windows that hold real pairs
  int k;                   // windows of a block: 1, 4 or 8
  int groups;              // blocks along a window row: ceil(win_cols / k)
  bool aligned;            // the coordinates start on 16 bytes
};

// Windows of a block for a tile of `windows` windows: 1 while one window a
// block leaves no more than about two blocks an SM of the card's 132, then
// 4 while the blocks fit at eight an SM, else 8.
__host__ __forceinline__ int windows_a_block(long long windows) {
  return windows <= 2 * 132 ? 1 : (windows <= 4 * 8 * 132 ? 4 : MAX_K);
}

// The gated pairs of a block, window by window, each window's in row-major
// order: window w's are list[first[w] .. first[w + 1]), entry
// (w << 10) | (i << 5) | j for row i, column j.
struct Pairs {
  uint16_t list[MAX_K * W * W];
  int first[MAX_K + 1];
  unsigned row_bits[MAX_K][W];  // bit j of row i: pair (i, j) of window w gated
};


__device__ __forceinline__ int pair_window(uint16_t e) { return e >> 10; }
__device__ __forceinline__ int pair_row(uint16_t e) { return (e >> 5) & (W - 1); }
__device__ __forceinline__ int pair_col(uint16_t e) { return e & (W - 1); }

// A block's markers' coordinates in shared memory: its window row's 32
// later markers and its k x 32 earlier ones, zero past the real markers;
// both arrays start on 16 bytes.  (Features are read from device memory
// for the gated pairs only: 1.0 % of the 3D path's pairs, 0.32 % of the 2D
// path's.)
struct Staged {
  float* row_c;  // W x D
  float* col_c;  // k W x D
};

__host__ __device__ __forceinline__ int staged_floats(int ndim, int k) {
  return W * (k + 1) * ndim;
}

__device__ __forceinline__ Staged carve(float* smem, int ndim) {
  Staged s;
  s.row_c = smem;
  s.col_c = s.row_c + W * ndim;
  return s;
}

// Stage the block's coordinates: arrays of count markers' width floats
// from src[first * width ...] to dst and zeros up to rows markers, in one
// pass with BATCH 16-byte loads in flight a thread where the arrays start
// on 16 bytes (first is a multiple of 32, so every piece does then).
struct Piece {
  float* dst;
  const float* src;
  int n, total;  // floats copied, floats of dst
};

template <int N>
__device__ __forceinline__ void stage_pieces(const Piece (&pc)[N], bool aligned) {
  int vec[N], end[N], acc = 0;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    vec[p] = aligned ? pc[p].n / 4 : 0;
    end[p] = acc += vec[p];
  }
  for (int k0 = threadIdx.x; k0 < acc; k0 += BATCH * blockDim.x) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int k = k0 + b * blockDim.x;
      if (k < acc) {
        int p = 0;
#pragma unroll
        for (int m = 0; m + 1 < N; ++m) p += k >= end[m];
        v[b] = __ldg(reinterpret_cast<const float4*>(pc[p].src) + k - (end[p] - vec[p]));
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int k = k0 + b * blockDim.x;
      if (k < acc) {
        int p = 0;
#pragma unroll
        for (int m = 0; m + 1 < N; ++m) p += k >= end[m];
        reinterpret_cast<float4*>(pc[p].dst)[k - (end[p] - vec[p])] = v[b];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < N; ++p) {
    for (int k = 4 * vec[p] + threadIdx.x; k < pc[p].n; k += blockDim.x)
      pc[p].dst[k] = __ldg(pc[p].src + k);
    for (int k = pc[p].n + threadIdx.x; k < pc[p].total; k += blockDim.x) pc[p].dst[k] = 0.f;
  }
}

// The distance of pair (p, q) as the plain body rounds it.
template <int D>
__device__ __forceinline__ float pair_dist(const float* p, const float* q) {
  const float d0 = __fsub_rn(p[0], q[0]);
  float s = __fmul_rn(d0, d0);
#pragma unroll
  for (int a = 1; a < D; ++a) {
    const float da = __fsub_rn(p[a], q[a]);
    s = __fmaf_rn(da, da, s);
  }
  return __fsqrt_rn(s);
}

__device__ __forceinline__ float pair_dn(float dist, float max_d) { return __fdiv_rn(dist, max_d); }

// A block's windows: the window row wr, its first window column wc0, and
// the r0, c0 of its markers.
struct Block {
  int wr, wc0, r0, c0, windows;
};

__device__ __forceinline__ Block block_of(const Tile& t) {
  Block b;
  b.wr = blockIdx.x / t.groups;
  b.wc0 = (blockIdx.x % t.groups) * t.k;
  b.r0 = b.wr * W;
  b.c0 = b.wc0 * W;
  b.windows = min(t.k, t.win_cols - b.wc0);
  return b;
}

// Stage the block's coordinates, gate its pairs and list the gated ones
// (block barriers included).  The warps of a window each take 32 /
// (WARPS / k) of its rows, a lane a column, a ballot a row.  Returns the
// block's gated pairs, which *count (shared, unless null) also gets.
template <int D>
__device__ __forceinline__ int gate_block(const Tile& t, const Block& b, const Staged& s,
                                          Pairs& pairs, int* count) {
  const int rows = min(W, t.n_post - b.r0), cols = min(t.k * W, t.n_pre - b.c0);
  const Piece pieces[2] = {{s.row_c, t.cpost + (long long)b.r0 * D, rows * D, W * D},
                           {s.col_c, t.cpre + (long long)b.c0 * D, cols * D, t.k * W * D}};
  stage_pieces(pieces, t.aligned);
  __syncthreads();
  const int warp = threadIdx.x / W, lane = threadIdx.x % W;
  // warp w's share: windows w0, w0 + step, ... and rows [i0, i0 + span)
  const int per = max(WARPS / t.k, 1), span = W / per, i0 = (warp % per) * span;
  const int step = WARPS / per;
  for (int w = warp / per; w < b.windows; w += step) {
    float q[D];
#pragma unroll
    for (int a = 0; a < D; ++a) q[a] = s.col_c[(w * W + lane) * D + a];
    const bool col_real = b.c0 + w * W + lane < t.n_pre;
    for (int i = i0; i < i0 + span; i += 4) {  // four rows' gates in flight
      bool g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)  // rows past the real ones are staged as zeros
        g[u] = (pair_dist<D>(s.row_c + (i + u) * D, q) < t.max_d) & col_real & (i + u < rows);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned bits = __ballot_sync(FULL, g[u]);
        if (lane == u) pairs.row_bits[w][i + u] = bits;
      }
    }
  }
  __syncthreads();
  // the list: each window's pairs counted, the windows' offsets, then a
  // warp a window, a lane a row, its entries at an offset from a scan of
  // the rows' counts
  for (int ww = warp; ww < b.windows; ww += WARPS) {
    const int n = __reduce_add_sync(FULL, __popc(pairs.row_bits[ww][lane]));
    if (lane == 0) pairs.first[ww + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    pairs.first[0] = 0;
    for (int ww = 0; ww < MAX_K; ++ww)
      pairs.first[ww + 1] = pairs.first[ww] + (ww < b.windows ? pairs.first[ww + 1] : 0);
    if (count) *count = pairs.first[MAX_K];
  }
  __syncthreads();
  for (int ww = warp; ww < b.windows; ww += WARPS) {
    const unsigned bits = pairs.row_bits[ww][lane];
    const int n = __popc(bits);
    int end = n;
#pragma unroll
    for (int d = 1; d < W; d *= 2) {
      const int up = __shfl_up_sync(FULL, end, d);
      if (lane >= d) end += up;
    }
    unsigned rest = bits;
    for (int e = pairs.first[ww] + end - n; rest; ++e) {
      const int j = __ffs(rest) - 1;
      rest &= rest - 1;
      pairs.list[e] = (uint16_t)((ww << 10) | (lane << 5) | j);
    }
  }
  __syncthreads();
  return pairs.first[MAX_K];
}

// Let `kernel` take `dynamic` bytes of dynamic shared memory: past the
// default 48 KB (its static shared memory included) a launch must opt in.
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t dynamic) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess || attr.sharedSizeBytes + dynamic <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
}

}  // namespace pair_gate
