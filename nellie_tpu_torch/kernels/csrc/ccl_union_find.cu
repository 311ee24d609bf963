// Connected-component roots by a block-based union-find, for Hopper (sm_90a).
//
// Replaces nellie_tpu/kernels/ccl.py::union_find_roots (ccl.py:162-241), a
// fixpoint of gather-free segmented min-scans and stencil hops written for
// the TPU, and the port's plain body (kernels/ccl.py::union_find_roots_plain),
// which sweeps every voxel once per min-propagation round with a host sync
// per round.  For each voxel of a bool mask of up to three axes it returns
// the minimum linear index of its component, or n = mask.numel() for
// background; "full" connectivity is 26 (3D) or 8 (2D), "faces" 6 or 4.  A
// 2D (or 1D) mask is a 3D one of depth (and height) 1.
//
// What bounds it: memory.  Each voxel's mask byte is read and its int64
// root written once (9 bytes a voxel).  The scratch is an int32 parent per
// foreground voxel and one 32-bit word of mask bits per 32 voxels of a row.
//
// Design (after Allegretti et al. 2020, "Optimized block-based algorithms
// to label connected components on GPUs", and Playne & Hawick 2018), three
// kernels on the caller's stream with no host sync between them.  A tile is
// 32 voxels along x (a warp's width) by TY rows by TZ planes: 32 x 8 x 4 in
// 3D and 32 x 32 in 2D, 1,024 voxels, so that about a third of the tile's
// rows (3D) lie on its low y or z face.  Its block is 4 warps, each taking
// 8 rows: a thread issues its 8 mask loads before it waits on any, which
// keeps enough bytes in flight to stream a sparse mask.
//
// 1. local: a block loads its tile's mask bytes (one a thread and row, 32
//    consecutive bytes a warp), takes each row's bits with __ballot_sync and
//    writes them to `bits` (row-major, ceil(width / 32) words a row).  Each
//    voxel's first voxel of its run along x is the lowest lane above the
//    highest clear bit below it (__clz), so a run needs no unions: every
//    voxel of it starts linked to its first voxel in a shared-memory parent
//    array of local indices.  Two runs of neighbouring rows of the tile that
//    touch are united once, at a column found from the two rows' bits where
//    one of them starts (pairs_same, pairs_left, pairs_right).  Unions in
//    shared memory link
//    the larger local root under the smaller with atomicMin and retry from
//    the value a lost race returns.  The local raster order is the global
//    raster order restricted to the tile, so a piece's local root is its
//    smallest global index: each foreground voxel writes that index as its
//    global parent.  Background voxels write no parent.
// 2. border: one thread per row word.  For each backward neighbour row in
//    another tile it makes the same one union per pair of touching runs
//    (bit arithmetic, no voxel loop), and for full connectivity the
//    unions of the row's first and last voxel with the diagonal neighbours
//    in the next tiles along x; every row unites its first voxel with the
//    last of the word before, through unite() of union_find.cuh (atomicMin
//    links to the smaller index, path halving), so every root is its
//    component's minimum in any order.
// 3. flatten: a warp loads 32 row words in one coalesced read and writes
//    their voxels word by word, a word's 32 int64 roots as one coalesced
//    256-byte store.  A background voxel (its bit clear) writes n without
//    reading parent; a foreground voxel whose parent is a root takes it
//    after one more read, others walk up; four words' parents are loaded
//    before their walks.
//
// Indices are int32 (the wrapper raises for n >= 2**31, so the sentinel n
// fits); coordinates come from the tile and word indices, with one 32-bit
// division a block (local) or a row word (border, flatten), none a voxel.
// The kernels allocate nothing; the C entry point returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include "union_find.cuh"  // find_halving, unite

namespace {

constexpr int WORD_THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// ---------------------------------------------------------------------------
// union-find in shared memory (local indices) and in global memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ int find_local(volatile int* s, int i) {
  int p = s[i];
  while (p != i) {
    i = p;
    p = s[i];
  }
  return i;
}

__device__ __forceinline__ void unite_local(int* s, int a, int b) {
  while (true) {
    a = find_local(s, a);
    b = find_local(s, b);
    if (a == b) return;
    const int hi = a > b ? a : b;
    const int lo = a > b ? b : a;
    const int old = atomicMin(s + hi, lo);
    if (old == hi) return;  // hi was a root and now hangs under lo
    a = old;                // hi had been linked to old < hi: unite old and lo
    b = lo;
  }
}

// ---------------------------------------------------------------------------
// 1. local: runs along x and unions inside the tile
// ---------------------------------------------------------------------------

// The one union for each pair of touching runs of a row word a (v) and a
// neighbour row word b (u), for v at bit l:
//   faces: u = l where l starts a's run and b_l, or starts b's run and a_l,
//     the first column where the two runs overlap;
//   full: u = l where l starts a's run and b_l; else u = l - 1 where l starts
//     a's run and b_(l-1) (b's run began before a's); u = l + 1 where l + 1
//     starts b's run and a_l (a's run began before b's).
// A pair whose only contact lies across the word's edge is the diagonal
// union of the border kernel.
template <bool FULL>
__device__ __forceinline__ uint32_t pairs_same(uint32_t a, uint32_t b) {
  const uint32_t a_start = a & ~(a << 1), b_start = b & ~(b << 1);
  return FULL ? a_start & b : (a_start & b) | (a & b_start);
}

__device__ __forceinline__ uint32_t pairs_left(uint32_t a, uint32_t b) {
  return a & ~(a << 1) & ~b & (b << 1);
}

__device__ __forceinline__ uint32_t pairs_right(uint32_t a, uint32_t b) {
  return a & ((b & ~(b << 1)) >> 1);
}

// lane `lane`'s unions (voxel li) with local row nr (bits nb); a holds the
// lane's own row
template <bool FULL>
__device__ __forceinline__ void link_row_local(int* s, uint32_t a, uint32_t nb, int nr, int lane,
                                               int li) {
  const uint32_t me = 1u << lane;
  if (pairs_same<FULL>(a, nb) & me) unite_local(s, li, nr * 32 + lane);
  if (FULL && (pairs_left(a, nb) & me)) unite_local(s, li, nr * 32 + lane - 1);
  if (FULL && (pairs_right(a, nb) & me)) unite_local(s, li, nr * 32 + lane + 1);
}

// a block of WARPS warps owns one 32 x TY x TZ tile; warp w takes the
// tile's rows w, w + WARPS, ..., so that each thread has ROWS / WARPS mask
// loads in flight before its first ballot
template <bool FULL, int TY, int TZ, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
local_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
             uint32_t* __restrict__ bits_out, int depth, int height, int width, int words,
             int tiles_y) {
  constexpr int ROWS = TY * TZ;
  constexpr int PER_WARP = ROWS / WARPS;
  static_assert(ROWS % WARPS == 0, "a warp takes whole rows");
  __shared__ int s_parent[32 * ROWS];
  __shared__ uint32_t s_bits[ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xt = blockIdx.x % words;
  const int tile_yz = blockIdx.x / words;
  const int y0 = (tile_yz % tiles_y) * TY, z0 = (tile_yz / tiles_y) * TZ;
  const int x = xt * 32 + lane;
  uint8_t byte[PER_WARP];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {  // every load issued before the first ballot
    const int row = warp + k * WARPS;
    const int y = y0 + row % TY, z = z0 + row / TY;
    byte[k] = (y < height && z < depth && x < width) ? mask[(z * height + y) * width + x] : 0;
  }
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int row = warp + k * WARPS;
    const uint32_t bits = __ballot_sync(0xffffffffu, byte[k] != 0);
    if (lane == 0) {
      const int y = y0 + row % TY, z = z0 + row / TY;
      s_bits[row] = bits;
      if (y < height && z < depth) bits_out[(long long)(z * height + y) * words + xt] = bits;
    }
    const uint32_t gaps = ~bits & ((1u << lane) - 1u);  // clear bits below this lane
    const int start = gaps ? 32 - __clz(gaps) : 0;      // the first lane of this voxel's run
    s_parent[row * 32 + lane] = row * 32 + (byte[k] ? start : lane);
  }
  __syncthreads();

  for (int k = 0; k < PER_WARP; ++k) {
    const int row = warp + k * WARPS;
    const uint32_t bits = s_bits[row];
    if (!((bits >> lane) & 1u)) continue;
    const int ly = row % TY, lz = row / TY, li = row * 32 + lane;
    if (ly > 0) link_row_local<FULL>(s_parent, bits, s_bits[row - 1], row - 1, lane, li);
    if (lz > 0) {
#pragma unroll
      for (int dy = FULL ? -1 : 0; dy <= (FULL ? 1 : 0); ++dy) {
        const int ny = ly + dy;
        if (ny < 0 || ny >= TY) continue;
        const int nr = (lz - 1) * TY + ny;
        link_row_local<FULL>(s_parent, bits, s_bits[nr], nr, lane, li);
      }
    }
  }
  __syncthreads();

  for (int k = 0; k < PER_WARP; ++k) {
    const int row = warp + k * WARPS;
    if (!((s_bits[row] >> lane) & 1u)) continue;
    const int r = find_local(s_parent, row * 32 + lane);
    const int rr = r >> 5;
    const int y = y0 + row % TY, z = z0 + row / TY;
    parent[(z * height + y) * width + x] =
        ((z0 + rr / TY) * height + y0 + rr % TY) * width + xt * 32 + (r & 31);
  }
}

// ---------------------------------------------------------------------------
// 2. border: unions with voxels of other tiles
// ---------------------------------------------------------------------------

// the unions at the set bits l of cand, of voxel base + l with nbase + l + dx
__device__ __forceinline__ void link_words(int* parent, uint32_t cand, int base, int nbase,
                                           int dx) {
  while (cand) {
    const int l = __ffs(cand) - 1;
    cand &= cand - 1;
    unite(parent, base + l, nbase + l + dx);
  }
}

template <bool FULL, int TY, int TZ>
__global__ void __launch_bounds__(WORD_THREADS)
border_kernel(const uint32_t* __restrict__ bits, int* parent, int depth, int height, int width,
              int words) {
  const int total = depth * height * words;
  const int step = gridDim.x * WORD_THREADS;
  for (int w = blockIdx.x * WORD_THREADS + threadIdx.x; w < total; w += step) {
    const uint32_t a = __ldg(bits + w);
    if (!a) continue;
    const int xt = w % words, row_id = w / words;
    const int y = row_id % height, z = row_id / height;
    const int base = row_id * width + xt * 32;
    if (xt > 0 && (a & 1u) && (__ldg(bits + w - 1) >> 31)) unite(parent, base, base - 1);
#pragma unroll
    for (int k = 0; k < (FULL ? 4 : 2); ++k) {
      // backward neighbour rows: faces (0, -1), (-1, 0); full (0, -1), (-1, -1), (-1, 0), (-1, 1)
      const int dz = FULL ? (k == 0 ? 0 : -1) : -k;
      const int dy = FULL ? (k == 0 ? -1 : k - 2) : k - 1;
      const int ny = y + dy, nz = z + dz;
      if (ny < 0 || ny >= height || nz < 0) continue;
      const int nw = (nz * height + ny) * words + xt;
      const int nbase = (nz * height + ny) * width + xt * 32;
      if (nz / TZ != z / TZ || ny / TY != y / TY) {  // the row lies in another tile
        const uint32_t b = __ldg(bits + nw);
        if (b) {
          link_words(parent, pairs_same<FULL>(a, b), base, nbase, 0);
          if (FULL) {
            link_words(parent, pairs_left(a, b), base, nbase, -1);
            link_words(parent, pairs_right(a, b), base, nbase, 1);
          }
        }
      }
      if (FULL) {  // diagonals into the tiles before and after along x
        if (xt > 0 && (a & 1u) && (__ldg(bits + nw - 1) >> 31)) unite(parent, base, nbase - 1);
        if (xt + 1 < words && (a >> 31) && (__ldg(bits + nw + 1) & 1u))
          unite(parent, base + 31, nbase + 32);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. flatten: int64 roots, n for background
// ---------------------------------------------------------------------------

// each warp loads 32 consecutive row words at once, then writes their
// voxels word by word (a word's bits and first index passed by shuffle),
// with the parents of four words loaded before their roots are walked
__global__ void __launch_bounds__(WORD_THREADS)
flatten_kernel(const uint32_t* __restrict__ bits, const int* parent, int64_t* __restrict__ out,
               int total, int width, int words, int n) {
  constexpr int GROUP = 4;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (WORD_THREADS / 32);
  for (int w0 = (blockIdx.x * (WORD_THREADS / 32) + (threadIdx.x >> 5)) * 32; w0 < total;
       w0 += warps * 32) {
    const int w = w0 + lane;
    uint32_t my_bits = 0;
    int my_base = 0, my_valid = 0;
    if (w < total) {
      my_bits = __ldg(bits + w);
      const int xt = w % words;
      my_base = (w / words) * width + xt * 32;
      my_valid = min(32, width - xt * 32);
    }
    const int count = min(32, total - w0);
    for (int j0 = 0; j0 < count; j0 += GROUP) {
      int g[GROUP], root[GROUP];
      bool fg[GROUP], valid[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int j = min(j0 + k, 31);
        const uint32_t a = __shfl_sync(0xffffffffu, my_bits, j);
        g[k] = __shfl_sync(0xffffffffu, my_base, j) + lane;
        valid[k] = j0 + k < count && lane < __shfl_sync(0xffffffffu, my_valid, j);
        fg[k] = valid[k] && ((a >> lane) & 1u);
        root[k] = fg[k] ? __ldcg(parent + g[k]) : n;
      }
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        if (fg[k])
          for (int p = __ldcg(parent + root[k]); p != root[k]; p = __ldcg(parent + root[k]))
            root[k] = p;
        if (valid[k]) out[g[k]] = root[k];
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

int grid_for(long long threads) {
  const long long blocks = (threads + WORD_THREADS - 1) / WORD_THREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <bool FULL, int TY, int TZ, int WARPS>
cudaError_t run(const uint8_t* mask, int* parent, uint32_t* bits, int64_t* out, int depth,
                int height, int width, cudaStream_t s) {
  const int words = (width + 31) / 32;
  const int tiles_y = (height + TY - 1) / TY;
  const long long tiles = (long long)words * tiles_y * ((depth + TZ - 1) / TZ);
  const int rows = depth * height;
  local_kernel<FULL, TY, TZ, WARPS><<<(unsigned)tiles, 32 * WARPS, 0, s>>>(
      mask, parent, bits, depth, height, width, words, tiles_y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  border_kernel<FULL, TY, TZ><<<grid_for((long long)rows * words), WORD_THREADS, 0, s>>>(
      bits, parent, depth, height, width, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flatten_kernel<<<grid_for((long long)rows * words), WORD_THREADS, 0, s>>>(
      bits, parent, out, rows * words, width, words, depth * height * width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Roots of the components of a (depth, height, width) bool mask (one byte
// a voxel, C order) into out (int64, n values).  parent: int32 scratch of n
// values; bits: 32-bit scratch of depth * height * ceil(width / 32) words.
// full: 26-connectivity, else 6.
int ccl_union_find(const void* mask, void* parent, void* bits, void* out, int depth, int height,
                   int width, int full, void* stream) {
  const long long n = (long long)depth * height * width;
  if (depth < 1 || height < 1 || width < 1 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
  const uint8_t* m = (const uint8_t*)mask;
  int* p = (int*)parent;
  uint32_t* b = (uint32_t*)bits;
  int64_t* o = (int64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (depth > 1)
    err = full ? run<true, 8, 4, 4>(m, p, b, o, depth, height, width, s)
               : run<false, 8, 4, 4>(m, p, b, o, depth, height, width, s);
  else
    err = full ? run<true, 32, 1, 4>(m, p, b, o, depth, height, width, s)
               : run<false, 32, 1, 4>(m, p, b, o, depth, height, width, s);
  return (int)err;
}

}  // extern "C"
