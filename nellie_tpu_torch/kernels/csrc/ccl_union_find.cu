// Connected-component roots by lock-free union-find, for Hopper (sm_90a).
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
// root written once (9 bytes a voxel); the int32 parent array is scratch,
// written by init and read by merge and flatten for foreground voxels
// only.  There is no arithmetic to speak of.  At the capacity path's 0.1 %
// foreground almost every thread reads one mask byte and writes its
// background root.
//
// Design (after Playne & Hawick 2018 and Allegretti et al. 2020), three
// kernels on the caller's stream with no host sync between them:
//
// 1. init: parent[i] = i for foreground, n for background.
// 2. merge: each foreground voxel unites with every foreground neighbour
//    in the backward half of its stencil (13 of 26, 3 of 6; in a plane 4
//    of 8, 2 of 4).  unite() finds both roots, then links the larger root
//    under the smaller with atomicMin.  If the larger root was linked
//    elsewhere meanwhile, atomicMin returns its new parent (smaller than
//    it) and the union retries from there, so no link is lost.  Links
//    always point to a smaller index, so every root is its component's
//    minimum index, whatever order the atomics take.  Reads of parent
//    bypass L1 (__ldcg): another SM may have just changed the value, and a
//    stale one only makes a failed atomicMin and a retry.
// 3. flatten: out[i] = find(i) as int64 (n for background), with each
//    voxel's parent set to its root on the way.
//
// Indices are int32: the wrapper raises for n >= 2**31 (the sentinel n
// must fit).  Loops stride over the grid in 64-bit counters, so no index
// overflows near 2**31.  A shared-memory block-local pass and a
// compaction of the foreground are later work.
//
// The kernels allocate nothing; the C entry point returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ int find_root(const int* parent, int i) {
  int p = __ldcg(parent + i);
  while (p != i) {
    i = p;
    p = __ldcg(parent + i);
  }
  return i;
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    const int hi = a > b ? a : b;
    const int lo = a > b ? b : a;
    const int old = atomicMin(parent + hi, lo);
    if (old == hi) return;  // hi was a root and now hangs under lo
    a = old;                // hi had been linked to old < hi: unite old and lo
    b = lo;
  }
}

__global__ void init_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    parent[i] = mask[i] ? (int)i : n;
}

template <bool FULL>
__global__ void merge_kernel(const uint8_t* __restrict__ mask, int* parent, int depth,
                             int height, int width) {
  const long long n = (long long)depth * height * width;
  const long long plane = (long long)height * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!mask[i]) continue;
    const int x = (int)(i % width);
    const long long row = i / width;
    const int y = (int)(row % height);
    const int z = (int)(row / height);
    const int self = (int)i;
    if (FULL) {
      // (dz, dy, dx) before (0, 0, 0) in raster order: the 9 of the plane
      // above, the 3 of the row above, and the voxel to the left
      for (int dz = -1; dz <= 0; ++dz) {
        if (z + dz < 0) continue;
        for (int dy = -1; dy <= (dz < 0 ? 1 : 0); ++dy) {
          if (y + dy < 0 || y + dy >= height) continue;
          const int dx_hi = (dz < 0 || dy < 0) ? 1 : -1;
          for (int dx = -1; dx <= dx_hi; ++dx) {
            if (x + dx < 0 || x + dx >= width) continue;
            const long long j = i + dz * plane + (long long)dy * width + dx;
            if (mask[j]) unite(parent, self, (int)j);
          }
        }
      }
    } else {
      if (z > 0 && mask[i - plane]) unite(parent, self, (int)(i - plane));
      if (y > 0 && mask[i - width]) unite(parent, self, (int)(i - width));
      if (x > 0 && mask[i - 1]) unite(parent, self, self - 1);
    }
  }
}

__global__ void flatten_kernel(const uint8_t* __restrict__ mask, int* parent,
                               int64_t* __restrict__ out, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!mask[i]) {
      out[i] = n;
      continue;
    }
    const int root = find_root(parent, (int)i);
    parent[i] = root;
    out[i] = root;
  }
}

int grid_for(long long n) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Roots of the components of a (depth, height, width) bool mask (one byte
// a voxel, C order) into out (int64, n values); parent is int32 scratch of
// n values.  full: 26-connectivity, else 6.
int ccl_union_find(const void* mask, void* parent, void* out, int depth, int height, int width,
                   int full, void* stream) {
  const long long n = (long long)depth * height * width;
  if (depth < 1 || height < 1 || width < 1 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(n);
  const uint8_t* m = (const uint8_t*)mask;
  int* p = (int*)parent;
  init_kernel<<<grid, THREADS, 0, s>>>(m, p, (int)n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (full)
    merge_kernel<true><<<grid, THREADS, 0, s>>>(m, p, depth, height, width);
  else
    merge_kernel<false><<<grid, THREADS, 0, s>>>(m, p, depth, height, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flatten_kernel<<<grid, THREADS, 0, s>>>(m, p, (int64_t*)out, (int)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
