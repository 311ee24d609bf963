// The cross-cell merge of capacity's chunked strategy, for Hopper (sm_90a):
// two launches a call, no host read.
//
// Replaces the host union-find that joins the cells' pieces: in the JAX
// package nellie_tpu/pipeline/capacity.py:470-588 (_HostUnionFind over the
// root pairs of _plane_pair_edges, _merge_cells, then sorted verdict tables
// sent back up by _sorted_table_dev), which the port copied until it moved
// here.  The plain body is kernels/ccl.py::merge_cell_roots_plain.
//
// Input: the volume's int32 roots as pipeline/capacity.py::_cell_roots
// writes them, -1 where a voxel takes no part, otherwise its piece's global
// minimum raveled index.  So roots[r] == r at every piece root r, and the
// array already is a union-find forest of depth 1 indexed by voxel.  Output,
// in place: every member voxel holds its merged component's minimum raveled
// index (scipy's order key); -1 stays -1.
//
// 1. merge: one launch over every internal cell boundary (a plane position
//    along an axis, blockIdx.y; up to MAX_PLANES a launch, passed by value).
//    A thread takes a voxel of the plane just before the boundary and, for
//    each in-plane shift (only the aligned voxel for faces connectivity; the
//    3 x 3 around it for full, those inside the volume), the voxel just
//    after the boundary: when both roots are >= 0 and differ it unites the
//    two piece roots with union_find.cuh's unite() (atomicMin links to the
//    smaller index, path halving).  Every entry a find walks is a piece
//    root, so the members' entries are not written here.
// 2. flatten: every voxel, four a thread (one int4 load): a member walks
//    from its piece root to the root of the merged tree and writes it where
//    it differs.  A write replaces an entry by one of its ancestors, so a
//    walk that reads it meanwhile still ends at the same root.
//
// What bounds it: bytes.  The roots are read once by the flatten and the
// boundary planes' roots by the merge (the shifted voxels come from L1/L2);
// the flatten writes only the members whose root changed.  2D volumes are
// 3D ones of depth 1.  Indices are int32 (the wrapper raises for 2^31
// voxels or more).  The kernels allocate nothing; the C entry point returns
// the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include "union_find.cuh"  // find_halving, unite

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_PLANES = 64;

struct Planes {
  int axis[MAX_PLANES];  // 0 (depth), 1 (height) or 2 (width)
  int pos[MAX_PLANES];   // the first index past the boundary, in [1, extent)
};

template <bool FULL>
__global__ void __launch_bounds__(THREADS)
merge_kernel(int* roots, int depth, int height, int width, Planes planes) {
  const int axis = planes.axis[blockIdx.y], pos = planes.pos[blockIdx.y];
  const int dims[3] = {depth, height, width};
  const int strides[3] = {height * width, width, 1};
  const int a0 = axis == 0 ? 1 : 0, a1 = axis == 2 ? 1 : 2;  // in-plane axes, slower first
  const int e0 = dims[a0], e1 = dims[a1], s0 = strides[a0], s1 = strides[a1];
  const int step = strides[axis];
  const int n_plane = e0 * e1;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n_plane; i += gridDim.x * THREADS) {
    const int c0 = i / e1, c1 = i - c0 * e1;
    const int left = c0 * s0 + c1 * s1 + (pos - 1) * step;
    const int ra = __ldcg(roots + left);
    if (ra < 0) continue;
    const int right = left + step;
#pragma unroll
    for (int d0 = FULL ? -1 : 0; d0 <= (FULL ? 1 : 0); ++d0) {
      if (c0 + d0 < 0 || c0 + d0 >= e0) continue;
#pragma unroll
      for (int d1 = FULL ? -1 : 0; d1 <= (FULL ? 1 : 0); ++d1) {
        if (c1 + d1 < 0 || c1 + d1 >= e1) continue;
        const int rb = __ldcg(roots + right + d0 * s0 + d1 * s1);
        if (rb >= 0 && rb != ra) unite(roots, ra, rb);
      }
    }
  }
}

__device__ __forceinline__ void flatten_one(int* roots, int i, int v) {
  if (v < 0) return;
  int r = v, p = __ldcg(roots + r);
  while (p != r) {
    r = p;
    p = __ldcg(roots + r);
  }
  if (r != v) __stcg(roots + i, r);
}

__global__ void __launch_bounds__(THREADS) flatten_kernel(int* roots, int n) {
  const int quads = n / 4;
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  for (int q = first; q < quads; q += stride) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(roots) + q);
    flatten_one(roots, 4 * q, v.x);
    flatten_one(roots, 4 * q + 1, v.y);
    flatten_one(roots, 4 * q + 2, v.z);
    flatten_one(roots, 4 * q + 3, v.w);
  }
  const int i = 4 * quads + first;  // the last n % 4 voxels
  if (i < n) flatten_one(roots, i, __ldcg(roots + i));
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

int grid_for(long long threads, long long cap) {
  const long long blocks = (threads + THREADS - 1) / THREADS;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Merge the cells' pieces of a (depth, height, width) int32 roots volume
// across the boundaries (axes[k], positions[k]), k < n_planes, then flatten
// it, in place.  full: 26-connectivity (8 in 2D), else 6 (4).  *kernels
// receives the number of CUDA kernels launched.
int ccl_merge(void* roots, int depth, int height, int width, const int* axes,
              const int* positions, int n_planes, int full, void* stream, int* kernels) {
  *kernels = 0;
  const long long n = (long long)depth * height * width;
  if (depth < 1 || height < 1 || width < 1 || n > 2147483647LL || n_planes < 0)
    return (int)cudaErrorInvalidValue;
  const int dims[3] = {depth, height, width};
  long long largest = 0;
  for (int k = 0; k < n_planes; ++k) {
    if (axes[k] < 0 || axes[k] > 2 || positions[k] < 1 || positions[k] >= dims[axes[k]])
      return (int)cudaErrorInvalidValue;
    const long long plane = n / dims[axes[k]];
    largest = plane > largest ? plane : largest;
  }
  int* r = (int*)roots;
  cudaStream_t s = (cudaStream_t)stream;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  for (int k0 = 0; k0 < n_planes; k0 += MAX_PLANES) {
    Planes planes;
    const int count = n_planes - k0 < MAX_PLANES ? n_planes - k0 : MAX_PLANES;
    for (int k = 0; k < count; ++k) {
      planes.axis[k] = axes[k0 + k];
      planes.pos[k] = positions[k0 + k];
    }
    const dim3 grid(grid_for(largest, (cap + count - 1) / count), count);
    if (full)
      merge_kernel<true><<<grid, THREADS, 0, s>>>(r, depth, height, width, planes);
    else
      merge_kernel<false><<<grid, THREADS, 0, s>>>(r, depth, height, width, planes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*kernels;
  }
  flatten_kernel<<<grid_for(n / 4 + 1, cap), THREADS, 0, s>>>(r, (int)n);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*kernels;
  return (int)err;
}

}  // extern "C"
