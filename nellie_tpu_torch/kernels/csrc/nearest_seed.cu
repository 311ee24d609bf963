// Object-constrained nearest seed by jump flooding (JFA+1), for Hopper (sm_90a).
//
// Replaces nellie_tpu/kernels/edt.py::nearest_seed (edt.py:73-160), a
// lax.fori_loop over the jump steps that rolls the whole state volume once
// per step and offset, and the port's plain body
// (kernels/edt.py::nearest_seed_plain): about twelve torch launches per step
// and offset, two of them the fused multiply-add kernel, on every voxel.
//
// What it computes, exactly as the plain body does.  The state is each
// voxel's nearest seed so far as a flat index (-1 for none); seeds start
// with their own index.  Steps are 2**(n-1), ..., 2, 1 and one more 1.  At
// each step the offsets run in itertools.product((-1, 0, 1)) order, and
// each offset reads the state that the previous offsets of the step left:
// voxel v takes the candidate c = idx[v + off * step] when the source lies
// inside the volume, c >= 0, the candidate's object equals v's (when
// objects are given), and d(v, c) < d(v, idx[v]) strictly.  d is the
// squared physical distance with the reference's rounding: each axis'
// difference float(coord - q) * sampling (q unflattened from the index by
// division), summed as XLA contracts it on the CPU:
//   3D fma(d2, d2, fma(d0, d0, d1 * d1)),  2D fma(d0, d0, d1 * d1),  1D d0 * d0
// (built with -fmad=false, every contraction an explicit __fmaf_rn).  The
// distance out is the correctly rounded root (__fsqrt_rn), +inf for none.
//
// Two facts keep the state to one int32 a voxel:
//  * the plain body carries the candidate seed's object beside its index;
//    a voxel only ever takes a seed of its own object, so that carried value
//    is the voxel's own object wherever its index is set, and the test
//    cand_obj == my_obj is obj[source] == obj[v] with idx[source] >= 0;
//  * d(v, idx[v]) is recomputed from idx[v] (the plain body keeps it as
//    cur_d, which always equals that recomputation).
// One launch per (step, offset) reads state buffer A and writes B, then the
// two swap: the update is sequential across offsets and parallel across
// voxels, as in the plain body.  The loop over steps and offsets runs in the
// C entry point, with no host sync.
//
// What bounds it: memory and launches.  Each launch reads idx (and obj) at
// v and at its source and writes idx, 8-16 bytes a voxel.  When the wrapper
// knows that the voxels of object 0 can never take a seed (no seed lies in
// object 0), it passes the list of the other voxels, and only those run:
// 4 % of the 3D main frame.  Voxels off the list keep their index in both
// buffers.
//
// The kernels allocate nothing; the C entry point returns the first CUDA
// error, says which buffer holds the result and counts the kernels it
// launched.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Grid {
  int ndim;
  int shape[3];
  int stride[3];
  float sampling[3];
};

__device__ __forceinline__ void coords_of(const Grid& g, int v, int* c) {
  int rem = v;
  for (int a = 0; a < g.ndim - 1; ++a) {
    c[a] = rem / g.stride[a];
    rem -= c[a] * g.stride[a];
  }
  c[g.ndim - 1] = rem;
}

// Squared physical distance from the voxel at coordinates c to the seed at
// flat index idx (>= 0), rounded as the plain body's seed_dist.
__device__ __forceinline__ float seed_dist(const Grid& g, const int* c, int idx) {
  int q[3];
  coords_of(g, idx, q);
  float d[3];
  for (int a = 0; a < g.ndim; ++a) d[a] = __fmul_rn((float)(c[a] - q[a]), g.sampling[a]);
  if (g.ndim == 1) return __fmul_rn(d[0], d[0]);
  float acc = __fmaf_rn(d[0], d[0], __fmul_rn(d[1], d[1]));
  if (g.ndim == 3) acc = __fmaf_rn(d[2], d[2], acc);
  return acc;
}

__global__ void jfa_offset(const int* __restrict__ list, int n, const int* __restrict__ src_idx,
                           int* __restrict__ dst_idx, const int* __restrict__ obj, Grid g,
                           int o0, int o1, int o2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v = list ? list[i] : i;
  const int mine = src_idx[v];
  int c[3];
  coords_of(g, v, c);
  const int off[3] = {o0, o1, o2};
  int source = 0;
  bool inside = true;
  for (int a = 0; a < g.ndim; ++a) {
    const int s = c[a] + off[a];
    inside = inside && s >= 0 && s < g.shape[a];
    source += s * g.stride[a];
  }
  int best = mine;
  if (inside) {
    const int cand = src_idx[source];
    if (cand >= 0 && (obj == nullptr || obj[source] == obj[v])) {
      const float cur = mine >= 0 ? seed_dist(g, c, mine) : INFINITY;
      if (seed_dist(g, c, cand) < cur) best = cand;
    }
  }
  dst_idx[v] = best;
}

__global__ void jfa_distance(const int* __restrict__ idx, float* __restrict__ dist, int n,
                             Grid g) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int seed = idx[v];
  float d = INFINITY;
  if (seed >= 0) {
    int c[3];
    coords_of(g, v, c);
    d = __fsqrt_rn(seed_dist(g, c, seed));
  }
  dist[v] = d;
}

}  // namespace

extern "C" {

// Jump flooding over a C-order volume of ndim (1-3) axes `shape`.  idx_a and
// idx_b: int32 state, both holding the starting state (the voxel's own flat
// index at seeds, -1 elsewhere); obj: int32 objects or null; list: the
// int32 voxels that run (n_list of them) or null for every voxel; steps:
// the n_steps jump lengths (host).  dist: float32 out, the root of the
// distance to the final seed.  *result is set to 0 or 1: the buffer (a or b)
// that holds the final state; *launched to the number of kernels launched.
int nearest_seed(void* idx_a, void* idx_b, const void* obj, const void* list, int n_list,
                 int ndim, const int* shape, const float* sampling, const int* steps,
                 int n_steps, void* dist, int* result, int* launched, void* stream) {
  if (ndim < 1 || ndim > 3 || n_steps < 0) return (int)cudaErrorInvalidValue;
  Grid g;
  g.ndim = ndim;
  long long voxels = 1;
  for (int a = 0; a < ndim; ++a) {
    if (shape[a] < 1) return (int)cudaErrorInvalidValue;
    g.shape[a] = shape[a];
    g.sampling[a] = sampling[a];
    voxels *= shape[a];
  }
  if (voxels > 2147483647LL) return (int)cudaErrorInvalidValue;
  for (int a = ndim - 1, stride = 1; a >= 0; --a) {
    g.stride[a] = stride;
    stride *= shape[a];
  }
  const int n = (int)voxels;
  const int* l = (const int*)list;
  const int work = l ? n_list : n;
  cudaStream_t s = (cudaStream_t)stream;
  int* bufs[2] = {(int*)idx_a, (int*)idx_b};
  int cur = 0;
  *launched = 0;
  cudaError_t err;
  if (work > 0) {
    const int blocks = (work + THREADS - 1) / THREADS;
    for (int k = 0; k < n_steps; ++k) {
      const int step = steps[k];
      for (int o0 = -1; o0 <= 1; ++o0)
        for (int o1 = (ndim > 1 ? -1 : 0); o1 <= (ndim > 1 ? 1 : 0); ++o1)
          for (int o2 = (ndim > 2 ? -1 : 0); o2 <= (ndim > 2 ? 1 : 0); ++o2) {
            if (o0 == 0 && o1 == 0 && o2 == 0) continue;
            jfa_offset<<<blocks, THREADS, 0, s>>>(l, work, bufs[cur], bufs[1 - cur],
                                                  (const int*)obj, g, o0 * step, o1 * step,
                                                  o2 * step);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            ++*launched;
            cur = 1 - cur;
          }
    }
  }
  jfa_distance<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(bufs[cur], (float*)dist, n, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  *result = cur;
  return (int)cudaSuccess;
}

}  // extern "C"
