// Object-constrained nearest seed by jump flooding (JFA+1), for Hopper
// (sm_90a): one persistent cooperative kernel a call.
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
// distance out is the correctly rounded root (__fsqrt_rn), +inf for none;
// the label out is the seed's value at the final index, 0 for none.
//
// Two facts keep the state to one int32 a voxel:
//  * the plain body carries the candidate seed's object beside its index;
//    a voxel only ever takes a seed of its own object, so that carried value
//    is the voxel's own object wherever its index is set, and the test
//    cand_obj == my_obj is obj[source] == obj[v] with idx[source] >= 0;
//  * d(v, idx[v]) is a function of idx[v] (the plain body keeps it as
//    cur_d, which always equals that recomputation).
//
// What bounds it: the latency of its 26 x 9 (3D) or 8 x 11 (2D) dependent
// passes, not bytes: each pass reads one state value at a source and
// writes one a voxel, a few hundred kilobytes that stay in the 50 MB L2.
// What the design does about it: the whole loop is one cooperative launch
// (cudaLaunchCooperativeKernel, a grid of one resident wave) whose passes
// are separated by grid barriers (coop_grid.cuh: a counter that only grows,
// with release and acquire at GPU scope) in place of kernel boundaries, with no host
// sync.  Inside the launch:
//  * phase 0: every block scans its share of the volume for a seed in
//    object 0 and counts its voxels outside object 0;
//  * phase 1: when objects are given and no seed lies in object 0, the
//    voxels of object 0 can never take a seed: they get label 0 and +inf,
//    and the others are compacted, in raster order, to a list (slot ->
//    voxel), with a map voxel -> slot (-1 off the list) and the state kept
//    by slot.  Otherwise every voxel runs and its slot is its index.
//  * the passes: each thread owns the slots i, i + threads, ...; a source
//    off the list has object 0 and so another object than the voxel's, and
//    is rejected as in the plain body.  When the list fits the grid (a slot
//    a thread, the main paths' case) a thread keeps its voxel, coordinates,
//    object, state and distance in registers, and loads the next pass's
//    source object and slot (which do not depend on the state) between
//    arriving at the barrier and waiting on it, so that a pass waits on one
//    L2 load: the source's state; blocks with no slot leave after phase 1
//    and the barriers count only the others.  A list longer than the grid's
//    threads (every voxel of a dense volume) takes several slots a thread,
//    read again each pass.
// A cluster design (the state of a list of up to 98,304 slots in the
// distributed shared memory of 16 blocks, the cluster's hardware barrier
// between passes) was probed on the card and measured slower than this one
// at both main-path lists (3D 1.88 ms against 1.07, 2D 0.97 against 0.35):
// with 16 SMs a thread keeps 3-6 slots and its loads of the next sources
// go one slot after another.
// The state is two buffers by slot, read and written in turn: a pass reads
// the state of the previous pass only.  list, map and the state are written
// inside the kernel, so they are read through the coherent path (no __ldg).
//
// The kernel allocates nothing; the C entry point clears the flags,
// launches the kernel once and returns the first CUDA error, with no host
// read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coop_grid.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_STEPS = 32;
constexpr int FLAG_BARRIER = 0, FLAG_SEED_IN_ZERO = 1, N_FLAGS = 2;  // then a count a block

struct Grid {
  int ndim;
  int shape[3];
  int stride[3];
  float sampling[3];
};

struct Job {
  const int* seeds;  // int32, > 0 at a seed
  const int* obj;    // int32 objects, or null
  int* labels;       // int32 out
  float* dist;       // float32 out
  int* list;         // slot -> voxel (n)
  int* map;          // voxel -> slot or -1 (n)
  int* state[2];     // by slot (n each)
  int* flags;        // N_FLAGS, then gridDim.x counts
  Grid g;
  int n;
  int n_steps;
  int steps[MAX_STEPS];
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

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  return total;
}

// Exclusive prefix of `flag` over the block's threads, and the block's total
__device__ __forceinline__ int block_scan(int flag, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  __syncthreads();
  if (lane == 0) scratch[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    const int c = scratch[w];
    before += w < warp ? c : 0;
    all += c;
  }
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// Pass p's offset times its step along each axis
__device__ __forceinline__ void pass_offset(const Job& job, int p, int* off) {
  const int noff = job.g.ndim == 3 ? 26 : job.g.ndim == 2 ? 8 : 2;
  const int step = job.steps[p / noff];
  int j = p % noff;
  const int centre = noff / 2;  // itertools.product order with the centre left out
  j = j < centre ? j : j + 1;
  for (int a = job.g.ndim - 1; a >= 0; --a) {
    off[a] = (j % 3 - 1) * step;
    j /= 3;
  }
}

// The source of pass p for the voxel at coordinates c: its flat index, or
// -1 outside the volume
__device__ __forceinline__ int source_of(const Job& job, int p, const int* c) {
  int off[3];
  pass_offset(job, p, off);
  int s = 0;
  for (int a = 0; a < job.g.ndim; ++a) {
    const int t = c[a] + off[a];
    if (t < 0 || t >= job.g.shape[a]) return -1;
    s += t * job.g.stride[a];
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
jfa_persistent(Job job) {
  __shared__ int scratch[THREADS / 32];
  __shared__ int block_offset;
  const Grid& g = job.g;
  const int n = job.n;
  unsigned int* counter = reinterpret_cast<unsigned int*>(job.flags + FLAG_BARRIER);
  volatile int* flags = job.flags;
  unsigned int target = 0;

  // phase 0: a seed in object 0; each block's voxels outside object 0
  const long long chunk = ((long long)n + gridDim.x - 1) / gridDim.x;
  const int lo = (int)min((long long)n, chunk * blockIdx.x);
  const int hi = (int)min((long long)n, chunk * (blockIdx.x + 1));
  if (job.obj != nullptr) {
    int listed = 0;
    bool in_zero = false;
    for (long long v = lo + threadIdx.x; v < hi; v += THREADS) {
      const int o = __ldg(job.obj + v);
      listed += o != 0;
      in_zero |= o == 0 && __ldg(job.seeds + v) > 0;
    }
    if (__syncthreads_or(in_zero) && threadIdx.x == 0) flags[FLAG_SEED_IN_ZERO] = 1;
    const int sum = block_sum(listed, scratch);
    if (threadIdx.x == 0) flags[N_FLAGS + blockIdx.x] = sum;
  }
  coop_grid::barrier(counter, target, gridDim.x);

  // phase 1: the list and map, or every voxel; the starting state
  const bool compact = job.obj != nullptr && flags[FLAG_SEED_IN_ZERO] == 0;
  int* state = job.state[0];
  int m = n;
  if (compact) {
    int before = 0;
    m = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
      const int c = flags[N_FLAGS + b];
      before += b < (int)blockIdx.x ? c : 0;
      m += c;
    }
    before = block_sum(before, scratch);
    m = block_sum(m, scratch);
    if (threadIdx.x == 0) block_offset = before;
    __syncthreads();
    for (long long base = lo; base < hi; base += THREADS) {
      const int v = static_cast<int>(min(base + threadIdx.x, (long long)hi));
      const bool inside = v < hi;
      const int o = inside ? __ldg(job.obj + v) : 0;
      int total;
      const int slot = block_offset + block_scan(inside && o != 0, scratch, &total);
      if (inside) {
        if (o != 0) {
          job.list[slot] = v;
          job.map[v] = slot;
          state[slot] = __ldg(job.seeds + v) > 0 ? v : -1;
        } else {
          job.map[v] = -1;
          job.labels[v] = 0;
          job.dist[v] = INFINITY;
        }
      }
      __syncthreads();  // every thread has read block_offset
      if (threadIdx.x == 0) block_offset += total;
      __syncthreads();
    }
  } else {
    for (long long v = lo + threadIdx.x; v < hi; v += THREADS)
      state[v] = __ldg(job.seeds + v) > 0 ? static_cast<int>(v) : -1;
  }
  coop_grid::barrier(counter, target, gridDim.x);

  // the passes, over the blocks that hold a slot
  const unsigned int active =
      (unsigned int)min((long long)gridDim.x, ((long long)m + THREADS - 1) / THREADS);
  if (blockIdx.x >= active) return;
  const int passes = job.n_steps * (g.ndim == 3 ? 26 : g.ndim == 2 ? 8 : 2);
  const int threads = active * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  int cur = 0;
  if (m <= threads) {
    // a slot a thread: the voxel, its object, state and distance in registers
    const bool mine = first < m;
    const int v = mine ? (compact ? job.list[first] : first) : 0;
    int c[3];
    coords_of(g, v, c);
    const int my_obj = job.obj != nullptr && mine ? __ldg(job.obj + v) : 0;
    int best = mine ? state[first] : -1;
    float best_d = best >= 0 ? seed_dist(g, c, best) : INFINITY;
    // the next pass's source slot, -1 where it is outside, off the list or
    // of another object
    auto source_slot = [&](int p) {
      const int s = mine ? source_of(job, p, c) : -1;
      if (s < 0) return -1;
      const int slot = compact ? job.map[s] : s;  // loaded beside the object
      if (job.obj != nullptr && __ldg(job.obj + s) != my_obj) return -1;
      return slot;
    };
    int src = passes > 0 ? source_slot(0) : -1;
    for (int p = 0; p < passes; ++p) {
      const int* from = job.state[cur];
      int* to = job.state[1 - cur];
      if (mine) {
        const int cand = src >= 0 ? from[src] : -1;
        if (cand >= 0) {
          const float d = seed_dist(g, c, cand);
          if (d < best_d) {
            best = cand;
            best_d = d;
          }
        }
        to[first] = best;
      }
      cur = 1 - cur;
      // the next pass's source (objects and map only) loads while the
      // barrier waits for the other blocks
      coop_grid::arrive(counter, target, active);
      src = p + 1 < passes ? source_slot(p + 1) : -1;
      coop_grid::wait(counter, target);
    }
    if (mine) {
      job.labels[v] = best >= 0 ? __ldg(job.seeds + best) : 0;
      job.dist[v] = best >= 0 ? __fsqrt_rn(best_d) : INFINITY;
    }
    return;
  }
  // several slots a thread: everything read again each pass
  for (int p = 0; p < passes; ++p) {
    const int* from = job.state[cur];
    int* to = job.state[1 - cur];
    for (long long i = first; i < m; i += threads) {
      const int v = compact ? job.list[i] : static_cast<int>(i);
      int c[3];
      coords_of(g, v, c);
      int best = from[i];
      const int s = source_of(job, p, c);
      if (s >= 0 && (job.obj == nullptr || __ldg(job.obj + s) == __ldg(job.obj + v))) {
        const int slot = compact ? job.map[s] : s;
        const int cand = slot >= 0 ? from[slot] : -1;
        if (cand >= 0) {
          const float cur_d = best >= 0 ? seed_dist(g, c, best) : INFINITY;
          if (seed_dist(g, c, cand) < cur_d) best = cand;
        }
      }
      to[i] = best;
    }
    cur = 1 - cur;
    coop_grid::barrier(counter, target, active);
  }
  const int* last = job.state[cur];
  for (long long i = first; i < m; i += threads) {
    const int v = compact ? job.list[i] : static_cast<int>(i);
    const int best = last[i];
    int c[3];
    coords_of(g, v, c);
    job.labels[v] = best >= 0 ? __ldg(job.seeds + best) : 0;
    job.dist[v] = best >= 0 ? __fsqrt_rn(seed_dist(g, c, best)) : INFINITY;
  }
}

}  // namespace

extern "C" {

// Int32 scratch the call needs for a volume of n voxels: the list, the map,
// two state buffers, the flags and a count for each block of the grid
long long nearest_seed_scratch(int n) {
  coop_grid::Launch shape;
  if (coop_grid::launch_shape<jfa_persistent>(THREADS, shape) != cudaSuccess) return -1;
  return 4LL * n + N_FLAGS + (long long)shape.blocks_per_sm * shape.sms;
}

// Jump flooding over a C-order volume of ndim (1-3) axes `shape`: seeds and
// obj (or null) int32 on the device; steps: the n_steps jump lengths
// (host); scratch: nearest_seed_scratch(n) int32 values on the device.
// labels (int32) and dist (float32) out: the seed's value and the root of
// the distance to it (0 and +inf for none).  stats (host, 3 values): CUDA
// kernels launched, host reads, grid blocks.
int nearest_seed(const void* seeds, const void* obj, int ndim, const int* shape,
                 const float* sampling, const int* steps, int n_steps, void* scratch,
                 void* labels, void* dist, long long* stats, void* stream) {
  if (ndim < 1 || ndim > 3 || n_steps < 0 || n_steps > MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  stats[0] = stats[1] = stats[2] = 0;
  Job job;
  Grid& g = job.g;
  g.ndim = ndim;
  long long voxels = 1;
  for (int a = 0; a < ndim; ++a) {
    if (shape[a] < 1) return (int)cudaErrorInvalidValue;
    g.shape[a] = shape[a];
    g.sampling[a] = sampling[a];
    voxels *= shape[a];
  }
  if (voxels > 2147483647LL) return (int)cudaErrorInvalidValue;  // int32 indices
  for (int a = ndim - 1, stride = 1; a >= 0; --a) {
    g.stride[a] = stride;
    stride *= shape[a];
  }
  coop_grid::Launch shape_;
  cudaError_t err = coop_grid::launch_shape<jfa_persistent>(THREADS, shape_);
  if (err != cudaSuccess) return (int)err;
  const int n = (int)voxels;
  const int grid = shape_.blocks_per_sm * shape_.sms;
  int* s = (int*)scratch;
  job.seeds = (const int*)seeds;
  job.obj = (const int*)obj;
  job.labels = (int*)labels;
  job.dist = (float*)dist;
  job.list = s;
  job.map = s + n;
  job.state[0] = s + 2LL * n;
  job.state[1] = s + 3LL * n;
  job.flags = s + 4LL * n;
  job.n = n;
  job.n_steps = n_steps;
  for (int k = 0; k < n_steps; ++k) job.steps[k] = steps[k];
  cudaStream_t st = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(job.flags, 0, sizeof(int) * N_FLAGS, st)) != cudaSuccess)
    return (int)err;
  void* args[] = {(void*)&job};
  if ((err = cudaLaunchCooperativeKernel((const void*)jfa_persistent, dim3(grid),
                                         dim3(THREADS), args, 0, st)) != cudaSuccess)
    return (int)err;
  stats[0] = 1;
  stats[2] = grid;
  return (int)cudaGetLastError();
}

}  // extern "C"
