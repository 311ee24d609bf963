// 3D curve thinning by (26,6) simple points, for Hopper (sm_90a): one
// persistent cooperative kernel a call.
//
// Replaces nellie_tpu/kernels/skeleton.py::skeletonize_3d (skeleton.py:213-283),
// a lax.while_loop of bit-packed or table-driven simple-point tests over the
// whole volume, and the port's plain body
// (kernels/skeleton.py::skeletonize_3d_plain), which builds each voxel's
// 26-bit neighbourhood code from 26 shifted copies of the volume, gathers
// from the table, shifts the candidates 26 more times for the parity block
// and syncs with the host once a round.
//
// What it computes, exactly as the plain body does.  The outer loop runs six
// border directions in order until a whole sweep deletes nothing.  For
// direction d the candidates are the border voxels fg & ~fg(v + d) (outside
// the volume counts as background) that are deletable; then rounds run
//   del_now  = deletable(fg) & remaining
//   blocked  = some 26-neighbour u with del_now(u) and parity(u) < parity(v)
//   commit   = del_now & ~blocked;  fg &= ~commit;  remaining = del_now & ~commit
// until a round commits nothing.  parity = (z%2)*4 + (y%2)*2 + x%2, and a
// neighbour at offset o has parity ^ ((|oz|%2)<<2 | (|oy|%2)<<1 | |ox|%2).
// Deletability is bit (code & 7) of byte (code >> 3) of the port's 8 MiB
// table (kernels/simple_point.py, _simple26_lut.xz), where bit k of the
// code is the voxel at v + OFFSETS_26[k], raster order over (dz, dy, dx)
// with the centre left out; out-of-volume neighbours are 0.
//
// What bounds it: the latency of its phases, not bytes.  A round touches
// the frame's foreground only (47,352 voxels of the 3D main path's
// 64x256x256 frame) and the table lookups hit the 50 MB L2, so a phase is a
// few microseconds of dependent loads.  What the design does about it: the
// whole loop, every sweep, direction and round, is one cooperative launch
// (cudaLaunchCooperativeKernel; at most one block of THREADS an SM, a grid
// stride over the list of the starting foreground, which only shrinks), and
// its phases are separated by grid barriers (coop_grid.cuh: a counter that
// only grows, with release and acquire at GPU scope) in place of kernel boundaries and
// host reads.  The set of voxels a round still has to decide (the plain
// body's `remaining`) is kept as a list, so that a phase's threads walk only
// those voxels:
//  * border: the direction's candidates, border(d) & deletable, appended to
//    a work list (an atomic counter);
//  * select: del_now = fg & deletable over the round's work list (reads fg
//    in the 3x3x3 box, writes del_now);
//  * commit: reads del_now in the 3x3x3 box; a voxel with no deleting
//    neighbour of lower parity clears fg and sets the round's commit flag,
//    a blocked one is appended to the next round's work list.
// Each phase writes only buffers that it does not read, so a round is two
// phases and two barriers.  The lists use three buffers in turn (list k in
// buffer k % 3): the phase that writes list k reads list k - 1 and clears
// del_now where list k - 2 committed, and it zeroes the length of the
// buffer that list k + 1 will use, which every thread read before the last
// barrier.  The commit flags alternate the same way, so after a round's
// second barrier every thread reads the same flag and the whole grid leaves
// the direction at exactly the round that commits nothing (no round past
// the end), knowing whether the sweep changed the volume.  Once a round
// leaves at most BLOCK_WORK voxels to decide (or the border finds no more),
// block 0 runs the direction's remaining rounds alone with block barriers
// while the other blocks wait at the direction's last grid barrier: most
// rounds after the first leave a few blocked voxels.  fg, del_now, the
// lists and the flags are written inside the kernel, so they are read
// through the coherent path (no __ldg, no const __restrict__); only the
// table and the starting list take the read-only path.
//
// The kernel allocates nothing.  The C entry point clears the flags,
// launches the kernel once, reads its counts (rounds, sweeps) back in one
// copy and returns the first CUDA error; stats: rounds, host reads, sweeps,
// kernels launched.

#include <cuda_runtime.h>
#include <stdint.h>

#include "coop_grid.cuh"

namespace {

constexpr int THREADS = 512;

struct Volume {
  int depth, height, width;
};

__device__ __forceinline__ bool inside(const Volume& g, int z, int y, int x) {
  return (unsigned)z < (unsigned)g.depth && (unsigned)y < (unsigned)g.height &&
         (unsigned)x < (unsigned)g.width;
}

__device__ __forceinline__ int flat(const Volume& g, int z, int y, int x) {
  return (z * g.height + y) * g.width + x;
}

__device__ __forceinline__ void unflatten(const Volume& g, int v, int& z, int& y, int& x) {
  const int plane = g.height * g.width;
  z = v / plane;
  const int r = v - z * plane;
  y = r / g.width;
  x = r - y * g.width;
}

__device__ __forceinline__ bool interior(const Volume& g, int z, int y, int x) {
  return z > 0 && y > 0 && x > 0 && z < g.depth - 1 && y < g.height - 1 && x < g.width - 1;
}

// Bit k of the code is fg at v + OFFSETS_26[k]; out-of-volume voxels are 0.
// Away from the volume's faces every neighbour is read with no test, so
// the 26 loads issue together.
__device__ __forceinline__ uint32_t code26(const uint8_t* fg, const Volume& g, int z, int y,
                                           int x) {
  uint32_t code = 0;
  int k = 0;
  if (interior(g, z, y, x)) {
    const uint8_t* c = fg + flat(g, z, y, x);
    const int plane = g.height * g.width;
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dz == 0 && dy == 0 && dx == 0) continue;
          code |= (uint32_t)(c[dz * plane + dy * g.width + dx] != 0) << k;
          ++k;
        }
    return code;
  }
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && dy == 0 && dx == 0) continue;
        const int zz = z + dz, yy = y + dy, xx = x + dx;
        if (inside(g, zz, yy, xx) && fg[flat(g, zz, yy, xx)]) code |= 1u << k;
        ++k;
      }
  return code;
}

__device__ __forceinline__ bool deletable(const uint8_t* fg, const uint8_t* __restrict__ lut,
                                          const Volume& g, int z, int y, int x) {
  const uint32_t code = code26(fg, g, z, y, x);
  return (__ldg(lut + (code >> 3)) >> (code & 7u)) & 1u;
}

__device__ __forceinline__ bool blocked_by_lower(const uint8_t* del_now, const Volume& g, int z,
                                                 int y, int x) {
  const int parity = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1);
  const bool in = interior(g, z, y, x);
  const uint8_t* c = del_now + flat(g, z, y, x);
  const int plane = g.height * g.width;
  bool blocked = false;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && dy == 0 && dx == 0) continue;
        const int flip = ((dz & 1) << 2) | ((dy & 1) << 1) | (dx & 1);
        if ((parity ^ flip) >= parity) continue;
        if (in || inside(g, z + dz, y + dy, x + dx))
          blocked |= c[dz * plane + dy * g.width + dx] != 0;
      }
  return blocked;
}

__constant__ int DIRECTIONS[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                   {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};

// The state between phases.  fg and del_now are indexed by voxel
// (neighbours read them); del_now is 0 on entry, is set by a select phase
// for the voxels of its work list, and is cleared again for those that
// commit (in the next select phase) and for the last round's (when its
// direction ends).  The work lists are lists of voxels in three buffers
// used in turn: list k (the candidates of a direction's border phase, or
// the voxels a round left blocked) goes to buffer k % 3, so the phase that
// writes list k reads list k - 1 and clears del_now from list k - 2.
struct State {
  const int* list;  // the starting foreground, n voxels
  int n;
  uint8_t* fg;
  uint8_t* del_now;
  int* work[3];  // n voxels each
  int* flags;    // see FLAG_*
  const uint8_t* lut;
  Volume g;
};

// flags: the lists' lengths by buffer, the rounds' commit flags by the
// parity of the list they write, the barrier's counter, the counts read
// back (rounds and lists also passed from block 0 to the others), and
// block 0's answer to "did the direction commit"
constexpr int FLAG_COUNT = 0, FLAG_COMMIT = 3, FLAG_BARRIER = 5, FLAG_ROUNDS = 6,
              FLAG_SWEEPS = 7, FLAG_BLOCK = 8, FLAG_LISTS = 9, N_FLAGS = 12;
// once a round has at most this many voxels to decide, block 0 runs the
// direction's remaining rounds alone, with block barriers
constexpr int BLOCK_WORK = THREADS;

// select: del_now = fg & deletable for a voxel of the round's work list
__device__ __forceinline__ void select_one(const State& st, int v) {
  bool del = st.fg[v] != 0;
  if (del) {
    int z, y, x;
    unflatten(st.g, v, z, y, x);
    del = deletable(st.fg, st.lut, st.g, z, y, x);
  }
  st.del_now[v] = del;
}

// commit: 1 where the voxel commits, 2 where a lower-parity neighbour
// blocks it (it stays for the next round), 0 where it is not deleted
__device__ __forceinline__ int commit_one(const State& st, int v) {
  if (!st.del_now[v]) return 0;
  int z, y, x;
  unflatten(st.g, v, z, y, x);
  if (blocked_by_lower(st.del_now, st.g, z, y, x)) return 2;
  st.fg[v] = 0;
  return 1;
}

// A round: select over list k - 1 (m voxels) clearing del_now where list
// k - 2 (m_old voxels) committed, a barrier, commit appending the blocked
// voxels to list k, a barrier.  Returns whether the round committed; m and
// m_old move on to the new lists.
template <bool GRID>
__device__ __forceinline__ bool run_round(const State& st, int k, int& m, int& m_old,
                                          int first, int stride, bool leader,
                                          unsigned int* counter, unsigned int& target) {
  volatile int* flags = st.flags;
  const int* work = st.work[(k + 2) % 3];
  const int* old = st.work[(k + 1) % 3];
  int* next = st.work[k % 3];
  for (int i = first; i < m; i += stride) select_one(st, work[i]);
  for (int i = first; i < m_old; i += stride) {
    const int v = old[i];
    if (!st.fg[v]) st.del_now[v] = 0;  // committed last round
  }
  // list k + 1's buffer held list k - 2, read before the last barrier
  if (leader) {
    flags[FLAG_COMMIT + (k & 1)] = 0;
    flags[FLAG_COUNT + (k + 1) % 3] = 0;
  }
  bool mine = false;
  if (GRID)
    coop_grid::barrier(counter, target);
  else
    __syncthreads();
  for (int i = first; i < m; i += stride) {
    const int v = work[i];
    const int r = commit_one(st, v);
    if (r == 2) next[atomicAdd(st.flags + FLAG_COUNT + k % 3, 1)] = v;
    mine |= r == 1;
  }
  bool any;
  if (GRID) {
    if (mine) flags[FLAG_COMMIT + (k & 1)] = 1;
    coop_grid::barrier(counter, target);
    any = flags[FLAG_COMMIT + (k & 1)] != 0;
  } else {
    any = __syncthreads_or(mine) != 0;
  }
  m_old = m;
  m = flags[FLAG_COUNT + k % 3];
  return any;
}

__global__ void __launch_bounds__(THREADS)
thin_persistent(State st) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const bool leader = first == 0;
  volatile int* flags = st.flags;
  unsigned int* counter = (unsigned int*)(st.flags + FLAG_BARRIER);
  unsigned int target = 0;
  int round = 0, sweeps = 0, k = 0;  // k: the next list to write
  bool changed = true;
  while (changed) {
    changed = false;
    ++sweeps;
    for (int d = 0; d < 6; ++d) {
      const int ddz = DIRECTIONS[d][0], ddy = DIRECTIONS[d][1], ddx = DIRECTIONS[d][2];
      // border: the direction's candidates, list k
      int* cand_list = st.work[k % 3];
      for (int i = first; i < st.n; i += stride) {
        const int v = __ldg(st.list + i);
        int z, y, x;
        unflatten(st.g, v, z, y, x);
        bool cand = st.fg[v] != 0;
        if (cand) {
          const int zz = z + ddz, yy = y + ddy, xx = x + ddx;
          cand = !(inside(st.g, zz, yy, xx) && st.fg[flat(st.g, zz, yy, xx)]);
        }
        if (cand && deletable(st.fg, st.lut, st.g, z, y, x))
          cand_list[atomicAdd(st.flags + FLAG_COUNT + k % 3, 1)] = v;
      }
      if (leader) flags[FLAG_COUNT + (k + 1) % 3] = 0;  // held list k - 2
      coop_grid::barrier(counter, target);
      int m = flags[FLAG_COUNT + k % 3], m_old = 0;
      ++k;
      bool any = false, go = true;
      while (go && m > BLOCK_WORK) {
        go = run_round<true>(st, k, m, m_old, first, stride, leader, counter, target);
        any = any || go;
        ++round;
        ++k;
      }
      if (go) {
        // block 0 runs the direction's remaining rounds; the others wait
        if (blockIdx.x == 0) {
          while (go) {
            go = run_round<false>(st, k, m, m_old, threadIdx.x, blockDim.x, threadIdx.x == 0,
                                  counter, target);
            any = any || go;
            ++round;
            ++k;
          }
          const int* last = st.work[(k + 1) % 3];
          for (int i = threadIdx.x; i < m_old; i += blockDim.x) st.del_now[last[i]] = 0;
          if (threadIdx.x == 0) {
            flags[FLAG_BLOCK] = any;
            flags[FLAG_ROUNDS] = round;
            flags[FLAG_LISTS] = k;
          }
        }
        coop_grid::barrier(counter, target);
        any = flags[FLAG_BLOCK] != 0;
        round = flags[FLAG_ROUNDS];
        k = flags[FLAG_LISTS];
      } else {
        // the last round's list; the next border phase reads no del_now
        // and its barrier orders these
        const int* last = st.work[(k + 1) % 3];
        for (int i = first; i < m_old; i += stride) st.del_now[last[i]] = 0;
      }
      changed = changed || any;
    }
  }
  if (leader) {
    flags[FLAG_ROUNDS] = round;
    flags[FLAG_SWEEPS] = sweeps;
  }
}

}  // namespace

extern "C" {

// Thin the (depth, height, width) volume fg (one byte a voxel, 0 or 1, C
// order) in place.  list: the int32 linear indices of fg's n voxels that are
// set on entry; del_now: byte scratch of the volume's size, zero on entry;
// scratch: thin26_scratch_bytes(n) bytes of device scratch, 4-byte aligned;
// lut: the 2**23-byte table.  stats (host, 4 values): rounds, host reads,
// sweeps, kernels launched.
long long thin26_scratch_bytes(int n) { return 4LL * (N_FLAGS + 3LL * n); }

int thin26(void* fg, const void* list, int n, void* del_now, void* scratch, const void* lut,
           int depth, int height, int width, long long* stats, void* stream) {
  const long long voxels = (long long)depth * height * width;
  if (depth < 1 || height < 1 || width < 1 || voxels > 2147483647LL || n < 0 || n > voxels)
    return (int)cudaErrorInvalidValue;
  stats[0] = stats[1] = stats[2] = stats[3] = 0;
  if (n == 0) return (int)cudaSuccess;
  coop_grid::Launch shape;
  cudaError_t err = coop_grid::launch_shape<thin_persistent>(THREADS, shape);
  if (err != cudaSuccess) return (int)err;
  // at most one block an SM, and no more than the list fills: a barrier
  // waits on fewer blocks, and a thread holds one voxel of a phase or a few
  const long long need = ((long long)n + THREADS - 1) / THREADS;
  const int grid = (int)(need < shape.sms ? need : shape.sms);
  cudaStream_t s = (cudaStream_t)stream;
  State st;
  st.list = (const int*)list;
  st.n = n;
  st.fg = (uint8_t*)fg;
  st.del_now = (uint8_t*)del_now;
  st.flags = (int*)scratch;
  for (int b = 0; b < 3; ++b) st.work[b] = st.flags + N_FLAGS + (long long)b * n;
  st.lut = (const uint8_t*)lut;
  st.g = Volume{depth, height, width};
  if ((err = cudaMemsetAsync(st.flags, 0, sizeof(int) * N_FLAGS, s)) != cudaSuccess)
    return (int)err;
  void* args[] = {(void*)&st};
  if ((err = cudaLaunchCooperativeKernel((const void*)thin_persistent, dim3(grid),
                                         dim3(THREADS), args, 0, s)) != cudaSuccess)
    return (int)err;
  stats[3] = 1;
  int host[N_FLAGS];
  if ((err = cudaMemcpyAsync(host, st.flags, sizeof(host), cudaMemcpyDeviceToHost, s)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return (int)err;
  stats[0] = host[FLAG_ROUNDS];
  stats[1] = 1;
  stats[2] = host[FLAG_SWEEPS];
  return (int)cudaSuccess;
}

}  // extern "C"
