// 2D Zhang–Suen thinning, for Hopper (sm_90a): a memset and one persistent
// cooperative kernel a call, no host read.
//
// Replaces nellie_tpu/kernels/skeleton.py::skeletonize_2d (skeleton.py:311,
// its pass _zs_pass at :294), a lax.while_loop of eight shifted copies of
// the frame a subiteration, and the port's plain body
// (kernels/skeleton.py::skeletonize_2d_plain), which shifts the frame eight
// times a subiteration, about 75 CUDA kernels, and reads the host once a
// pass to compare the frame with the one before.
//
// What it computes, exactly as the plain body does.  A pass runs
// subiteration 1, then subiteration 2; each decides every pixel from the
// state before it, with the 8 neighbours P2..P9 clockwise from north
// (skeleton.py _P_OFFS) and pixels outside the frame as background, and
// deletes a set pixel where 2 <= B <= 6 (B the set neighbours), A == 1 (A
// the 0 -> 1 steps around P2, P3, ..., P9, P2) and the two products are 0:
// P2 P4 P6 and P4 P6 P8 in subiteration 1, P2 P4 P8 and P2 P6 P8 in
// subiteration 2.  The loop ends after the first pass that deletes nothing.
//
// What bounds it: the latency of its subiterations, not bytes.  The 2D
// path's frame is 1024 x 1024 at about 8 % foreground; a subiteration
// touches the foreground only (8 neighbour bytes a pixel, in the L2), a few
// microseconds of dependent loads.  What the design does about it:
//  * the whole loop is one cooperative launch (at most one block of THREADS
//    an SM), its subiterations separated by grid barriers (a counter that
//    only grows, with release and acquire at GPU scope: coop_grid.cuh), in
//    place of kernel boundaries and host reads;
//  * phase 0 copies the mask into two byte frames and lists its set pixels
//    (one atomic a warp on the list's length), so a subiteration walks the
//    list only; the list's length never goes back to the host;
//  * the two frames are used in turn: subiteration 1 reads frame 0 and
//    writes frame 1, subiteration 2 reads frame 1 and writes frame 0, each
//    listed pixel's new state (0 too, so that a pixel deleted in one
//    subiteration is cleared in the other frame by the next), so a
//    decision never reads a commit of its own subiteration and one barrier
//    a subiteration suffices; the result is frame 0;
//  * a pass's "deleted something" flag alternates between two words by the
//    pass's parity: set during pass p in word p & 1, read by every thread
//    after pass p's last barrier, and cleared for pass p + 1 during pass p's
//    second subiteration, after every thread has read it for pass p - 1.
//
// The kernel allocates nothing.  The C entry point clears the flags,
// launches the kernel once and reads nothing back; the pass count stays on
// the card (scratch word FLAG_PASSES).

#include <cuda_runtime.h>
#include <stdint.h>

#include "coop_grid.cuh"

namespace {

constexpr int THREADS = 512;

// scratch words: the two pass flags, the barrier's counter, the list's
// length, the passes run; the list follows
constexpr int FLAG_DELETED = 0, FLAG_BARRIER = 2, FLAG_COUNT = 3, FLAG_PASSES = 4,
              N_FLAGS = 8;

// The 8 neighbours as bits: bit k is P(k + 2), P2 north, then clockwise.
__device__ __forceinline__ unsigned neighbours(const uint8_t* f, int h, int w, int y, int x) {
  const int dy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  const int dx[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  unsigned code = 0;
  const uint8_t* c = f + (long long)y * w + x;
  if (y > 0 && x > 0 && y < h - 1 && x < w - 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) code |= (unsigned)(c[dy[k] * w + dx[k]] != 0) << k;
    return code;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int yy = y + dy[k], xx = x + dx[k];
    if ((unsigned)yy < (unsigned)h && (unsigned)xx < (unsigned)w && c[dy[k] * w + dx[k]])
      code |= 1u << k;
  }
  return code;
}

// Zhang–Suen's test on a set pixel's neighbour bits.
__device__ __forceinline__ bool deletes(unsigned code, bool first) {
  const int b = __popc(code);
  const unsigned next = (code >> 1) | ((code & 1u) << 7);  // bit k: P(k + 3), P9 -> P2
  const int a = __popc(~code & next & 0xFFu);
  const bool p2 = code & 1u, p4 = code & 4u, p6 = code & 16u, p8 = code & 64u;
  const bool c1 = first ? !(p2 && p4 && p6) : !(p2 && p4 && p8);
  const bool c2 = first ? !(p4 && p6 && p8) : !(p2 && p6 && p8);
  return b >= 2 && b <= 6 && a == 1 && c1 && c2;
}

struct State {
  const uint8_t* mask;
  uint8_t* frame[2];  // frame 0 is the result
  int* flags;
  int* list;
  int height, width;
};

__global__ void __launch_bounds__(THREADS) thin_zhang_suen(State st) {
  const long long n = (long long)st.height * st.width;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  volatile int* flags = st.flags;
  unsigned int* counter = (unsigned int*)(st.flags + FLAG_BARRIER);
  unsigned int target = 0;
  // phase 0: both frames from the mask, the set pixels listed; the loop's
  // bound is warp-uniform so that every lane takes part in the ballot
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n;
       base += stride) {
    const long long v = base + lane;
    const bool set = v < n && st.mask[v] != 0;
    if (v < n) {
      st.frame[0][v] = set;
      st.frame[1][v] = set;
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, set);
    if (ballot) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(st.flags + FLAG_COUNT, __popc(ballot));
      slot = __shfl_sync(0xFFFFFFFFu, slot, 0);
      if (set) st.list[slot + __popc(ballot & ((1u << lane) - 1u))] = (int)v;
    }
  }
  coop_grid::barrier(counter, target);
  const int m = flags[FLAG_COUNT];
  int pass = 0;
  while (true) {
    for (int sub = 0; sub < 2; ++sub) {
      const uint8_t* src = st.frame[sub];
      uint8_t* dst = st.frame[sub ^ 1];
      bool mine = false;
      for (int i = first; i < m; i += stride) {
        const int v = st.list[i];
        // a pixel deleted last subiteration is still set in dst: clear it
        const bool set = src[v] != 0;
        bool del = false;
        if (set) {
          const int y = v / st.width, x = v - y * st.width;
          del = deletes(neighbours(src, st.height, st.width, y, x), sub == 0);
        }
        dst[v] = set && !del;
        mine |= del;
      }
      if (mine) flags[FLAG_DELETED + (pass & 1)] = 1;
      // every thread read the other word after pass - 1's last barrier
      if (sub == 1 && first == 0) flags[FLAG_DELETED + ((pass + 1) & 1)] = 0;
      coop_grid::barrier(counter, target);
    }
    ++pass;
    if (!flags[FLAG_DELETED + ((pass - 1) & 1)]) break;
  }
  if (first == 0) flags[FLAG_PASSES] = pass;
}

}  // namespace

extern "C" {

// Bytes of device scratch for a (height, width) frame: the flags, the list,
// the second frame.
long long thin2d_scratch_bytes(int height, int width) {
  const long long n = (long long)height * width;
  return 4LL * (N_FLAGS + n) + n;
}

// Thin the (height, width) mask (one byte a pixel, 0 or not, C order) into
// out (one byte a pixel, 0 or 1).  scratch: thin2d_scratch_bytes bytes,
// 4-byte aligned.  kernels (host): the CUDA kernels launched (the memset
// and the kernel).
int thin2d(const void* mask, void* out, void* scratch, int height, int width, int* kernels,
           void* stream) {
  *kernels = 0;
  const long long n = (long long)height * width;
  if (height < 1 || width < 1 || n > 2147483647LL || (uintptr_t)scratch % 4)
    return (int)cudaErrorInvalidValue;
  coop_grid::Launch shape;
  cudaError_t err = coop_grid::launch_shape<thin_zhang_suen>(THREADS, shape);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n + THREADS - 1) / THREADS;
  const int grid = (int)(need < shape.sms ? need : shape.sms);
  cudaStream_t s = (cudaStream_t)stream;
  State st;
  st.mask = (const uint8_t*)mask;
  st.flags = (int*)scratch;
  st.list = st.flags + N_FLAGS;
  st.frame[0] = (uint8_t*)out;
  st.frame[1] = (uint8_t*)(st.list + n);
  st.height = height;
  st.width = width;
  if ((err = cudaMemsetAsync(st.flags, 0, sizeof(int) * N_FLAGS, s)) != cudaSuccess)
    return (int)err;
  *kernels = 1;
  void* args[] = {(void*)&st};
  if ((err = cudaLaunchCooperativeKernel((const void*)thin_zhang_suen, dim3(grid),
                                         dim3(THREADS), args, 0, s)) != cudaSuccess)
    return (int)err;
  *kernels = 2;
  return (int)cudaSuccess;
}

}  // extern "C"
