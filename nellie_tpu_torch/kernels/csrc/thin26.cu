// 3D curve thinning by (26,6) simple points, for Hopper (sm_90a).
//
// Replaces nellie_tpu/kernels/skeleton.py::skeletonize_3d (skeleton.py:213-283),
// a lax.while_loop of bit-packed or table-driven simple-point tests over the
// whole volume, and the port's plain body
// (kernels/skeleton.py::skeletonize_3d_plain), which builds each voxel's
// 26-bit neighbourhood code from 26 shifted copies of the volume, gathers
// from the table, shifts the candidates 26 more times for the parity block
// and syncs with the host once a round: some 25,000 small launches and 150
// host reads a 64x256x256 frame.
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
// What bounds it: launches and host reads, not bytes.  A round touches the
// frame's foreground only (4 % of the 3D frame), a few MB, and the table
// lookups hit the 50 MB L2.  So the design cuts the work to a list of the
// frame's starting foreground voxels (the foreground only shrinks; the
// wrapper builds the list) and keeps the loop in the C entry point:
//  * thin_border: remaining = border(d) & deletable, for each listed voxel;
//  * thin_select: del_now = remaining & fg & deletable (reads fg in the
//    3x3x3 box, writes del_now);
//  * thin_commit: reads del_now in the 3x3x3 box and writes fg, remaining
//    and the round's flag where it commits.
// Each kernel writes only buffers that it does not read, so a round needs
// no double buffer: select and commit are two launches.  Dense buffers
// (fg, del_now, remaining, one byte a voxel) keep the neighbour reads
// simple; voxels off the list stay 0 in del_now and remaining.
// The host reads the flags once every `rounds_per_read` rounds: a round
// after one that committed nothing commits nothing and leaves the state as
// it was (remaining becomes del_now, which reproduces itself), so running
// up to rounds_per_read - 1 rounds past the end of a direction changes no
// result.  A direction ends when the last round of a batch committed
// nothing; the sweep changed the volume if any of its rounds committed.
//
// The kernels allocate nothing; the C entry point returns the first CUDA
// error, and counts its rounds, flag reads, sweeps and kernel launches
// (six border passes a sweep and two a round; the flag memsets, one a read,
// are left out) into `stats`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROUNDS_PER_READ = 64;

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

// Bit k of the code is fg at v + OFFSETS_26[k]; out-of-volume voxels are 0.
__device__ __forceinline__ uint32_t code26(const uint8_t* __restrict__ fg, const Volume& g,
                                           int z, int y, int x) {
  uint32_t code = 0;
  int k = 0;
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

__device__ __forceinline__ bool deletable(const uint8_t* __restrict__ fg,
                                          const uint8_t* __restrict__ lut, const Volume& g,
                                          int z, int y, int x) {
  const uint32_t code = code26(fg, g, z, y, x);
  return (__ldg(lut + (code >> 3)) >> (code & 7u)) & 1u;
}

__global__ void thin_border(const int* __restrict__ list, int n, const uint8_t* __restrict__ fg,
                            const uint8_t* __restrict__ lut, uint8_t* __restrict__ remaining,
                            Volume g, int dz, int dy, int dx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v = list[i];
  int z, y, x;
  unflatten(g, v, z, y, x);
  bool cand = fg[v] != 0;
  if (cand) {
    const int zz = z + dz, yy = y + dy, xx = x + dx;
    cand = !(inside(g, zz, yy, xx) && fg[flat(g, zz, yy, xx)]);
  }
  remaining[v] = cand && deletable(fg, lut, g, z, y, x);
}

__global__ void thin_select(const int* __restrict__ list, int n, const uint8_t* __restrict__ fg,
                            const uint8_t* __restrict__ lut,
                            const uint8_t* __restrict__ remaining, uint8_t* __restrict__ del_now,
                            Volume g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v = list[i];
  bool del = remaining[v] && fg[v];
  if (del) {
    int z, y, x;
    unflatten(g, v, z, y, x);
    del = deletable(fg, lut, g, z, y, x);
  }
  del_now[v] = del;
}

__global__ void thin_commit(const int* __restrict__ list, int n,
                            const uint8_t* __restrict__ del_now, uint8_t* __restrict__ fg,
                            uint8_t* __restrict__ remaining, int* __restrict__ flag, Volume g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v = list[i];
  if (!del_now[v]) {
    remaining[v] = 0;
    return;
  }
  int z, y, x;
  unflatten(g, v, z, y, x);
  const int parity = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1);
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
        const int zz = z + dz, yy = y + dy, xx = x + dx;
        if (inside(g, zz, yy, xx) && del_now[flat(g, zz, yy, xx)]) blocked = true;
      }
  if (blocked) {
    remaining[v] = 1;
  } else {
    fg[v] = 0;
    remaining[v] = 0;
    *flag = 1;
  }
}

const int DIRECTIONS[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0}, {0, 1, 0}, {0, 0, -1}, {0, 0, 1}};

}  // namespace

extern "C" {

// Thin the (depth, height, width) volume fg (one byte a voxel, 0 or 1, C
// order) in place.  list: the int32 linear indices of fg's n voxels that are
// set on entry; del_now and remaining: byte scratch of the volume's size,
// zero on entry; flags: int32 device scratch of rounds_per_read values; lut:
// the 2**23-byte table.  stats (host, 4 values): rounds, flag reads, sweeps,
// kernels launched.
int thin26(void* fg, const void* list, int n, void* del_now, void* remaining, void* flags,
           const void* lut, int depth, int height, int width, int rounds_per_read,
           long long* stats, void* stream) {
  const long long voxels = (long long)depth * height * width;
  if (depth < 1 || height < 1 || width < 1 || voxels > 2147483647LL || n < 0 ||
      rounds_per_read < 1 || rounds_per_read > MAX_ROUNDS_PER_READ)
    return (int)cudaErrorInvalidValue;
  stats[0] = stats[1] = stats[2] = stats[3] = 0;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* f = (uint8_t*)fg;
  const int* l = (const int*)list;
  uint8_t* del = (uint8_t*)del_now;
  uint8_t* rem = (uint8_t*)remaining;
  int* flag = (int*)flags;
  const uint8_t* table = (const uint8_t*)lut;
  const Volume g{depth, height, width};
  const int blocks = (n + THREADS - 1) / THREADS;
  int host[MAX_ROUNDS_PER_READ];
  cudaError_t err;
  bool changed = true;
  while (changed) {
    changed = false;
    ++stats[2];
    for (int d = 0; d < 6; ++d) {
      thin_border<<<blocks, THREADS, 0, s>>>(l, n, f, table, rem, g, DIRECTIONS[d][0],
                                             DIRECTIONS[d][1], DIRECTIONS[d][2]);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      ++stats[3];
      bool go = true;
      while (go) {
        if ((err = cudaMemsetAsync(flag, 0, sizeof(int) * rounds_per_read, s)) != cudaSuccess)
          return (int)err;
        for (int r = 0; r < rounds_per_read; ++r) {
          thin_select<<<blocks, THREADS, 0, s>>>(l, n, f, table, rem, del, g);
          thin_commit<<<blocks, THREADS, 0, s>>>(l, n, del, f, rem, flag + r, g);
          if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        }
        stats[0] += rounds_per_read;
        stats[3] += 2 * rounds_per_read;
        if ((err = cudaMemcpyAsync(host, flag, sizeof(int) * rounds_per_read,
                                   cudaMemcpyDeviceToHost, s)) != cudaSuccess)
          return (int)err;
        if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return (int)err;
        ++stats[1];
        for (int r = 0; r < rounds_per_read; ++r) changed = changed || host[r] != 0;
        go = host[rounds_per_read - 1] != 0;
      }
    }
  }
  return (int)cudaSuccess;
}

}  // extern "C"
