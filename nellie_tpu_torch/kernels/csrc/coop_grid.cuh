// The grid barrier and the launch shape of a persistent cooperative kernel,
// shared by thin26.cu, nearest_seed.cu, thin2d.cu and masked_percentile.cu.
//
// A cooperative launch keeps every block resident, so blocks may wait for
// each other.  The barrier is a counter that only grows: each block adds
// one when it arrives (the block's writes, ordered before its first thread
// by the block barrier, released at GPU scope) and waits until the counter
// reaches the barrier's target (acquired at GPU scope, then handed to the
// block's threads by the block barrier), so that every write before the
// barrier is seen by every block after it.  Work that reads nothing the
// other blocks write before the barrier may run between the two halves.
// The counter is one word of the caller's scratch, zero at launch; each
// thread keeps the running target (0 at launch) and passes it to every
// barrier of the launch in order.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace coop_grid {

__device__ __forceinline__ void arrive(unsigned int* counter, unsigned int& target,
                                       unsigned int blocks) {
  target += blocks;
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> c(*counter);
    c.fetch_add(1u, cuda::memory_order_release);
  }
}

__device__ __forceinline__ void wait(unsigned int* counter, unsigned int target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> c(*counter);
    while (c.load(cuda::memory_order_acquire) < target) {
    }
  }
  __syncthreads();
}

// The barrier of `blocks` blocks (every block of the grid unless fewer take
// part, each of them calling it).
__device__ __forceinline__ void barrier(unsigned int* counter, unsigned int& target,
                                        unsigned int blocks) {
  arrive(counter, target, blocks);
  wait(counter, target);
}

__device__ __forceinline__ void barrier(unsigned int* counter, unsigned int& target) {
  barrier(counter, target, gridDim.x);
}

constexpr int MAX_DEVICES = 64;

struct Launch {
  int blocks_per_sm = 0, sms = 0;
};

// The blocks of `threads` threads (no dynamic shared memory) that a
// multiprocessor holds of Kernel, and the multiprocessors, asked once per
// device and kernel; cudaErrorCooperativeLaunchTooLarge where the device
// takes no cooperative launch or no block.
template <auto Kernel>
cudaError_t launch_shape(int threads, Launch& out) {
  static Launch cache[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && cache[device].blocks_per_sm > 0) {
    out = cache[device];
    return cudaSuccess;
  }
  Launch l;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.blocks_per_sm, Kernel, threads,
                                                           0)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  int coop = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop || l.blocks_per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (cached) cache[device] = l;
  out = l;
  return cudaSuccess;
}

}  // namespace coop_grid
