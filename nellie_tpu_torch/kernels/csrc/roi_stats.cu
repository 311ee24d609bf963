// Mean and variance of each ROI's nonzero voxels, for Hopper (sm_90a): one
// launch a call.
//
// Replaces nellie_tpu/kernels/moments.py::masked_mean_variance
// (moments.py:111-125), jnp sums over each tracker ROI, and the port's plain
// body (kernels/moments.py::masked_mean_variance_plain), which adds one voxel
// of every ROI per launch: 4,096 launches a call on the 3D main path (ROIs of
// 16^3), 400 on the 2D one (20^2).
//
// What it computes, exactly as the plain body does (built with -fmad=false):
// XLA's CPU code reads a subnormal voxel as zero (denormals are zero), and
// its reduction adds each ROI's voxels one at a time in raster order,
// the sum of x and the sum of x * x, each step a float64 term added to the
// float32 sum and rounded once:
//   acc = __double2float_rn((double)acc + term),  term = x or x * x
// (x * x is exact in float64).  XLA's CPU code flushes subnormal sums to
// zero; the plain body mirrors that by dropping a sum's terms until the
// first whose float32 rounding is at least FLT_MIN, unless the sum is
// already nonzero.  It takes that rule over blocks of 4,096 voxels
// (moments._VOXEL_BLOCK): at a block's start a sum that is nonzero keeps
// every term, one that is zero drops terms until a normal one.  Then
//   mean = flush(total / n),  var = flush(flush(total_sq - flush(flush(total *
//   total) / n)) / n)
// with n the nonzero voxels (1 when there are none) and flush() XLA's
// flush of a subnormal result to a zero of its sign; 0 and 0 for an ROI
// with no nonzero voxel.
//
// What bounds it: the latency of each sum's chain of dependent float64 adds
// (4,096 on the 3D path), not bytes (16 KB an ROI).  What the design does
// about it: every chain runs at once, one thread an (ROI, sum): the two
// threads of an ROI are neighbouring lanes of a warp, which read the same
// voxel and swap their sums with a shuffle at the end.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr long long VOXEL_BLOCK = 4096;  // kernels/moments.py::_VOXEL_BLOCK

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? __fmul_rn(x, 0.f) : x;
}

__global__ void __launch_bounds__(THREADS)
    roi_stats_kernel(const float* images, long long n_roi, long long voxels, float* out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long roi = t >> 1;
  const bool squares = t & 1;
  float acc = 0.f;
  long long count = 0;
  if (roi < n_roi) {
    const float* x = images + roi * voxels;
    bool keep = false;
    for (long long k = 0; k < voxels; ++k) {
      if (k % VOXEL_BLOCK == 0) keep = acc != 0.f;
      const float v = fabsf(x[k]) < FLT_MIN ? 0.f : x[k];
      const double w = (double)v;
      const double term = squares ? __dmul_rn(w, w) : w;
      if (__double2float_rn(term) >= FLT_MIN) keep = true;
      acc = __double2float_rn(__dadd_rn((double)acc, keep ? term : 0.0));
      count += v != 0.f;
    }
  }
  const float total_sq = __shfl_xor_sync(0xffffffffu, acc, 1);
  if (roi >= n_roi || squares) return;
  const float total = acc;
  const float safe = count == 0 ? 1.f : __ll2float_rn(count);
  float mean = flush(__fdiv_rn(total, safe));
  float var = flush(__fdiv_rn(
      flush(__fsub_rn(total_sq, flush(__fdiv_rn(flush(__fmul_rn(total, total)), safe)))), safe));
  if (count == 0) mean = var = 0.f;
  out[2 * roi] = mean;
  out[2 * roi + 1] = var;
}

}  // namespace

extern "C" {

// [mean, variance] of the nonzero voxels of each of n_roi C-contiguous
// float32 ROIs of `voxels` voxels on the device into out (n_roi, 2)
// float32.  kernels (host): the CUDA kernels launched.
int roi_stats(const void* images, long long n_roi, long long voxels, void* out,
              int* kernels, void* stream) {
  *kernels = 0;
  if (n_roi < 0 || voxels < 0) return (int)cudaErrorInvalidValue;
  if (n_roi == 0) return 0;
  const long long threads = 2 * n_roi;
  const long long grid = (threads + THREADS - 1) / THREADS;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  roi_stats_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)images, n_roi, voxels, (float*)out);
  *kernels = 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
