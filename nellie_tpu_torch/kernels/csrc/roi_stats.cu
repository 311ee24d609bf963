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
// (x * x is exact in float64).  For the sum of x that is fl32(fl64(acc + x))
// with acc and x float32, and since 53 >= 2 * 24 + 2 the double rounding
// equals one rounding (Figueroa): the chain is __fadd_rn(acc, x).  The sum
// of squares keeps the float64 add.  XLA's CPU code flushes subnormal sums
// to zero; the plain body mirrors that by dropping a sum's terms until the
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
// What bounds it: the latency of the sum of squares' chain of dependent
// steps (convert, float64 add, round: 4,096 on the 3D path), not bytes (16
// KB an ROI).  roi_chain_floor runs one such chain alone out of shared
// memory, so that its time can be measured.  What the design does about it:
//  * every ROI's chains run at once, one lane an ROI, both sums and the
//    count in one thread (the sum of x and the count are off the chain);
//  * a block is one warp that takes a few ROIs (the ROIs over the SMs, so
//    that one wave holds them all) and streams them through shared memory
//    in chunks of at most CHUNK voxels: each lane's chunk is one bulk copy
//    (cp.async.bulk, the TMA) completing on the stage's mbarrier, in two
//    stages, so that the next chunk's copy overlaps the current chains; an
//    ROI larger than a chunk (than shared memory) passes in several, and
//    the voxel index, not the chunk, carries the 4,096-voxel rule;
//  * a bulk copy takes 16-byte aligned addresses and sizes: an ROI whose
//    chunk starts or ends off 16 bytes (ROI k starts at k * voxels * 4
//    bytes) copies its aligned middle in bulk, placed so that it lands
//    16-byte aligned, and its lane loads the up to 3 voxels before and
//    after it itself.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int STAGES = 2;
constexpr int MAX_ROIS = 12;           // lanes of a block that take an ROI
constexpr long long CHUNK = 1024;      // voxels of an ROI in one stage, at most
constexpr long long VOXEL_BLOCK = 4096;  // kernels/moments.py::_VOXEL_BLOCK
constexpr int FLOOR_VOXELS = 12288;    // roi_chain_floor's shared memory: 48 KB

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? __fmul_rn(x, 0.f) : x;
}

// a voxel as XLA's CPU code reads it: subnormal as zero
__device__ __forceinline__ float voxel(float x) { return fabsf(x) < FLT_MIN ? 0.f : x; }

// The two sums and the count over x[0, len), the voxels k0, k0 + 1, ...:
// the sum of x in float32 adds (fl32(acc + v) is fl32(fl64(acc + v))), the
// sum of squares as a float64 add rounded to float32, whose chain of
// convert, add and round sets the time.  A block of 4,096 voxels starts at
// k0 or not at all inside the run.
__device__ __forceinline__ void sums_run(float& acc, float& acc_sq, bool& keep, bool& keep_sq,
                                         long long& count, long long k0, const float* x,
                                         long long len) {
  if ((k0 & (VOXEL_BLOCK - 1)) == 0) {
    keep = acc != 0.f;
    keep_sq = acc_sq != 0.f;
  }
#pragma unroll 4
  for (long long j = 0; j < len; ++j) {
    const float v = voxel(x[j]);
    keep = keep || v >= FLT_MIN;
    acc = __fadd_rn(acc, keep ? v : 0.f);
    const double w = (double)v;
    const double term = __dmul_rn(w, w);
    keep_sq = keep_sq || __double2float_rn(term) >= FLT_MIN;
    acc_sq = __double2float_rn(__dadd_rn((double)acc_sq, keep_sq ? term : 0.0));
    count += v != 0.f;
  }
}

__device__ __forceinline__ unsigned int smem(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void barrier_init(unsigned long long* bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void barrier_arrive(unsigned long long* bar, unsigned int bytes) {
  if (bytes)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void barrier_wait(unsigned long long* bar, unsigned int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Stage one lane's chunk: voxels [0, len) of src into buf from buf[shift]
// on, where shift puts the chunk's first 16-byte aligned voxel on a 16-byte
// boundary of buf; the aligned middle by one bulk copy on bar (the lane's
// arrival carries its bytes), the voxels around it by the lane.  Returns
// shift.
__device__ int stage_chunk(float* buf, const float* src, long long len, unsigned long long* bar,
                           bool active) {
  if (!active) {
    barrier_arrive(bar, 0);
    return 0;
  }
  const int lead = (int)((16 - (uintptr_t)src % 16) % 16 / 4);  // voxels before 16 bytes
  const int shift = (4 - lead) % 4;
  const long long head = lead < len ? lead : len;
  const long long body = (len - head) / 4 * 4;
  barrier_arrive(bar, (unsigned int)(4 * body));
  if (body) bulk_copy(buf + shift + head, src + head, (unsigned int)(4 * body), bar);
  for (long long j = 0; j < head; ++j) buf[shift + j] = src[j];
  for (long long j = head + body; j < len; ++j) buf[shift + j] = src[j];
  return shift;
}

// One warp a block, lane l the ROI blockIdx.x * per_block + l (l <
// per_block); stage: STAGES x per_block buffers of lane_floats floats.
__global__ void __launch_bounds__(LANES)
    roi_stats_kernel(const float* images, long long n_roi, long long voxels, int per_block,
                     long long chunk, int lane_floats, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ __align__(8) unsigned long long full[STAGES];
  const int lane = threadIdx.x;
  const long long roi = (long long)blockIdx.x * per_block + lane;
  const bool active = lane < per_block && roi < n_roi;
  const float* src = images + (active ? roi * voxels : 0);
  const long long chunks = (voxels + chunk - 1) / chunk;
  if (lane == 0)
    for (int s = 0; s < STAGES; ++s) barrier_init(full + s, LANES);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();
  auto buffer = [&](long long c) { return stage + ((c % STAGES) * per_block + lane) * lane_floats; };
  auto length = [&](long long c) { return c * chunk + chunk < voxels ? chunk : voxels - c * chunk; };
  int shift[STAGES] = {0, 0};
  for (long long c = 0; c < STAGES && c < chunks; ++c)
    shift[c] = stage_chunk(buffer(c), src + c * chunk, length(c), full + c, active);
  float acc = 0.f, acc_sq = 0.f;
  bool keep = false, keep_sq = false;
  long long count = 0;
  for (long long c = 0; c < chunks; ++c) {
    const int s = (int)(c % STAGES);
    barrier_wait(full + s, (unsigned int)((c / STAGES) & 1));
    if (active) {
      // a chunk divides 4,096 or is the whole ROI: blocks start at chunks
      const float* x = buffer(c) + (s == 0 ? shift[0] : shift[1]);
      sums_run(acc, acc_sq, keep, keep_sq, count, c * chunk, x, length(c));
    }
    __syncwarp();
    if (c + STAGES < chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // reads before the copy
      const int sh = stage_chunk(buffer(c), src + (c + STAGES) * chunk, length(c + STAGES),
                                 full + s, active);
      if (s == 0)
        shift[0] = sh;
      else
        shift[1] = sh;
    }
  }
  if (!active) return;
  const float safe = count == 0 ? 1.f : __ll2float_rn(count);
  float mean = flush(__fdiv_rn(acc, safe));
  float var = flush(__fdiv_rn(
      flush(__fsub_rn(acc_sq, flush(__fdiv_rn(flush(__fmul_rn(acc, acc)), safe)))), safe));
  if (count == 0) mean = var = 0.f;
  out[2 * roi] = mean;
  out[2 * roi + 1] = var;
}

// One thread's sum of squares over x[0, voxels) out of shared memory.
__global__ void chain_floor_kernel(const float* x, long long voxels, float* out) {
  __shared__ float buf[FLOOR_VOXELS];
  for (long long k = threadIdx.x; k < voxels; k += blockDim.x) buf[k] = voxel(x[k]);
  __syncthreads();
  if (threadIdx.x != 0) return;
  float acc = 0.f;
  bool keep = false;
  for (long long k0 = 0; k0 < voxels; k0 += VOXEL_BLOCK) {
    keep = acc != 0.f;
    for (long long k = k0; k < voxels && k < k0 + VOXEL_BLOCK; ++k) {
      const double w = (double)buf[k];
      const double term = __dmul_rn(w, w);
      keep = keep || __double2float_rn(term) >= FLT_MIN;
      acc = __double2float_rn(__dadd_rn((double)acc, keep ? term : 0.0));
    }
  }
  out[0] = acc;
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
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  long long per_block = (n_roi + sms - 1) / sms;
  if (per_block > MAX_ROIS) per_block = MAX_ROIS;
  const long long grid = (n_roi + per_block - 1) / per_block;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long chunk = voxels < CHUNK ? (voxels < 1 ? 1 : voxels) : CHUNK;
  const int lane_floats = (int)((chunk + 3) / 4 * 4 + 4);  // + the shift, 16-byte rows
  const size_t shared = sizeof(float) * STAGES * per_block * lane_floats;
  // the kernel's shared memory limit, raised once a device as far as a call needs
  static int allowed[64] = {0};
  if (device >= 64 || (int)shared > allowed[device]) {
    if ((err = cudaFuncSetAttribute(roi_stats_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) !=
        cudaSuccess)
      return (int)err;
    if (device < 64) allowed[device] = (int)shared;
  }
  roi_stats_kernel<<<(unsigned)grid, LANES, shared, (cudaStream_t)stream>>>(
      (const float*)images, n_roi, voxels, (int)per_block, chunk, lane_floats, (float*)out);
  *kernels = 1;
  return (int)cudaGetLastError();
}

// The sum of squares of x[0, voxels) (float32 on the device, voxels at
// most 12,288) by one thread out of shared memory, into out[0]: the chain
// that bounds roi_stats, run alone to measure it.
int roi_chain_floor(const void* x, long long voxels, void* out, void* stream) {
  if (voxels < 0 || voxels > FLOOR_VOXELS) return (int)cudaErrorInvalidValue;
  chain_floor_kernel<<<1, 128, 0, (cudaStream_t)stream>>>((const float*)x, voxels, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
