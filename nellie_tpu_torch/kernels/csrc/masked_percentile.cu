// The linearly interpolated percentile of the masked values, for Hopper
// (sm_90a): a memset and one persistent cooperative kernel a call, no sort
// and no host read.
//
// Replaces nellie_tpu/kernels/frangi.py::masked_percentile (frangi.py:226),
// a full sort of the values with +inf outside the mask, and the port's plain
// body (kernels/frangi.py::masked_percentile_plain): a host read of the
// count, a full torch.sort and one fused multiply-add.
//
// What it computes, exactly as the plain body does (built with -fmad=false).
// n = the masked count; 0 when n is 0.  Otherwise
//   pos = f32(q / 100) * f32(n - 1),  lo = floor(pos),  hi = ceil(pos),
//   frac = pos - lo,  A = fma(s[lo], 1 - frac, s[hi] * frac),
//   B = fma(s[hi], frac, s[lo] * (1 - frac))
// (one rounding in each fma, as _fp.fma: XLA contracts either product of
// s[lo] (1 - frac) + s[hi] frac, fusion by fusion, and the callers compare
// with each form where the reference's fusion does; kernels/frangi.py
// FINALIZE_FORMS), s the values sorted with +inf
// outside the mask, as the reference's stable sort orders them: -inf, the
// negatives, the zeros (-0 and +0 tie and keep their order in the values),
// the positives, +inf (the masked ones and the pads, n_all - n of them, n_all
// the values' count), then the masked NaNs.  So rank k < n - n_nan (n_nan
// the masked NaNs) is the k-th of the masked values that are not NaN, a
// rank past that +inf while a pad is left and NaN after.
//
// What bounds it: the mask's bytes and the masked values' (each read once),
// about 5 MB at the callers' samples of 10^6 values.  What the design does
// about it: a radix select over order-preserving uint32 keys (a float's
// bits with the sign bit flipped, all bits flipped for a negative; NaN the
// largest key), 8 bits a pass, four passes in one cooperative launch (at
// most one block of THREADS an SM) with grid barriers between them
// (coop_grid.cuh):
//  * a pass histograms one digit of the keys whose higher digits match the
//    prefix chosen so far, in shared memory (lanes with the same digit
//    merged by __match_any_sync, one shared atomic a digit a warp), then
//    adds the block's nonzero bins to the pass's global histogram;
//  * both ranks, lo and hi, are tracked in the same passes: while their
//    prefixes agree one histogram serves both, once they part each has its
//    own;
//  * after the barrier every block scans the 256 global bins (a warp scan
//    and the warp totals) and picks the digit that holds each rank, so no
//    block waits for another's choice; pass 1's total is n, from which each
//    block computes pos, lo and hi;
//  * the passes after the first reread the values from the L2 (the sample
//    is a few MB), and only the values whose prefix matches count;
//  * pass 1 also counts the masked NaNs, so every block knows which ranks
//    fall on the pads or the NaNs;
//  * where a rank falls on the zeros (one key for -0 and +0), the select
//    leaves its rank j among them, and one more phase finds the j-th masked
//    zero in the values' order for its sign: each block counts the masked
//    zeros of its contiguous share, and after a barrier the block whose
//    share holds the j-th walks it in order (a ballot a warp, a scan of the
//    warps).  The callers' samples hold no zero, so they never run it.
// The C entry point clears the histograms and the barrier with one memset
// and launches the kernel; the result is two float32 on the card, A and B.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coop_grid.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr int PASSES = 4;

constexpr int MAX_BLOCKS = 1024;
constexpr uint32_t ZERO_KEY = 0x80000000u;  // -0 and +0

// scratch words: the histograms by pass and rank, the barrier's counter, the
// masked NaNs, the two zero ranks' signs, then the masked zeros by block;
// the memset clears the words before the zeros by block (each block writes
// its own before it is read)
constexpr int HIST_WORDS = PASSES * 2 * BINS;
constexpr int COUNTER = HIST_WORDS, NANS = HIST_WORDS + 1, SIGNS = HIST_WORDS + 2,
              ZEROS = HIST_WORDS + 4;
constexpr int CLEARED_WORDS = ZEROS, SCRATCH_WORDS = ZEROS + MAX_BLOCKS;

__device__ __forceinline__ uint32_t key_of(float x) {
  uint32_t u = __float_as_uint(x);
  if (isnan(x)) return 0xFFFFFFFFu;
  if (u == 0x80000000u) u = 0;  // -0 ties with +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

struct Args {
  const float* values;
  const uint8_t* mask;
  long long n;
  long long stride_v, stride_m;  // elements between neighbours
  float q;                       // f32(q / 100)
  unsigned int* scratch;
  float* out;
};

__device__ __forceinline__ bool masked_zero(const Args& a, long long i) {
  return a.mask[i * a.stride_m] && a.values[i * a.stride_v] == 0.0f;
}

// The block's sum of one count a thread, for every thread.  warp_sums:
// WARPS words.
__device__ unsigned int block_sum(unsigned int c, unsigned int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, d);
  __syncthreads();
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  unsigned int total = 0;
  for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
  return total;
}

struct Select {
  uint32_t prefix[2];  // the digits chosen so far, for lo and hi
  long long rank[2];   // the rank left within the prefix's keys
};

// A block's scan of one global histogram: the digit that holds `rank` and
// the count below it.  Every thread gets the answer.  scan: WARPS words.
__device__ void pick(const unsigned int* hist, long long rank, uint32_t& digit,
                     long long& below, unsigned int* warp_sums, long long* answer) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned int c = 0, incl = 0;
  if (t < BINS) {
    c = *(volatile const unsigned int*)(hist + t);
    incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
  }
  __syncthreads();
  if (t < BINS) {
    unsigned long long before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    const long long lo = (long long)before + incl - c;
    if (c && rank >= lo && rank < lo + c) {
      answer[0] = t;
      answer[1] = lo;
    }
  }
  __syncthreads();
  digit = (uint32_t)answer[0];
  below = answer[1];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) percentile_select(Args a) {
  __shared__ unsigned int hist[2][BINS];
  __shared__ unsigned int warp_sums[WARPS];
  __shared__ long long answer[2];
  __shared__ unsigned long long total;
  const int t = threadIdx.x, lane = t & 31;
  const long long stride = (long long)gridDim.x * THREADS;
  unsigned int* counter = a.scratch + COUNTER;
  unsigned int target = 0;
  Select sel;
  sel.prefix[0] = sel.prefix[1] = 0;
  sel.rank[0] = sel.rank[1] = 0;
  float frac = 0.0f;
  bool fixed[2] = {false, false};  // a rank on the pads (+inf) or the NaNs
  float fixed_value[2] = {0.0f, 0.0f};
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = 24 - 8 * pass;
    const bool split = sel.prefix[0] != sel.prefix[1];
    for (int k = t; k < 2 * BINS; k += THREADS) (&hist[0][0])[k] = 0;
    __syncthreads();
    // the loop's bound is warp-uniform so that every lane takes part in the match
    for (long long base = (long long)blockIdx.x * THREADS + (t & ~31); base < a.n;
         base += stride) {
      const long long i = base + lane;
      int d0 = -1, d1 = -1;
      bool is_nan = false;
      if (i < a.n && a.mask[i * a.stride_m]) {
        const float v = a.values[i * a.stride_v];
        is_nan = isnan(v);
        const uint32_t key = key_of(v);
        const uint32_t high = pass == 0 ? 0 : key >> (shift + 8);
        const int digit = (key >> shift) & 0xFF;
        if (high == sel.prefix[0]) d0 = digit;
        if (split && high == sel.prefix[1]) d1 = digit;
      }
      if (pass == 0) {
        const unsigned nans = __ballot_sync(0xFFFFFFFFu, is_nan);
        if (nans && lane == 0) atomicAdd(a.scratch + NANS, __popc(nans));
      }
      const unsigned peers0 = __match_any_sync(0xFFFFFFFFu, d0);
      if (d0 >= 0 && lane == __ffs(peers0) - 1) atomicAdd(&hist[0][d0], __popc(peers0));
      if (split) {
        const unsigned peers1 = __match_any_sync(0xFFFFFFFFu, d1);
        if (d1 >= 0 && lane == __ffs(peers1) - 1) atomicAdd(&hist[1][d1], __popc(peers1));
      }
    }
    __syncthreads();
    unsigned int* global = a.scratch + pass * 2 * BINS;
    for (int k = t; k < (split ? 2 : 1) * BINS; k += THREADS) {
      const unsigned int c = (&hist[0][0])[k];
      if (c) atomicAdd(global + k, c);
    }
    coop_grid::barrier(counter, target);
    if (pass == 0) {
      // n from the first histogram, then the two ranks
      if (t == 0) total = 0;
      __syncthreads();
      if (t < BINS) {
        const unsigned int c = *(volatile const unsigned int*)(global + t);
        if (c) atomicAdd(&total, (unsigned long long)c);
      }
      __syncthreads();
      const long long n = (long long)total;
      if (n == 0) {
        if (blockIdx.x == 0 && t == 0) a.out[0] = a.out[1] = 0.0f;
        return;
      }
      const float pos = __fmul_rn(a.q, (float)(n - 1));
      const float lo = floorf(pos), hi = ceilf(pos);
      frac = __fsub_rn(pos, lo);
      sel.rank[0] = (long long)lo;
      sel.rank[1] = (long long)hi;
      const long long real = n - *(volatile const unsigned int*)(a.scratch + NANS);
      for (int r = 0; r < 2; ++r) {
        fixed[r] = sel.rank[r] >= real;
        fixed_value[r] = sel.rank[r] - real < a.n - n ? INFINITY : NAN;
      }
    }
    for (int r = 0; r < 2; ++r) {
      // the ranks share one histogram while their prefixes agree
      const unsigned int* h = global + (split && r == 1 ? BINS : 0);
      uint32_t digit;
      long long below;
      pick(h, sel.rank[r], digit, below, warp_sums, answer);
      sel.rank[r] -= below;
      sel.prefix[r] = (sel.prefix[r] << 8) | digit;
    }
  }
  // a rank on the zeros: the sign of the rank[r]-th masked zero in order
  bool zero[2];
  for (int r = 0; r < 2; ++r) zero[r] = !fixed[r] && sel.prefix[r] == ZERO_KEY;
  if (zero[0] || zero[1]) {  // the same in every block
    const long long share = (a.n + gridDim.x - 1) / gridDim.x;
    const long long begin = min(a.n, (long long)blockIdx.x * share);
    const long long end = min(a.n, begin + share);
    unsigned int c = 0;
    for (long long i = begin + t; i < end; i += THREADS) c += masked_zero(a, i);
    c = block_sum(c, warp_sums);
    if (t == 0) a.scratch[ZEROS + blockIdx.x] = c;
    coop_grid::barrier(counter, target);
    long long before = 0;
    for (int b = 0; b < (int)blockIdx.x; ++b)
      before += *(volatile const unsigned int*)(a.scratch + ZEROS + b);
    for (int r = 0; r < 2; ++r) {
      const long long want = sel.rank[r] - before;  // the wanted zero's rank in the share
      if (!zero[r] || want < 0 || want >= c) continue;
      long long seen = 0;
      for (long long tile = begin; tile < end && seen <= want; tile += THREADS) {
        const long long i = tile + t;
        const bool z = i < end && masked_zero(a, i);
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, z);
        __syncthreads();
        if (lane == 0) warp_sums[t >> 5] = __popc(ballot);
        __syncthreads();
        unsigned int below = __popc(ballot & ((1u << lane) - 1u)), all = 0;
        for (int w = 0; w < WARPS; ++w) {
          below += w < (t >> 5) ? warp_sums[w] : 0;
          all += warp_sums[w];
        }
        if (z && seen + below == want)
          a.scratch[SIGNS + r] = signbit(a.values[i * a.stride_v]) ? 1u : 0u;
        seen += all;
      }
    }
    coop_grid::barrier(counter, target);
  }
  if (blockIdx.x == 0 && t == 0) {
    float s[2];
    for (int r = 0; r < 2; ++r) {
      s[r] = fixed[r] ? fixed_value[r] : value_of(sel.prefix[r]);
      if (zero[r] && *(volatile const unsigned int*)(a.scratch + SIGNS + r)) s[r] = -0.0f;
    }
    const float one = __fsub_rn(1.0f, frac);
    a.out[0] = __fmaf_rn(s[0], one, __fmul_rn(s[1], frac));  // A
    a.out[1] = __fmaf_rn(s[1], frac, __fmul_rn(s[0], one));  // B
  }
}

}  // namespace

extern "C" {

long long masked_percentile_scratch_bytes() { return 4LL * SCRATCH_WORDS; }

// The q-th percentile (q100 = f32(q / 100), in [0, 1]) of values[mask] into
// out (two float32 on the card: the forms A and B).  values: n float32, stride_v elements
// apart; mask: n bool bytes, stride_m apart; scratch:
// masked_percentile_scratch_bytes() bytes, 4-byte aligned.  kernels (host):
// the CUDA kernels launched (the memset and the kernel).
int masked_percentile(const void* values, const void* mask, long long n, long long stride_v,
                      long long stride_m, float q100, void* scratch, void* out, int* kernels,
                      void* stream) {
  *kernels = 0;
  if (n < 1 || stride_v < 1 || stride_m < 1 || !(q100 >= 0.0f && q100 <= 1.0f) ||
      (uintptr_t)scratch % 4)
    return (int)cudaErrorInvalidValue;
  coop_grid::Launch shape;
  cudaError_t err = coop_grid::launch_shape<percentile_select>(THREADS, shape);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n + THREADS - 1) / THREADS;
  const long long most = shape.sms < MAX_BLOCKS ? shape.sms : MAX_BLOCKS;
  const int grid = (int)(need < most ? need : most);
  cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(scratch, 0, 4LL * CLEARED_WORDS, s)) != cudaSuccess)
    return (int)err;
  *kernels = 1;
  Args a{(const float*)values, (const uint8_t*)mask, n, stride_v, stride_m, q100,
         (unsigned int*)scratch, (float*)out};
  void* args[] = {(void*)&a};
  if ((err = cudaLaunchCooperativeKernel((const void*)percentile_select, dim3(grid),
                                         dim3(THREADS), args, 0, s)) != cudaSuccess)
    return (int)err;
  *kernels = 2;
  return (int)cudaSuccess;
}

}  // extern "C"
