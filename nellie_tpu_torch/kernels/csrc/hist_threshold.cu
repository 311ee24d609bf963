// Otsu and triangle thresholds of the masked values, for Hopper (sm_90a):
// two launches a call, no host read.
//
// Replaces nellie_tpu/kernels/thresholds.py::_masked_histogram,
// _otsu_from_hist and _triangle_from_hist (thresholds.py:18-131, under
// otsu_threshold, triangle_threshold and min_triangle_otsu), and the port's
// plain bodies (kernels/thresholds.py::*_plain): a bincount, which reads the
// host on a CUDA tensor, prefix sums of one add a launch, and five host
// reads in the triangle's choice of bins, about 200 CUDA kernels a call.
//
// What it computes, exactly as the plain bodies do (built with -fmad=false,
// every contraction an explicit __fmaf_rn, every division and root IEEE):
//  * lo and hi, the masked minimum and maximum (exact in any order; kept as
//    ordered integer keys with atomics), 0 and 1 when no value is masked in;
//  * each masked value's bin floor((x - lo) / safe_span * nbins) in float32,
//    clamped to [0, nbins - 1] (NaN to 0, as a float-to-int64 conversion
//    and the clamp give), safe_span = hi - lo or 1 where that is not
//    positive; integer counts by atomics, which are exact;
//  * the counts' float32 total in XLA's order (kernels/thresholds.py::
//    counts_total): where nbins is a multiple of 16 over rows of 16 counts,
//    else over single counts; up to 32 rows one add at a time, past that
//    windows of 32 rows, the padding to a multiple of 32 split half
//    (rounded down) before the first row, each window summed in order,
//    then the window sums the same way, all by one thread;
//  * Otsu: p = count / max(total, 1), the four prefix sums of p, p * centre
//    and their reversals in kernels/thresholds.py::cumsum_f32's order
//    (sequential inside blocks of 16, the block totals prefix-summed the
//    same way, then added to each block), mean1 = S(p c) / max(S(p),
//    1e-30), the same from the top, variance12[b] = (w1[b] * w2[b + 1]) *
//    (gap * gap) with gap = mean1[b] - mean2[b + 1], the first argmax (NaN
//    first, as torch.argmax); the threshold is the centre of that bin, the
//    criterion the variance there;
//  * triangle: the first peak, the lowest and highest nonempty bins, the
//    flip when the peak is nearer the low end, norm = sqrt(fma(h, h, w *
//    w)) (_fp.sum_of_products), length = fma(ph, x1, -(wd * hist_f)) over
//    [low, peak), its first argmax or the low bin when that range is empty;
//  * centres: fma(bin, span / nbins, lo) + span / (2 nbins);
//  * both thresholds 0 when nothing is masked in; out[3] is their minimum
//    (NaN first, as torch.minimum).
//
// What bounds it: the bytes of the values and the mask, read once by each
// of the two passes (the bound counts them once).  What the design does
// about it: pass 1 (masked_range) is a grid-stride walk with one atomic per
// warp; pass 2 (masked_hist) bins into a histogram in shared memory, adds
// it to the global one with atomics (past SHARED_BINS bins it adds to the
// global one directly), and its last block (a counter that grows, with a
// fence before it) runs the tail: elementwise work one thread a bin, the
// total, the four prefix sums and the two argmax walks one thread each.
// The C entry point clears the counters with one memset and launches the
// two kernels; nothing is read back.  Any nbins from 2 is taken: the
// scans recurse as deep as 2^31 bins need, and the scratch is sized from
// nbins.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_BLOCK = 16;      // kernels/thresholds.py::_SCAN_BLOCK
constexpr int SCAN_LEVELS = 7;      // levels of block totals: 16^8 > 2^31 bins
constexpr int SHARED_BINS = 8192;   // bins counted in shared memory first
constexpr int DOT_COLUMNS = 16;     // kernels/thresholds.py::_DOT_COLUMNS
constexpr int REDUCE_WINDOW = 32;   // XLA's CPU tree-reduction window
constexpr int BLOCKS_PER_SM = 4;

struct Head {
  unsigned int lo_key;  // ~key of the masked minimum (atomicMax), 0 for none
  unsigned int hi_key;  // key of the masked maximum (atomicMax), 0 for none
  unsigned int any;     // 1 when a value is masked in
  unsigned int done;    // blocks of pass 2 finished
};

// float -> unsigned key in the floats' order (-0 below +0)
__device__ __forceinline__ unsigned int order_key(float x) {
  const unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool masked_in(const unsigned char* mask, long long i) {
  return mask == nullptr || mask[i] != 0;
}

__global__ void __launch_bounds__(THREADS)
    masked_range(const float* values, const unsigned char* mask, long long n, Head* head) {
  unsigned int lo = 0, hi = 0, any = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!masked_in(mask, i)) continue;
    const unsigned int k = order_key(values[i]);
    lo = max(lo, ~k);
    hi = max(hi, k);
    any = 1;
  }
  lo = __reduce_max_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  any = __reduce_or_sync(0xffffffffu, any);
  if ((threadIdx.x & 31) == 0 && any) {
    atomicMax(&head->lo_key, lo);
    atomicMax(&head->hi_key, hi);
    atomicOr(&head->any, 1u);
  }
}

// torch.argmax's choice: the first maximum, a NaN before any number
__device__ __forceinline__ bool beats(float v, float best) {
  return isnan(v) ? !isnan(best) : (!isnan(best) && v > best);
}

__device__ long long first_argmax(const float* x, long long n) {
  long long idx = 0;
  for (long long b = 1; b < n; ++b)
    if (beats(x[b], x[idx])) idx = b;
  return idx;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {  // torch.clamp(min=): NaN passes
  return x < lo ? lo : x;
}

// kernels/thresholds.py::_running_sum
__device__ void running_sum(const float* x, long long n, float* out) {
  float acc = x[0];
  out[0] = acc;
  for (long long k = 1; k < n; ++k) out[k] = acc = __fadd_rn(acc, x[k]);
}

// kernels/thresholds.py::cumsum_f32 by one thread: tmp holds 3 n floats
// (n <= 16^(LEVELS + 1); every level below takes at most 3 of its own n
// from what this one leaves)
template <int LEVELS>
__device__ void blocked_scan(const float* x, long long n, float* out, float* tmp) {
  if (n <= SCAN_BLOCK) {
    running_sum(x, n, out);
    return;
  }
  if constexpr (LEVELS > 0) {
    const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
    float* inner = tmp;                       // nb * 16
    float* totals = inner + nb * SCAN_BLOCK;  // nb
    float* scanned = totals + nb;             // nb
    for (long long k = 0; k < nb; ++k) {
      float acc = x[k * SCAN_BLOCK];  // the padding past n is 0
      inner[k * SCAN_BLOCK] = acc;
      for (int j = 1; j < SCAN_BLOCK; ++j) {
        const long long i = k * SCAN_BLOCK + j;
        inner[i] = acc = __fadd_rn(acc, i < n ? x[i] : 0.f);
      }
      totals[k] = acc;
    }
    blocked_scan<LEVELS - 1>(totals, nb, scanned, scanned + nb);
    for (long long i = 0; i < n; ++i) {
      const long long k = i / SCAN_BLOCK;
      out[i] = __fadd_rn(inner[i], k == 0 ? 0.f : scanned[k - 1]);
    }
  }
}

// kernels/thresholds.py::counts_total by one thread: the counts as float32
// in x (n of them), window sums written over the front of x
__device__ float xla_total(float* x, long long n) {
  long long unit = n % DOT_COLUMNS == 0 ? DOT_COLUMNS : 1, rows = n / unit;
  while (rows > REDUCE_WINDOW) {
    const long long pad = (REDUCE_WINDOW - rows % REDUCE_WINDOW) % REDUCE_WINDOW;
    const long long first = -(pad / 2) * unit, width = REDUCE_WINDOW * unit;
    const long long windows = (rows + pad) / REDUCE_WINDOW, len = rows * unit;
    for (long long w = 0; w < windows; ++w) {  // window w reads from w * width + first >= w
      float acc = 0.f;
      for (long long k = w * width + first, end = k + width; k < end; ++k)
        if (k >= 0 && k < len) acc = __fadd_rn(acc, x[k]);
      x[w] = acc;
    }
    unit = 1;
    rows = windows;
  }
  float acc = x[0];
  for (long long k = 1; k < rows * unit; ++k) acc = __fadd_rn(acc, x[k]);
  return acc;
}

struct Tail {
  unsigned long long* counts;  // nbins
  float* work;                 // tail_floats(nbins)
  float* out;                  // otsu, criterion, triangle, min(triangle, otsu)
  unsigned char* any_out;
  long long nbins;
};

// floats of the tail's work area
__host__ __device__ long long tail_floats(long long nbins) { return 11 * nbins + 4 * 3 * nbins; }

// the thresholds from the histogram, in the last block of pass 2
__device__ void thresholds_tail(const Tail& tail, float lo, float span, bool any) {
  __shared__ float total_shared;
  __shared__ long long argmax_otsu;
  const long long n = tail.nbins, t = threadIdx.x;
  float* p = tail.work;        // count / max(total, 1): Otsu's p and the triangle's hist
  float* centres = p + n;
  float* arrays = centres + n; // p, p * c, and both reversed: the scans' inputs
  float* scans = arrays + 4 * n;
  float* v12 = scans + 4 * n;  // n - 1 variances, then the triangle's n lengths
  float* tmp = v12 + n;        // 3 n a scan; the total's window sums first
  for (long long b = t; b < n; b += blockDim.x) tmp[b] = __ull2float_rn(__ldcg(tail.counts + b));
  __syncthreads();
  if (t == 0) total_shared = xla_total(tmp, n);
  __syncthreads();
  const float denom = clamp_min(total_shared, 1.f);
  const float step = __fdiv_rn(span, __ll2float_rn(n));
  const float half = __fdiv_rn(span, __ll2float_rn(2 * n));
  for (long long b = t; b < n; b += blockDim.x) {
    const float pb = __fdiv_rn(__ull2float_rn(__ldcg(tail.counts + b)), denom);
    const float c = __fadd_rn(__fmaf_rn(__ll2float_rn(b), step, lo), half);
    const float pc = __fmul_rn(pb, c);
    p[b] = pb;
    centres[b] = c;
    arrays[b] = pb;
    arrays[n + b] = pc;
    arrays[2 * n + n - 1 - b] = pb;
    arrays[3 * n + n - 1 - b] = pc;
  }
  __syncthreads();
  if (t < 4) blocked_scan<SCAN_LEVELS>(arrays + t * n, n, scans + t * n, tmp + 3 * n * t);
  __syncthreads();
  const float* w1 = scans;          // S(p)
  const float* s_pc = scans + n;    // S(p c)
  const float* rev_w = scans + 2 * n;
  const float* rev_pc = scans + 3 * n;
  for (long long b = t; b < n - 1; b += blockDim.x) {
    const float mean1 = __fdiv_rn(s_pc[b], clamp_min(w1[b], 1e-30f));
    const long long r = n - 1 - (b + 1);  // weight2[b + 1] = rev_w[n - 2 - b]
    const float w2 = rev_w[r];
    const float mean2 = __fdiv_rn(rev_pc[r], clamp_min(rev_w[r], 1e-30f));
    const float gap = __fsub_rn(mean1, mean2);
    v12[b] = __fmul_rn(__fmul_rn(w1[b], w2), __fmul_rn(gap, gap));
  }
  __syncthreads();
  if (t == 0) argmax_otsu = first_argmax(v12, n - 1);
  __syncthreads();
  // the triangle (v12 is free again once the argmax is read)
  const long long idx_otsu = argmax_otsu;
  const float otsu = any ? centres[idx_otsu] : 0.f;
  const float criterion = v12[idx_otsu];
  __syncthreads();
  __shared__ long long arg_low_f, arg_peak_f;
  __shared__ int flip_s;
  __shared__ float ph_s, wd_s;
  if (t == 0) {
    const long long arg_peak = first_argmax(p, n);
    const float peak_height = p[arg_peak];
    long long arg_low = n, arg_high = -1;
    for (long long b = 0; b < n; ++b)
      if (p[b] > 0.f) {
        if (arg_low == n) arg_low = b;
        arg_high = b;
      }
    const bool flip = (arg_peak - arg_low) < (arg_high - arg_peak);
    const long long low_f = flip ? n - arg_high - 1 : arg_low;
    const long long peak_f = flip ? n - arg_peak - 1 : arg_peak;
    const float width = __ll2float_rn(peak_f - low_f);
    const float norm = __fsqrt_rn(__fmaf_rn(peak_height, peak_height, __fmul_rn(width, width)));
    ph_s = __fdiv_rn(peak_height, clamp_min(norm, 1e-30f));
    wd_s = __fdiv_rn(width, clamp_min(norm, 1e-30f));
    arg_low_f = low_f;
    arg_peak_f = peak_f;
    flip_s = flip;
  }
  __syncthreads();
  float* length = v12;
  for (long long b = t; b < n; b += blockDim.x) {
    const float hist_f = flip_s ? p[n - 1 - b] : p[b];
    const bool valid = b >= arg_low_f && b < arg_peak_f;
    length[b] = valid ? __fmaf_rn(ph_s, __ll2float_rn(b - arg_low_f), -__fmul_rn(wd_s, hist_f))
                      : -INFINITY;
  }
  __syncthreads();
  if (t == 0) {
    long long level =
        arg_peak_f > arg_low_f && arg_low_f < n ? first_argmax(length, n) : arg_low_f;
    if (flip_s) level = n - level - 1;
    const float tri = any ? centres[level] : 0.f;
    tail.out[0] = otsu;
    tail.out[1] = criterion;
    tail.out[2] = tri;
    tail.out[3] = isnan(tri) ? tri : (isnan(otsu) ? otsu : (tri < otsu ? tri : otsu));
    tail.any_out[0] = any;
  }
}

// at most 64 registers a thread, so that BLOCKS_PER_SM blocks fit on an SM
// at once: the tail inlined here would otherwise raise the count, and the
// grid would run in two waves
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    masked_hist(const float* values, const unsigned char* mask, long long n, Head* head,
                Tail tail) {
  extern __shared__ unsigned int local[];  // nbins, where nbins <= SHARED_BINS
  __shared__ bool last;
  const long long nbins = tail.nbins;
  const bool shared = nbins <= SHARED_BINS;
  if (shared)
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) local[b] = 0;
  const bool any = head->any != 0;
  const float lo = any ? key_value(~head->lo_key) : 0.f;
  const float hi = any ? key_value(head->hi_key) : 1.f;
  const float span = __fsub_rn(hi, lo);
  const float safe = span > 0.f ? span : 1.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!masked_in(mask, i)) continue;
    const float q =
        floorf(__fmul_rn(__fdiv_rn(__fsub_rn(values[i], lo), safe), __ll2float_rn(nbins)));
    // the float-to-int64 conversion, then the clamp to [0, nbins - 1]; NaN to 0
    const long long k = q >= 0.f ? __float2ll_rz(q) : 0;
    const long long b = k < nbins - 1 ? k : nbins - 1;
    if (shared)
      atomicAdd(local + b, 1u);
    else
      atomicAdd(tail.counts + b, 1ull);
  }
  __syncthreads();
  if (shared)
    for (int b = threadIdx.x; b < nbins; b += blockDim.x)
      if (local[b]) atomicAdd(tail.counts + b, (unsigned long long)local[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&head->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  thresholds_tail(tail, lo, span, any);
}

}  // namespace

extern "C" {

// Bytes of device scratch a call needs for nbins bins.
long long hist_threshold_scratch(int nbins) {
  return (long long)sizeof(Head) + 8LL * nbins + 4LL * tail_floats(nbins);
}

// Otsu and triangle thresholds of values[mask] (float32, n values; mask
// bool bytes or null for all) over nbins (at least 2) bins: out 4 float32
// (Otsu, its criterion, triangle, their minimum) and any_out one bool byte,
// all on the device.  scratch: hist_threshold_scratch(nbins) bytes.
// kernels (host): the CUDA kernels launched.
int hist_threshold(const void* values, const void* mask, long long n, int nbins, void* scratch,
                   void* out, void* any_out, int* kernels, void* stream) {
  *kernels = 0;
  if (nbins < 2 || n < 0) return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  Head* head = (Head*)scratch;
  Tail tail;
  tail.counts = (unsigned long long*)(head + 1);
  tail.work = (float*)(tail.counts + nbins);
  tail.out = (float*)out;
  tail.any_out = (unsigned char*)any_out;
  tail.nbins = nbins;
  cudaStream_t st = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(scratch, 0, sizeof(Head) + 8LL * nbins, st)) != cudaSuccess)
    return (int)err;
  long long want = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  const float* v = (const float*)values;
  const unsigned char* m = (const unsigned char*)mask;
  masked_range<<<grid, THREADS, 0, st>>>(v, m, n, head);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t shared = nbins <= SHARED_BINS ? sizeof(unsigned int) * nbins : 0;
  masked_hist<<<grid, THREADS, shared, st>>>(v, m, n, head, tail);
  *kernels = 2;
  return (int)cudaGetLastError();
}

}  // extern "C"
