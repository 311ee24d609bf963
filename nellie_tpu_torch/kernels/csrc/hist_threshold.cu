// Otsu and triangle thresholds of the masked values, for Hopper (sm_90a):
// a memset and two launches a call, no host read.
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
//    a NaN among the masked values makes every result NaN, as in the plain
//    bodies (its key is the largest or the smallest, so hi - lo is NaN);
//  * each masked value's bin floor((x - lo) / safe_span * nbins) in float32,
//    clamped to [0, nbins - 1] (NaN to 0, as a float-to-int64 conversion
//    and the clamp give), safe_span = hi - lo or 1 where that is not
//    positive; integer counts by atomics, which are exact;
//  * the counts' float32 total in XLA's order (kernels/thresholds.py::
//    counts_total): where nbins is a multiple of 16 over rows of 16 counts,
//    else over single counts; past 32 rows windows of 32 rows, the padding
//    to a multiple of 32 split half (rounded down) before the first row,
//    each window summed in order, then the window sums the same way, and at
//    most 32 rows one add at a time.  While the counts' exact total is at
//    most 2^24 every partial sum in any order is an integer that float32
//    holds exactly, so the total is the exact one and no chain runs;
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
// What bounds it: the mask's bytes and the masked values' (each read once;
// chip_smoke.threshold_bound), then the tail's short dependent steps in one
// block.  What the design does about it:
//  * pass 1 (masked_range) is led by the mask: a thread reads 16 mask bytes
//    at once and loads a 16-byte group of values only where one of its 4
//    mask bytes is set, so the rows and sectors that a stride mask skips
//    are never fetched (a byte a thread, mask-led still, where the arrays
//    are not 16-byte aligned); it keeps the range
//    as integer keys, one atomic a key a block, and appends the masked
//    values to a record (one atomic a warp on its count, the lanes of a
//    slot writing neighbouring floats);
//  * pass 2 (masked_hist) bins the record, which is small and in L2, into
//    a histogram in shared memory and adds it to one of COPIES global ones
//    with atomics, so that no line of L2 takes every block's atomics (past
//    SHARED_BINS bins it adds to one global histogram directly).  Where
//    more values are masked in than the record holds (RECORD, 8 MB), pass
//    2 rereads the mask and the masked values' sectors instead, and with
//    no mask it reads the values themselves: no host read decides it;
//  * the last block of pass 2 (a counter that grows, with a fence before it)
//    runs the tail out of shared memory (global scratch past
//    TAIL_SHARED_BINS bins), parallel wherever the order allows: the copies
//    summed and the exact total as an integer block sum, the windows of the
//    float total one thread each, p and p * centre one thread a bin, the
//    four scans' inner runs one thread each for all four scans at once,
//    level by level, then the adds one thread an element, and the argmaxes
//    and the nonempty range as block reductions that keep the first index
//    on ties and put NaN first.
// The C entry point clears the counters with one memset and launches the
// two kernels; nothing is read back.  Any nbins from 2 is taken: the scans
// take up to 2^31 bins in 8 levels, and the scratch is sized from nbins and
// n (the record holds at most RECORD values).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_BLOCK = 16;        // kernels/thresholds.py::_SCAN_BLOCK
constexpr int SHARED_BINS = 8192;     // bins counted in shared memory first
constexpr int TAIL_SHARED_BINS = 1024;  // bins whose tail runs in shared memory
constexpr int DOT_COLUMNS = 16;       // kernels/thresholds.py::_DOT_COLUMNS
constexpr int REDUCE_WINDOW = 32;     // XLA's CPU tree-reduction window
constexpr int BLOCKS_PER_SM = 4;
constexpr int CHUNK = 16;             // mask bytes a thread reads at once
constexpr unsigned long long EXACT_TOTAL = 1ull << 24;  // float32 holds every integer up to it

constexpr int COPIES = 16;            // histograms the blocks of pass 2 add to in turn

constexpr long long RECORD = 1LL << 21;  // masked values pass 1 records, at most (8 MB)

struct Head {
  unsigned int lo_key;  // ~key of the masked minimum (atomicMax), 0 for none
  unsigned int hi_key;  // key of the masked maximum (atomicMax), 0 for none
  unsigned int done;    // blocks of pass 2 finished
  unsigned int pad;
  unsigned long long count;  // masked values, where a mask is given
};

// Where pass 1 records the masked values and pass 2 bins them from: the
// first `cap` of them in any order, cap = min(n, RECORD); past cap pass 2
// takes them from the mask and the values again.
struct Record {
  float* values;
  long long cap;
};

// copies of the counts: spread over COPIES histograms where the blocks add
// their shared ones, so that no one line of L2 takes every block's atomics
__host__ __device__ int count_copies(long long nbins) { return nbins <= SHARED_BINS ? COPIES : 1; }

// float -> unsigned key in the floats' order (-0 below +0)
__device__ __forceinline__ unsigned int order_key(float x) {
  const unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// f(x) for every masked value x of values[0, n) (mask null: every value).
// VEC: values and mask 16-byte aligned; a thread reads CHUNK mask bytes as
// one uint4 and loads the float4 of each 4-byte mask word that is not 0.
template <bool VEC, typename F>
__device__ __forceinline__ void for_each_masked(const float* values, const unsigned char* mask,
                                                long long n, F&& f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (VEC) {
    const long long chunks = n / CHUNK;
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    const float4* v4 = reinterpret_cast<const float4*>(values);
    for (long long c = first; c < chunks; c += stride) {
      const uint4 m = mask ? m4[c] : make_uint4(~0u, ~0u, ~0u, ~0u);
      const unsigned int words[4] = {m.x, m.y, m.z, m.w};
      float4 v[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (words[w]) v[w] = v4[c * 4 + w];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (words[w] & 0x000000ffu) f(v[w].x);
        if (words[w] & 0x0000ff00u) f(v[w].y);
        if (words[w] & 0x00ff0000u) f(v[w].z);
        if (words[w] & 0xff000000u) f(v[w].w);
      }
    }
    done = chunks * CHUNK;
  }
  for (long long i = done + first; i < n; i += stride)
    if (mask == nullptr || mask[i] != 0) f(values[i]);
}

// A warp's first position in the record for its `cnt` values (a lane's
// count, summed over the warp): one atomic a warp on the count.
__device__ __forceinline__ long long warp_append(unsigned long long* count, unsigned int cnt) {
  const unsigned int total = __reduce_add_sync(0xffffffffu, cnt);
  unsigned long long base = 0;
  if ((threadIdx.x & 31) == 0 && total) base = atomicAdd(count, (unsigned long long)total);
  return (long long)__shfl_sync(0xffffffffu, base, 0);
}

// Pass 1: the keys of the masked range and, where a mask is given, the
// record of the masked values.  Both keys stay 0 only when nothing is
// masked in: a masked value with key 0 has ~key 0xffffffff.  One atomic a
// key a block.  A warp walks its chunks together and appends its values
// slot by slot (the same byte of every lane's chunk at once), so that the
// lanes of a slot write neighbouring floats.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    masked_range(const float* values, const unsigned char* mask, long long n, Head* head,
                 Record record) {
  __shared__ unsigned int parts[2][WARPS];
  unsigned int lo = 0, hi = 0;
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // one slot: x is masked in where `in`; pos the warp's next position
  auto slot = [&](bool in, float x, long long& pos) {
    const unsigned int lanes = __ballot_sync(0xffffffffu, in);
    if (in) {
      const unsigned int k = order_key(x);
      lo = max(lo, ~k);
      hi = max(hi, k);
      const long long at = pos + __popc(lanes & below);
      if (mask && at < record.cap) record.values[at] = x;
    }
    pos += __popc(lanes);
  };
  long long done = 0;
  if constexpr (VEC) {
    const long long chunks = n / CHUNK;
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    const float4* v4 = reinterpret_cast<const float4*>(values);
    for (long long c = first; c - lane < chunks; c += stride) {
      const uint4 m = c >= chunks ? make_uint4(0u, 0u, 0u, 0u)
                                  : (mask ? m4[c] : make_uint4(~0u, ~0u, ~0u, ~0u));
      const unsigned int words[4] = {m.x, m.y, m.z, m.w};
      const unsigned int cnt = __popc(__vcmpne4(m.x, 0u)) + __popc(__vcmpne4(m.y, 0u)) +
                               __popc(__vcmpne4(m.z, 0u)) + __popc(__vcmpne4(m.w, 0u));
      if (!__any_sync(0xffffffffu, cnt)) continue;
      long long pos = mask ? warp_append(&head->count, cnt / 8) : 0;
      float4 v[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (words[w]) v[w] = v4[c * 4 + w];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (!__any_sync(0xffffffffu, words[w])) continue;
        slot(words[w] & 0x000000ffu, v[w].x, pos);
        slot(words[w] & 0x0000ff00u, v[w].y, pos);
        slot(words[w] & 0x00ff0000u, v[w].z, pos);
        slot(words[w] & 0xff000000u, v[w].w, pos);
      }
    }
    done = chunks * CHUNK;
  }
  for (long long i = done + first; i - lane < n; i += stride) {
    const bool in = i < n && (mask == nullptr || mask[i] != 0);
    if (!__any_sync(0xffffffffu, in)) continue;
    long long pos = mask ? warp_append(&head->count, in) : 0;
    slot(in, in ? values[i] : 0.f, pos);
  }
  lo = __reduce_max_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    parts[0][threadIdx.x >> 5] = lo;
    parts[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      lo = max(lo, parts[0][w]);
      hi = max(hi, parts[1][w]);
    }
    if (lo) atomicMax(&head->lo_key, lo);
    if (hi) atomicMax(&head->hi_key, hi);
  }
}

__device__ __forceinline__ float clamp_min(float x, float lo) {  // torch.clamp(min=): NaN passes
  return x < lo ? lo : x;
}

// torch.argmax's order as one unsigned key a value: a NaN above every
// number, -0 as +0 (they tie), then the larger value; ties go to the lower
// index.  Key 0 is no value: every float's key is above it.
__device__ __forceinline__ unsigned int arg_key(float v) {
  return isnan(v) ? 0xffffffffu : order_key(v == 0.f ? 0.f : v);
}

struct Best {
  unsigned int key, index;
};

__device__ __forceinline__ void take(Best& a, float v, unsigned int i) {
  const unsigned int k = arg_key(v);
  if (k > a.key || (k == a.key && i < a.index)) a = {k, i};
}

__device__ __forceinline__ Best warp_best(Best a) {
  const unsigned int key = __reduce_max_sync(0xffffffffu, a.key);
  return {key, __reduce_min_sync(0xffffffffu, a.key == key ? a.index : 0xffffffffu)};
}

// Block reductions: every thread passes its part and gets the block's
// result; one barrier each (their shared parts are their own).
__device__ Best block_best(Best a) {
  __shared__ Best parts[WARPS];
  a = warp_best(a);
  if ((threadIdx.x & 31) == 0) parts[threadIdx.x >> 5] = a;
  __syncthreads();
  a = parts[0];
  for (int w = 1; w < WARPS; ++w)
    if (parts[w].key > a.key || (parts[w].key == a.key && parts[w].index < a.index)) a = parts[w];
  return a;
}

__device__ unsigned long long block_sum(unsigned long long x) {
  __shared__ unsigned long long parts[WARPS];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) parts[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0;
  for (int w = 0; w < WARPS; ++w) x += parts[w];
  return x;
}

// Otsu's and the peak's argmaxes, and the nonempty range as the least
// `low` and the largest `high` (one past the bin), in one exchange.
__device__ void block_bests_range(Best& a, Best& b, unsigned int& low, unsigned int& high) {
  __shared__ Best parts[2][WARPS];
  __shared__ unsigned int ends[2][WARPS];
  a = warp_best(a);
  b = warp_best(b);
  low = __reduce_min_sync(0xffffffffu, low);
  high = __reduce_max_sync(0xffffffffu, high);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    parts[0][warp] = a;
    parts[1][warp] = b;
    ends[0][warp] = low;
    ends[1][warp] = high;
  }
  __syncthreads();
  a = parts[0][0];
  b = parts[1][0];
  for (int w = 1; w < WARPS; ++w) {
    const Best x = parts[0][w], y = parts[1][w];
    if (x.key > a.key || (x.key == a.key && x.index < a.index)) a = x;
    if (y.key > b.key || (y.key == b.key && y.index < b.index)) b = y;
    low = min(low, ends[0][w]);
    high = max(high, ends[1][w]);
  }
}

// The levels of kernels/thresholds.py::cumsum_f32 over n elements: level 0
// holds the n inputs; while a level holds more than 16 elements, its
// blocks of 16 (its buffer rounded up to a multiple of 16 floats) have
// their totals in the next level; the top level holds at most 16, summed
// one add at a time.
struct Level {
  long long len;  // elements
  long long off;  // its buffer's offset in the scan's buffers
};

// the levels above level 0 and the floats of one scan's buffers
__host__ __device__ int scan_levels(long long n, long long* size) {
  int levels = 0;
  long long off = 0;
  for (; n > SCAN_BLOCK; ++levels) {
    const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
    off += nb * SCAN_BLOCK;
    n = nb;
  }
  *size = off + n;
  return levels;
}

__device__ Level scan_level(long long n, int l) {
  Level v{n, 0};
  for (int k = 0; k < l; ++k) {
    const long long nb = (v.len + SCAN_BLOCK - 1) / SCAN_BLOCK;
    v.off += nb * SCAN_BLOCK;
    v.len = nb;
  }
  return v;
}

// floats of the tail's work area: p, the variances (then the lengths), and
// the four scans
__host__ __device__ long long tail_floats(long long nbins) {
  long long size;
  scan_levels(nbins, &size);
  return 2 * nbins + 4 * size;
}

struct Tail {
  unsigned long long* counts;  // count_copies(nbins) histograms of nbins
  float* work;                 // tail_floats(nbins), used past TAIL_SHARED_BINS bins
  float* out;                  // otsu, criterion, triangle, min(triangle, otsu)
  unsigned char* any_out;
  long long nbins;
};

// kernels/thresholds.py::counts_total where the exact total passes 2^24:
// the counts as float32 in src, copied to a, windows of 32 rows one thread
// each (a and b in turns), the last rows in order by thread 0; the block's
// result
__device__ float ordered_total(long long n, const float* src, float* a, float* b) {
  __shared__ float total;
  const long long t = threadIdx.x, T = blockDim.x;
  for (long long k = t; k < n; k += T) a[k] = src[k];
  __syncthreads();
  long long unit = n % DOT_COLUMNS == 0 ? DOT_COLUMNS : 1, rows = n / unit;
  float *cur = a, *nxt = b;
  while (rows > REDUCE_WINDOW) {
    const long long pad = (REDUCE_WINDOW - rows % REDUCE_WINDOW) % REDUCE_WINDOW;
    const long long first = -(pad / 2) * unit, width = REDUCE_WINDOW * unit;
    const long long windows = (rows + pad) / REDUCE_WINDOW, len = rows * unit;
    for (long long w = t; w < windows; w += T) {
      float acc = 0.f;  // the counts are not negative: 0 + x and x + 0 are x
      for (long long k = w * width + first, end = k + width; k < end; ++k)
        if (k >= 0 && k < len) acc = __fadd_rn(acc, cur[k]);
      nxt[w] = acc;
    }
    __syncthreads();
    float* s = cur;
    cur = nxt;
    nxt = s;
    unit = 1;
    rows = windows;
  }
  if (t == 0) {
    float acc = cur[0];
    for (long long k = 1; k < rows * unit; ++k) acc = __fadd_rn(acc, cur[k]);
    total = acc;
  }
  __syncthreads();
  return total;
}

// the thresholds from the histogram, by the last block of pass 2; work in
// shared or global memory, tail_floats(nbins) floats
__device__ void thresholds_tail(const Tail& tail, float* work, float lo, float span, bool any) {
  __shared__ long long tri_s[2];  // the triangle's low and peak bins after the flip
  __shared__ int flip_s;
  __shared__ float ph_s, wd_s;
  const int n = (int)tail.nbins, t = threadIdx.x, T = blockDim.x;
  float* p = work;  // count / max(total, 1): Otsu's p and the triangle's hist
  float* pc = p + n;  // p * centre; after the scans the n - 1 variances, then the lengths
  float* v12 = pc;
  float* scans = pc + n;
  long long size;  // floats of one scan's buffers
  const int levels = scan_levels(n, &size);

  // the counts (the copies summed) and their total, exact where it can be
  const int copies = count_copies(n);
  unsigned long long part = 0;
  for (int b = t; b < n; b += T) {
    unsigned long long c = 0;
    for (int k = 0; k < copies; ++k) c += __ldcg(tail.counts + (long long)k * n + b);
    part += c;
    p[b] = __ull2float_rn(c);
  }
  const unsigned long long exact = block_sum(part);  // a barrier: the counts are in p
  const float total =
      exact <= EXACT_TOTAL ? __ull2float_rn(exact) : ordered_total(n, p, pc, scans);
  const float denom = clamp_min(total, 1.f);
  const float step = __fdiv_rn(span, __int2float_rn(n));
  const float half = __fdiv_rn(span, __ll2float_rn(2LL * n));
  auto centre = [&](long long b) { return __fadd_rn(__fmaf_rn(__ll2float_rn(b), step, lo), half); };
  for (int b = t; b < n; b += T) {
    const float pb = __fdiv_rn(p[b], denom);
    p[b] = pb;
    pc[b] = __fmul_rn(pb, centre(b));
  }
  __syncthreads();

  // the four scans: p, p * c, and both reversed, level by level; a task is
  // (run, scan), the scan in its two low bits
  auto input = [&](int s, long long i) {
    const long long b = s < 2 ? i : n - 1 - i;
    return s & 1 ? pc[b] : p[b];
  };
  Level cur{n, 0};
  for (int l = 0; l <= levels; ++l) {
    const bool top = l == levels;
    const Level next{top ? 1 : (cur.len + SCAN_BLOCK - 1) / SCAN_BLOCK,
                     cur.off + (cur.len + SCAN_BLOCK - 1) / SCAN_BLOCK * SCAN_BLOCK};
    for (long long task = t; task < 4 * next.len; task += T) {
      const int s = (int)(task & 3);
      const long long k = task >> 2;
      float* buf = scans + s * size + cur.off;
      const long long start = k * SCAN_BLOCK;
      const int count = top ? (int)cur.len : SCAN_BLOCK;  // the top level: at most 16
      float x[SCAN_BLOCK];  // the run's inputs, all loaded before the chain
#pragma unroll
      for (int j = 0; j < SCAN_BLOCK; ++j) {
        const long long i = start + j;
        x[j] = i >= cur.len ? 0.f : (l == 0 ? input(s, i) : buf[i]);  // the padding is 0
      }
      float acc = x[0];
#pragma unroll
      for (int j = 0; j < SCAN_BLOCK; ++j) {
        if (j > 0) acc = __fadd_rn(acc, x[j]);
        if (j < count) buf[start + j] = acc;
      }
      if (!top) scans[s * size + next.off + k] = acc;
    }
    __syncthreads();
    cur = next;
  }
  for (int l = levels - 1; l >= 0; --l) {
    const Level at = scan_level(n, l), above = scan_level(n, l + 1);
    for (long long task = t; task < 4 * at.len; task += T) {
      const int s = (int)(task & 3);
      const long long i = task >> 2, k = i / SCAN_BLOCK;
      float* buf = scans + s * size;
      buf[at.off + i] = __fadd_rn(buf[at.off + i], k == 0 ? 0.f : buf[above.off + k - 1]);
    }
    __syncthreads();
  }
  const float* w1 = scans;  // S(p)
  const float* s_pc = scans + size;  // S(p c)
  const float* rev_w = scans + 2 * size;
  const float* rev_pc = scans + 3 * size;

  // Otsu's variances; then its argmax, the peak and the nonempty bins at once
  for (int b = t; b < n - 1; b += T) {
    const float mean1 = __fdiv_rn(s_pc[b], clamp_min(w1[b], 1e-30f));
    const int r = n - 1 - (b + 1);  // weight2[b + 1] = rev_w[n - 2 - b]
    const float w2 = rev_w[r];
    const float mean2 = __fdiv_rn(rev_pc[r], clamp_min(rev_w[r], 1e-30f));
    const float gap = __fsub_rn(mean1, mean2);
    v12[b] = __fmul_rn(__fmul_rn(w1[b], w2), __fmul_rn(gap, gap));
  }
  __syncthreads();
  Best otsu_arg{0, 0}, peak_arg{0, 0};
  unsigned int low = n, high = 0;
  for (int b = t; b < n; b += T) {
    if (b < n - 1) take(otsu_arg, v12[b], b);
    take(peak_arg, p[b], b);
    if (p[b] > 0.f) {
      low = min(low, (unsigned int)b);
      high = max(high, (unsigned int)b + 1);
    }
  }
  block_bests_range(otsu_arg, peak_arg, low, high);
  const long long arg_low = low, arg_high = (long long)high - 1;
  const long long idx_otsu = otsu_arg.index;
  const float otsu = any ? centre(idx_otsu) : 0.f;
  const float criterion = v12[idx_otsu];

  // the triangle
  if (t == 0) {
    const long long arg_peak = peak_arg.index;
    const float peak_height = p[arg_peak];
    const bool flip = (arg_peak - arg_low) < (arg_high - arg_peak);
    const long long low_f = flip ? n - arg_high - 1 : arg_low;
    const long long peak_f = flip ? n - arg_peak - 1 : arg_peak;
    const float width = __ll2float_rn(peak_f - low_f);
    const float norm = __fsqrt_rn(__fmaf_rn(peak_height, peak_height, __fmul_rn(width, width)));
    ph_s = __fdiv_rn(peak_height, clamp_min(norm, 1e-30f));
    wd_s = __fdiv_rn(width, clamp_min(norm, 1e-30f));
    tri_s[0] = low_f;
    tri_s[1] = peak_f;
    flip_s = flip;
  }
  __syncthreads();
  const long long low_f = tri_s[0], peak_f = tri_s[1];
  const bool flip = flip_s;
  Best level_arg{0, 0};
  for (int b = t; b < n; b += T) {
    const float hist_f = flip ? p[n - 1 - b] : p[b];
    const bool valid = b >= low_f && b < peak_f;
    take(level_arg, valid ? __fmaf_rn(ph_s, __ll2float_rn(b - low_f), -__fmul_rn(wd_s, hist_f))
                          : -INFINITY, b);
  }
  level_arg = block_best(level_arg);
  if (t == 0) {
    long long level = peak_f > low_f && low_f < n ? level_arg.index : low_f;
    if (flip) level = n - level - 1;
    const float tri = any ? centre(level) : 0.f;
    tail.out[0] = otsu;
    tail.out[1] = criterion;
    tail.out[2] = tri;
    tail.out[3] = isnan(tri) ? tri : (isnan(otsu) ? otsu : (tri < otsu ? tri : otsu));
    if (tail.any_out) tail.any_out[0] = any;
  }
}

// at most 64 registers a thread, so that BLOCKS_PER_SM blocks fit on an SM
// at once: the tail inlined here would otherwise raise the count, and the
// grid would run in two waves
template <bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    masked_hist(const float* values, const unsigned char* mask, long long n, Head* head,
                Record record, Tail tail) {
  // nbins counts where nbins <= SHARED_BINS, then the last block's tail
  // where nbins <= TAIL_SHARED_BINS
  extern __shared__ __align__(16) unsigned char dynamic[];
  unsigned int* local = reinterpret_cast<unsigned int*>(dynamic);
  __shared__ bool last;
  const long long nbins = tail.nbins;
  const bool shared = nbins <= SHARED_BINS;
  if (shared)
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) local[b] = 0;
  const bool any = (head->lo_key | head->hi_key) != 0;
  const float lo = any ? key_value(~head->lo_key) : 0.f;
  const float hi = any ? key_value(head->hi_key) : 1.f;
  const float span = __fsub_rn(hi, lo);
  const float safe = span > 0.f ? span : 1.f;
  const float bins = __ll2float_rn(nbins);
  __syncthreads();
  auto bin = [&](float x) {
    const float q = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), safe), bins));
    // the float-to-int64 conversion, then the clamp to [0, nbins - 1]; NaN to 0
    const long long k = q >= 0.f ? __float2ll_rz(q) : 0;
    const long long b = k < nbins - 1 ? k : nbins - 1;
    if (shared)
      atomicAdd(local + b, 1u);
    else
      atomicAdd(tail.counts + b, 1ull);
  };
  const long long count = mask ? (long long)head->count : 0;
  if (mask && count <= record.cap) {  // the record, 16-byte aligned
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const float4* r4 = reinterpret_cast<const float4*>(record.values);
    for (long long q = first; q < count / 4; q += stride) {
      const float4 v = __ldcg(r4 + q);
      bin(v.x);
      bin(v.y);
      bin(v.z);
      bin(v.w);
    }
    for (long long i = count / 4 * 4 + first; i < count; i += stride) bin(__ldcg(record.values + i));
  } else {
    for_each_masked<VEC>(values, mask, n, bin);
  }
  __syncthreads();
  if (shared) {
    unsigned long long* copy = tail.counts + (blockIdx.x % COPIES) * nbins;
    for (int b = threadIdx.x; b < nbins; b += blockDim.x)
      if (local[b]) atomicAdd(copy + b, (unsigned long long)local[b]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&head->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* work = nbins <= TAIL_SHARED_BINS ? reinterpret_cast<float*>(dynamic) : tail.work;
  thresholds_tail(tail, work, lo, span, any);
}

// The scratch: the head, the counts (cleared by the call's memset), the
// tail's work area, the record (16-byte aligned).
struct Layout {
  long long counts, work, record, cap, bytes;
};

Layout layout(int nbins, long long n, bool masked) {
  Layout at;
  at.counts = (long long)sizeof(Head);
  at.work = at.counts + 8LL * count_copies(nbins) * nbins;
  const long long end = at.work + (nbins > TAIL_SHARED_BINS ? 4 * tail_floats(nbins) : 0);
  at.record = (end + 15) / 16 * 16;
  at.cap = masked ? (n < RECORD ? n : RECORD) : 0;
  at.bytes = at.record + 4 * at.cap;
  return at;
}

size_t dynamic_shared(long long nbins) {
  const long long counts = nbins <= SHARED_BINS ? 4 * nbins : 0;
  const long long tail = nbins <= TAIL_SHARED_BINS ? 4 * tail_floats(nbins) : 0;
  return (size_t)(counts > tail ? counts : tail);
}

}  // namespace

extern "C" {

// Bytes of device scratch a call needs for nbins bins over n values, with
// a mask or not: the head and the counts, the tail's work area past
// TAIL_SHARED_BINS bins, and the record where a mask is given.
long long hist_threshold_scratch(int nbins, long long n, int masked) {
  return layout(nbins, n, masked != 0).bytes;
}

// Otsu and triangle thresholds of values[mask] (float32, n values; mask
// bool bytes or null for all) over nbins (at least 2) bins: out 4 float32
// (Otsu, its criterion, triangle, their minimum) and any_out one bool byte,
// all on the device.  scratch: hist_threshold_scratch(nbins, n, mask !=
// null) bytes, 16-byte aligned.  kernels (host): the CUDA kernels launched.
int hist_threshold(const void* values, const void* mask, long long n, int nbins, void* scratch,
                   void* out, void* any_out, int* kernels, void* stream) {
  *kernels = 0;
  if (nbins < 2 || n < 0 || (uintptr_t)scratch % 16) return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const Layout at = layout(nbins, n, mask != nullptr);
  unsigned char* base = (unsigned char*)scratch;
  Head* head = (Head*)base;
  Tail tail;
  tail.counts = (unsigned long long*)(base + at.counts);
  tail.work = (float*)(base + at.work);
  tail.out = (float*)out;
  tail.any_out = (unsigned char*)any_out;
  tail.nbins = nbins;
  Record record;
  record.values = (float*)(base + at.record);
  record.cap = at.cap;
  cudaStream_t st = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(scratch, 0, at.work, st)) != cudaSuccess) return (int)err;
  const bool vec = (uintptr_t)values % 16 == 0 && (uintptr_t)mask % 16 == 0;
  const long long per_block = (long long)THREADS * (vec ? CHUNK : 1);
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  const float* v = (const float*)values;
  const unsigned char* m = (const unsigned char*)mask;
  const size_t shared = dynamic_shared(nbins);
  if (vec) {
    masked_range<true><<<grid, THREADS, 0, st>>>(v, m, n, head, record);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    masked_hist<true><<<grid, THREADS, shared, st>>>(v, m, n, head, record, tail);
  } else {
    masked_range<false><<<grid, THREADS, 0, st>>>(v, m, n, head, record);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    masked_hist<false><<<grid, THREADS, shared, st>>>(v, m, n, head, record, tail);
  }
  *kernels = 2;
  return (int)cudaGetLastError();
}

}  // extern "C"
