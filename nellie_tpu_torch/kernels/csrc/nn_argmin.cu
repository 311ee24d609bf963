// Brute-force nearest-neighbour argmin for Hopper (sm_90a).
//
// Replaces nellie_tpu/kernels/pallas_nn.py::_nn_kernel (launched by
// nn_argmin_pallas, pl.pallas_call at pallas_nn.py:72).  For every query q
// it returns the minimum over the references r of
// d2 = (|q|^2 + |r|^2) - 2 q.r, and the index of the first reference that
// reaches it.
//
// What bounds it: Q * M pairs of float32 arithmetic (at d = 3: one multiply
// and two fused multiply-adds for q.r, one add and one fused multiply-add
// for d2, and the running minimum), and almost no memory traffic: a
// reference is 16 bytes and every query uses it.  So the kernel is bound by
// the rate at which the SMs issue instructions, not by memory: every
// instruction a pair costs counts.
//
// Design, in three kernels launched by one C call:
//
// 1. pack_refs: each reference becomes one row of ROW = 4 * V floats in
//    device memory, (coordinates, |r|^2, zeros), V float4s wide (one for
//    d <= 3).  |r|^2 is computed once per reference.
// 2. split_kernel: the grid is (query tiles) x (reference splits).  Each
//    thread keeps QPT queries (coordinates, |q|^2, running min and argmin)
//    in registers, so a block of T threads owns T * QPT queries.  The block
//    streams its split of the references through shared memory in tiles of
//    R_TILE rows, double-buffered with cp.async so that the next tile's copy
//    overlaps this tile's arithmetic.  Every thread reads each row with one
//    broadcast 16-byte shared load per float4, which feeds its QPT queries.
//    The running minimum takes no branch and costs about one instruction
//    a pair: the rows come in groups of GROUP, each query keeps the minimum
//    of a group with fminf (one FMNMX a pair), and only the group's minimum
//    goes through the strict '<' and the two selects that keep the best
//    value and the group's first index.  Groups are visited in ascending
//    order, so the kept group is the first that reaches the block's
//    minimum.  After its last tile the block recomputes, for each query,
//    the GROUP distances of the kept group from device memory (the same
//    instructions give the same bits) and takes the first index whose
//    distance equals the minimum.  Rows after the last whole group of a
//    tile take the compare and selects one by one.  (One compare and two
//    selects for every pair made the kernel slower on the card.)
//    At the end each block merges its result for
//    each query into a 64-bit key with atomicMin: the high half is d2 mapped
//    to an order-preserving uint32 (sign bit flipped for a non-negative
//    float, all bits flipped for a negative one; d2 can be slightly
//    negative through cancellation; -0 is first made +0), the low half the
//    index.  The smallest key is the smallest d2 and, among equal d2, the
//    lowest index, whatever order the blocks run in: the first index that
//    reaches the minimum, as in the reference (jnp.argmin inside a tile,
//    strict '<' across tiles).  Splitting the reference axis is what fills
//    the 132 SMs when there are few queries; the launch plan (query tile,
//    splits, reference tile) is chosen in Python (kernels/nn.py::launch_plan)
//    and checked here.
// 3. unpack_keys: the keys become the (Q,) float32 d2 and (Q,) int32 index.
//    The caller fills the keys with all ones before the call.
//
// Rounding: the formula and its evaluation order are the reference's: the
// dot q.r starts from the first product and adds each further product with
// one fused multiply-add (__fmaf_rn), in coordinate order; |q|^2 and |r|^2
// round every square and add them left to right; d2 is
// __fmaf_rn(-2, q.r, |q|^2 + |r|^2), which equals (|q|^2 + |r|^2) - 2 q.r
// rounded twice, because 2 q.r is exact.  The compiler never contracts the
// __f*_rn intrinsics.  So the distances equal the plain version's and the
// JAX package's on the CPU bit for bit.
//
// No tensor cores: at d = 3 a TF32 mma pads the contraction to K = 8 (5/8
// of it wasted), and TF32 keeps 10 mantissa bits, so float32 accuracy takes
// three products (3xTF32): about 48 tensor flops a pair at 495 TFLOP/s
// against 8 flops at 67 TFLOP/s on the fp32 pipes, some 20 % less time on
// paper before the extra passes, and bit parity would need an exact
// re-check of the candidates on top.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry point returns the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int QPT = 12;          // queries per thread
constexpr int GROUP = 16;        // reference rows per running-minimum group
constexpr int R_TILE = 128;      // reference rows per shared-memory tile
constexpr int MAX_THREADS = 128; // threads per block of split_kernel, at most
constexpr int AUX_THREADS = 256; // threads per block of pack_refs and unpack_keys

template <int D>
struct Row {
  static constexpr int V = (D + 4) / 4;  // float4s per packed row: D coordinates, |r|^2
};

template <int D>
__device__ __forceinline__ float sq_norm(const float* v) {
  float acc = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  return acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long make_key(float d2, int idx) {
  const unsigned u = __float_as_uint(__fadd_rn(d2, 0.f));  // -0 -> +0
  const unsigned m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) | static_cast<unsigned>(idx);
}

// Starts the copy of the packed rows [start, min(start + R_TILE, r_end))
// into dst, 16 bytes a thread at a time, as one cp.async group.
template <int V>
__device__ __forceinline__ void stage_tile(float4* dst, const float4* rows, int start, int r_end) {
  const int chunks = min(R_TILE, r_end - start) * V;
  const float4* src = rows + static_cast<long long>(start) * V;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) cp_async16(dst + c, src + c);
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(AUX_THREADS)
pack_refs(const float* __restrict__ refs, int n_r, float4* __restrict__ rows) {
  constexpr int V = Row<D>::V;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_r) return;
  float v[4 * V];
#pragma unroll
  for (int k = 0; k < 4 * V; ++k) v[k] = k < D ? refs[i * D + k] : 0.f;
  v[D] = sq_norm<D>(v);
#pragma unroll
  for (int c = 0; c < V; ++c)
    rows[i * V + c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

template <int V>
__device__ __forceinline__ void load_row(const float4* p, float* r) {
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const float4 a = p[c];
    r[4 * c] = a.x;
    r[4 * c + 1] = a.y;
    r[4 * c + 2] = a.z;
    r[4 * c + 3] = a.w;
  }
}

// d2 of query q (|q|^2 = q2) and the packed row r (coordinates, |r|^2).
template <int D>
__device__ __forceinline__ float pair_d2(const float* q, float q2, const float* r) {
  float cross = __fmul_rn(q[0], r[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) cross = __fmaf_rn(q[k], r[k], cross);
  return __fmaf_rn(-2.f, cross, __fadd_rn(q2, r[D]));
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
split_kernel(const float* __restrict__ queries, const float4* __restrict__ rows, int n_q,
             int n_r, int split_len, unsigned long long* __restrict__ keys) {
  constexpr int V = Row<D>::V;
  __shared__ __align__(16) float4 tile[2][R_TILE * V];

  float q[QPT][D];
  float q2[QPT];
  float best[QPT];
  int best_i[QPT];  // the index of best, or the first index of its group
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x * QPT + threadIdx.x;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const long long qi = base + static_cast<long long>(j) * blockDim.x;
#pragma unroll
    for (int k = 0; k < D; ++k) q[j][k] = qi < n_q ? queries[qi * D + k] : 0.f;
    q2[j] = sq_norm<D>(q[j]);
    best[j] = CUDART_INF_F;
    best_i[j] = 0;
  }

  const long long r_begin = static_cast<long long>(blockIdx.y) * split_len;
  const int r_end = static_cast<int>(min(r_begin + split_len, static_cast<long long>(n_r)));
  const int first = static_cast<int>(r_begin);
  const int n_tiles = (r_end - first + R_TILE - 1) / R_TILE;

  stage_tile<V>(tile[0], rows, first, r_end);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_tile<V>(tile[(t + 1) & 1], rows, first + (t + 1) * R_TILE, r_end);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* buf = tile[t & 1];
    const int start = first + t * R_TILE;
    const int n_rows = min(R_TILE, r_end - start);
    int i = 0;
    for (; i + GROUP <= n_rows; i += GROUP) {
      float m[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) m[j] = CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        float r[4 * V];
        load_row<V>(buf + (i + u) * V, r);
#pragma unroll
        for (int j = 0; j < QPT; ++j) m[j] = fminf(m[j], pair_d2<D>(q[j], q2[j], r));
      }
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const bool lt = m[j] < best[j];
        best[j] = lt ? m[j] : best[j];
        best_i[j] = lt ? start + i : best_i[j];
      }
    }
    for (; i < n_rows; ++i) {
      float r[4 * V];
      load_row<V>(buf + i * V, r);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float d2 = pair_d2<D>(q[j], q2[j], r);
        const bool lt = d2 < best[j];
        best[j] = lt ? d2 : best[j];
        best_i[j] = lt ? start + i : best_i[j];
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  // the first index of the kept group (or the kept row) whose distance
  // equals the minimum; index 0 where nothing was below +inf
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int g = best[j] < CUDART_INF_F ? best_i[j] : first;
    int found = g;
#pragma unroll
    for (int u = GROUP - 1; u >= 0; --u) {
      if (g + u < r_end) {
        float r[4 * V];
        load_row<V>(rows + static_cast<long long>(g + u) * V, r);
        found = pair_d2<D>(q[j], q2[j], r) == best[j] ? g + u : found;
      }
    }
    const long long qi = base + static_cast<long long>(j) * blockDim.x;
    if (qi < n_q) atomicMin(keys + qi, make_key(best[j], best[j] < CUDART_INF_F ? found : 0));
  }
}

__global__ void __launch_bounds__(AUX_THREADS)
unpack_keys(const unsigned long long* __restrict__ keys, int n_q, float* __restrict__ d2,
            int* __restrict__ idx) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const unsigned long long key = keys[i];
  const unsigned m = static_cast<unsigned>(key >> 32);
  d2[i] = __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
  idx[i] = static_cast<int>(static_cast<unsigned>(key));
}

template <int D>
int launch(const float* q, const float* r, int n_q, int n_r, int threads, int splits,
           int split_len, float* packed, unsigned long long* keys, float* d2, int* idx,
           cudaStream_t stream) {
  float4* rows = reinterpret_cast<float4*>(packed);
  pack_refs<D><<<(n_r + AUX_THREADS - 1) / AUX_THREADS, AUX_THREADS, 0, stream>>>(r, n_r, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tile = threads * QPT;
  const dim3 grid((n_q + q_tile - 1) / q_tile, splits);
  split_kernel<D><<<grid, threads, 0, stream>>>(q, rows, n_q, n_r, split_len, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_keys<<<(n_q + AUX_THREADS - 1) / AUX_THREADS, AUX_THREADS, 0, stream>>>(keys, n_q, d2,
                                                                                 idx);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int info(int* regs, int* local_bytes, int* resident_warps) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, split_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, split_kernel<D>, MAX_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *resident_warps = blocks * MAX_THREADS / 32;
  return 0;
}

}  // namespace

// queries (n_q, dim) and refs (n_r, dim): contiguous float32 on the device,
// 1 <= dim <= 8, n_q >= 1, n_r >= 1.  The launch plan: `threads` per block
// (a multiple of 32, at most 128), `splits` reference splits of `split_len`
// rows that cover the references with none empty; `qpt` and `r_tile` must
// be this build's QPT and R_TILE.  Scratch: `packed` holds n_r rows of
// 4 * ((dim + 4) / 4) floats, 16-byte aligned; `keys` (n_q,) filled with all
// ones.  Writes out_d2 (n_q,) and out_idx (n_q,).  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments outside the above, else the launches'
// first cudaGetLastError() that is not cudaSuccess.
extern "C" int nn_argmin_f32(const float* queries, const float* refs, int n_q, int n_r, int dim,
                             int threads, int splits, int split_len, int qpt, int r_tile,
                             float* packed, unsigned long long* keys, float* out_d2,
                             int* out_idx, void* stream) {
  const bool bad_plan = qpt != QPT || r_tile != R_TILE || threads < 32 ||
                        threads > MAX_THREADS || threads % 32 != 0 || splits < 1 ||
                        splits > 65535 || split_len < 1 ||
                        static_cast<long long>(splits) * split_len < n_r ||
                        static_cast<long long>(splits - 1) * split_len >= n_r;
  if (n_q < 1 || n_r < 1 || bad_plan) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_CASE(D) \
  case D:          \
    return launch<D>(queries, refs, n_q, n_r, threads, splits, split_len, packed, keys, out_d2, out_idx, s);
  switch (dim) {
    NN_CASE(1)
    NN_CASE(2)
    NN_CASE(3)
    NN_CASE(4)
    NN_CASE(5)
    NN_CASE(6)
    NN_CASE(7)
    NN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NN_CASE
}

// The build's constants and split_kernel<dim>'s registers per thread, local
// (spill) bytes per thread and resident warps per SM at MAX_THREADS threads
// a block, on the current device.
extern "C" int nn_argmin_info(int dim, int* qpt, int* r_tile, int* max_threads, int* regs,
                              int* local_bytes, int* resident_warps) {
  *qpt = QPT;
  *r_tile = R_TILE;
  *max_threads = MAX_THREADS;
  switch (dim) {
    case 1: return info<1>(regs, local_bytes, resident_warps);
    case 2: return info<2>(regs, local_bytes, resident_warps);
    case 3: return info<3>(regs, local_bytes, resident_warps);
    case 4: return info<4>(regs, local_bytes, resident_warps);
    case 5: return info<5>(regs, local_bytes, resident_warps);
    case 6: return info<6>(regs, local_bytes, resident_warps);
    case 7: return info<7>(regs, local_bytes, resident_warps);
    case 8: return info<8>(regs, local_bytes, resident_warps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
