// Brute-force nearest-neighbour argmin for Hopper (sm_90a).
//
// Replaces nellie_tpu/kernels/pallas_nn.py::_nn_kernel (launched by
// nn_argmin_pallas).  For every query q it returns the minimum over the
// references r of d2 = (|q|^2 + |r|^2) - 2 q.r, and the index of the first
// reference that reaches it.
//
// What bounds it: O(Q * M * d) float32 arithmetic with d = 3 on the main
// path, and no reuse problem at all: a reference is 16 bytes and is used by
// every query.  So the kernel is bound by the fp32 pipes of the SMs
// (multiplies, adds, compare-selects), not by memory.
//
// Design: each thread keeps QPT queries (coordinates, |q|^2, running min and
// argmin) in registers; each block of THREADS threads owns THREADS * QPT
// queries and streams the references through shared memory in tiles of
// TILE rows, which every thread of the block reads by broadcast.  One
// reference load from shared memory feeds QPT queries.  |r|^2 is computed
// once per reference while the tile is staged.  The running minimum uses a
// strict '<' and references are visited in ascending order, so the first
// index wins a tie, as in the reference (jnp.argmin inside a tile, strict
// '<' across tiles).
//
// Rounding: the formula and its evaluation order are the reference's
// (q2 + r2) - 2 * cross, with fused multiply-adds made explicit and placed
// where XLA's CPU code puts them for the reference's tile-padded shapes:
// the dot q.r starts from the first product and adds each further product
// with one fused multiply-add (__fmaf_rn), in coordinate order; |q|^2 and
// |r|^2 round every square and add them left to right; everything else is
// __fmul_rn/__fadd_rn/__fsub_rn, which the compiler never contracts.  So the
// kernel's distances equal the JAX package's on the CPU bit for bit.  No
// TF32, no library GEMM.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int QPT = 4;
constexpr int TILE = 512;

template <int D>
__device__ __forceinline__ float sq_norm(const float* v) {
  float acc = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  return acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
nn_argmin_kernel(const float* __restrict__ queries, const float* __restrict__ refs,
                 int n_q, int n_r, float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ float tile[TILE][D + 1];  // coordinates, then |r|^2

  float q[QPT][D];
  float q2[QPT];
  float best[QPT];
  int best_i[QPT];
  const int base = blockIdx.x * THREADS * QPT + threadIdx.x;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = base + j * THREADS;
#pragma unroll
    for (int k = 0; k < D; ++k) q[j][k] = qi < n_q ? queries[(long long)qi * D + k] : 0.f;
    q2[j] = sq_norm<D>(q[j]);
    best[j] = CUDART_INF_F;
    best_i[j] = 0;
  }

  for (int start = 0; start < n_r; start += TILE) {
    const int rows = min(TILE, n_r - start);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += THREADS) {
      float v[D];
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = refs[(long long)(start + i) * D + k];
#pragma unroll
      for (int k = 0; k < D; ++k) tile[i][k] = v[k];
      tile[i][D] = sq_norm<D>(v);
    }
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      const float r2 = tile[i][D];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        float cross = __fmul_rn(q[j][0], tile[i][0]);
#pragma unroll
        for (int k = 1; k < D; ++k) cross = __fmaf_rn(q[j][k], tile[i][k], cross);
        const float d2 = __fsub_rn(__fadd_rn(q2[j], r2), __fmul_rn(2.f, cross));
        if (d2 < best[j]) {
          best[j] = d2;
          best_i[j] = start + i;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = base + j * THREADS;
    if (qi < n_q) {
      out_d2[qi] = best[j];
      out_idx[qi] = best_i[j];
    }
  }
}

template <int D>
void launch(const float* q, const float* r, int n_q, int n_r, float* d2, int* idx,
            cudaStream_t stream) {
  const int per_block = THREADS * QPT;
  const int blocks = (n_q + per_block - 1) / per_block;
  nn_argmin_kernel<D><<<blocks, THREADS, 0, stream>>>(q, r, n_q, n_r, d2, idx);
}

}  // namespace

// queries (n_q, dim) and refs (n_r, dim): contiguous float32 on the device,
// 1 <= dim <= 8, n_q >= 1, n_r >= 1.  Writes out_d2 (n_q,) and out_idx (n_q,).
// Returns a cudaError_t: cudaErrorInvalidValue for a bad dim, else the
// launch's cudaGetLastError().
extern "C" int nn_argmin_f32(const float* queries, const float* refs, int n_q, int n_r,
                             int dim, float* out_d2, int* out_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: launch<1>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 2: launch<2>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 3: launch<3>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 4: launch<4>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 5: launch<5>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 6: launch<6>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 7: launch<7>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    case 8: launch<8>(queries, refs, n_q, n_r, out_d2, out_idx, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
