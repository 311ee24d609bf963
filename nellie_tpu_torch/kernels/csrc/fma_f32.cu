// Elementwise fused multiply-add out = a*b + c, rounded once to float32,
// for Hopper (sm_90a).
//
// Replaces the multiply-adds that XLA contracts in the JAX package's fused
// elementwise code (the separable filters of nellie_tpu/kernels/filters.py,
// the Hessian of nellie_tpu/kernels/hessian.py, the log and exp polynomials,
// the squared norms): XLA rounds each a*b + c once.  The port's plain
// version (kernels/_fp.py::fma_plain) gets the same value on any device by
// rounding to odd in float64; this kernel takes the hardware's fmaf
// (__fmaf_rn: one rounding, subnormals kept, since the file is built
// without fast math), so the two agree bit for bit on every operand but a
// NaN's payload.
//
// Operands are broadcast and may be strided views: each is a float32
// pointer with an element stride per output axis (0 along a broadcast
// axis), or a scalar when its pointer is null.  The wrapper merges the
// axes that every operand walks contiguously, so a call on contiguous
// tensors (or narrowed views along the first axis) runs with one axis and
// no index division; a view narrowed along an inner axis keeps two or
// three axes, one 32-bit division each.  The output is C-contiguous.
//
// What bounds it: memory, 12 bytes read and 4 written an element when all
// three operands are tensors.  One float32 pass replaces the plain
// version's float64 casts and two-sum.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct Operand {
  const float* ptr;  // null: the scalar value
  float value;
  long long stride[MAX_DIMS];
};

struct Shape {
  long long size[MAX_DIMS];
};

__device__ __forceinline__ float load(const Operand& op, long long offset) {
  return op.ptr ? __ldg(op.ptr + offset) : op.value;
}

template <typename Idx, int NDIM>
__global__ void __launch_bounds__(THREADS)
fma_kernel(float* __restrict__ out, Idx n, Shape shape, Operand a, Operand b, Operand c) {
  const Idx step = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += step) {
    long long oa = 0, ob = 0, oc = 0;
    Idx rest = i;
#pragma unroll
    for (int k = NDIM - 1; k >= 0; --k) {
      Idx coord = rest;
      if (k > 0) {
        const Idx size = (Idx)shape.size[k];
        const Idx outer = rest / size;
        coord = rest - outer * size;
        rest = outer;
      }
      oa += (long long)coord * a.stride[k];
      ob += (long long)coord * b.stride[k];
      oc += (long long)coord * c.stride[k];
    }
    out[i] = __fmaf_rn(load(a, oa), load(b, ob), load(c, oc));
  }
}

template <typename Idx>
cudaError_t launch(float* out, long long n, int ndim, const Shape& shape, const Operand& a,
                   const Operand& b, const Operand& c, cudaStream_t s) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int grid = (int)(blocks < cap ? blocks : cap);
  switch (ndim) {
    case 1: fma_kernel<Idx, 1><<<grid, THREADS, 0, s>>>(out, (Idx)n, shape, a, b, c); break;
    case 2: fma_kernel<Idx, 2><<<grid, THREADS, 0, s>>>(out, (Idx)n, shape, a, b, c); break;
    case 3: fma_kernel<Idx, 3><<<grid, THREADS, 0, s>>>(out, (Idx)n, shape, a, b, c); break;
    default: fma_kernel<Idx, 4><<<grid, THREADS, 0, s>>>(out, (Idx)n, shape, a, b, c); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n float32, C order over shape[0..ndim)) = a*b + c.  ptrs[k] is
// operand k's float32 data or null for the scalar values[k]; its element
// strides are strides[k * 4 + axis].
int fma_f32(void* out, long long n, int ndim, const long long* shape, const void* const* ptrs,
            const float* values, const long long* strides, void* stream) {
  if (n < 1 || ndim < 1 || ndim > MAX_DIMS) return (int)cudaErrorInvalidValue;
  Shape sh;
  Operand ops[3];
  for (int axis = 0; axis < MAX_DIMS; ++axis) sh.size[axis] = axis < ndim ? shape[axis] : 1;
  for (int k = 0; k < 3; ++k) {
    ops[k].ptr = (const float*)ptrs[k];
    ops[k].value = values[k];
    for (int axis = 0; axis < MAX_DIMS; ++axis)
      ops[k].stride[axis] = axis < ndim ? strides[k * MAX_DIMS + axis] : 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // 32-bit indices while the loop counter cannot wrap
  if (n < (1LL << 31))
    return (int)launch<unsigned int>((float*)out, n, ndim, sh, ops[0], ops[1], ops[2], s);
  return (int)launch<unsigned long long>((float*)out, n, ndim, sh, ops[0], ops[1], ops[2], s);
}

}  // extern "C"
