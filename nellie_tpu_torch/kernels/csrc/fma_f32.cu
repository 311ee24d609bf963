// Elementwise fused multiply-add out = a*b + c, rounded once to float32, and
// straight-line chains of such steps in one pass, for Hopper (sm_90a).
//
// Replaces the multiply-adds that XLA contracts in the JAX package's fused
// elementwise code (the thresholds of nellie_tpu/kernels/thresholds.py, the
// log and exp polynomials, the squared norms, the moments' dot products):
// XLA rounds each a*b + c once.  The port's plain version
// (kernels/_fp.py::fma_plain) gets the same value on any device by rounding
// to odd in float64; this file takes the hardware's fmaf (__fmaf_rn: one
// rounding, subnormals kept, since it is built without -fmad and without
// -ftz), so the two agree bit for bit on every operand but a NaN's payload.
//
// Two entry points.
//  * fma_f32 / fma_f32_flat: one multiply-add.  Each operand is a tensor
//    (a float32 pointer with an element stride per output axis) or a
//    broadcast value (a number, or a pointer every output reads).  The
//    operand kinds are template parameters, so the loop has no branch on
//    them; when every tensor operand walks the output contiguously and is
//    16-byte aligned, a thread loads and stores four elements at a time
//    (float4), else the strided path keeps one element a thread.
//  * fma_chain: a program of at most MAX_STEPS steps over REGS float
//    registers, each step r = fma(X, Y, Z), X * Y or X + Y (__fmaf_rn,
//    __fmul_rn, __fadd_rn), where X, Y and Z are each a register, one of at
//    most MAX_LOADS loads (a tensor slot at an element offset: the views
//    x[..., k] of one tensor are one slot at offsets k), or a float32
//    constant.  One pass: every load is read once into registers, the
//    program runs on four elements a thread, and the last step's value is
//    written once.  The wrapper (kernels/_fp.py::chain) builds the
//    programs of sum_of_products, reduce_sum_of_squares, contract and the
//    log and exp polynomials, whose plain versions round the same steps.
//
// What bounds both: memory, each distinct tensor element read once and the
// result written once, at 4 bytes each.  The chain's decoding is uniform
// over the grid (every thread runs the same step), so a step costs a few
// register moves an element beside its one operation.
//
// The SM count is cached once per device.  The kernels allocate nothing
// and launch on the caller's stream; the C entry points return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;

int sm_count() {
  static int cache[MAX_DEVICES] = {0};
  int device = 0;
  cudaGetDevice(&device);
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && cache[device] > 0) return cache[device];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) sms = 132;
  if (cached) cache[device] = sms;
  return sms;
}

int grid_for(long long work, int blocks_per_sm) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * blocks_per_sm;
  const long long grid = blocks < cap ? blocks : cap;
  return (int)(grid > 0 ? grid : 1);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// ---------------------------------------------------------------- one step

struct Single {
  const float* ptr[3];  // a broadcast operand: null for the number value[k]
  float value[3];
  long long stride[3][MAX_DIMS];
  long long size[MAX_DIMS];
};

// bit k of KINDS: operand k is a tensor that the output walks; otherwise it
// is one value, read once a thread
template <int KINDS, int K>
__device__ __forceinline__ float broadcast(const Single& s) {
  if (KINDS & (1 << K)) return 0.0f;
  return s.ptr[K] ? s.ptr[K][0] : s.value[K];
}

template <int KINDS>
__device__ __forceinline__ float4 fma4(const float4* a4, const float4* b4, const float4* c4,
                                       float va, float vb, float vc, long long q) {
  constexpr bool TA = KINDS & 1, TB = KINDS & 2, TC = KINDS & 4;
  const float4 a = TA ? __ldg(a4 + q) : make_float4(va, va, va, va);
  const float4 b = TB ? __ldg(b4 + q) : make_float4(vb, vb, vb, vb);
  const float4 c = TC ? __ldg(c4 + q) : make_float4(vc, vc, vc, vc);
  return make_float4(__fmaf_rn(a.x, b.x, c.x), __fmaf_rn(a.y, b.y, c.y),
                     __fmaf_rn(a.z, b.z, c.z), __fmaf_rn(a.w, b.w, c.w));
}

// Two float4 a thread an iteration, both loads issued before either result.
template <int KINDS, typename Idx>
__global__ void __launch_bounds__(THREADS)
fma_vec(float* __restrict__ out, Idx n, Single s) {
  constexpr bool TA = KINDS & 1, TB = KINDS & 2, TC = KINDS & 4;
  const float va = broadcast<KINDS, 0>(s), vb = broadcast<KINDS, 1>(s),
              vc = broadcast<KINDS, 2>(s);
  const float4* a4 = reinterpret_cast<const float4*>(s.ptr[0]);
  const float4* b4 = reinterpret_cast<const float4*>(s.ptr[1]);
  const float4* c4 = reinterpret_cast<const float4*>(s.ptr[2]);
  float4* o4 = reinterpret_cast<float4*>(out);
  const Idx quads = n >> 2;
  const Idx step = (Idx)gridDim.x * THREADS;
  for (Idx q = (Idx)blockIdx.x * THREADS + threadIdx.x; q < quads; q += 2 * step) {
    const float4 r0 = fma4<KINDS>(a4, b4, c4, va, vb, vc, q);
    if (q + step < quads) {
      const float4 r1 = fma4<KINDS>(a4, b4, c4, va, vb, vc, q + step);
      o4[q + step] = r1;
    }
    o4[q] = r0;
  }
  // the last n % 4 elements
  const Idx i = (quads << 2) + (Idx)blockIdx.x * THREADS + threadIdx.x;
  if (i < n && blockIdx.x * THREADS + threadIdx.x < 4) {
    out[i] = __fmaf_rn(TA ? __ldg(s.ptr[0] + i) : va, TB ? __ldg(s.ptr[1] + i) : vb,
                       TC ? __ldg(s.ptr[2] + i) : vc);
  }
}

template <int KINDS, int NDIM, typename Idx>
__global__ void __launch_bounds__(THREADS)
fma_strided(float* __restrict__ out, Idx n, Single s) {
  constexpr bool TA = KINDS & 1, TB = KINDS & 2, TC = KINDS & 4;
  const float va = broadcast<KINDS, 0>(s), vb = broadcast<KINDS, 1>(s),
              vc = broadcast<KINDS, 2>(s);
  const Idx step = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += step) {
    long long oa = 0, ob = 0, oc = 0;
    Idx rest = i;
#pragma unroll
    for (int k = NDIM - 1; k >= 0; --k) {
      Idx coord = rest;
      if (k > 0) {
        const Idx size = (Idx)s.size[k];
        const Idx outer = rest / size;
        coord = rest - outer * size;
        rest = outer;
      }
      if (TA) oa += (long long)coord * s.stride[0][k];
      if (TB) ob += (long long)coord * s.stride[1][k];
      if (TC) oc += (long long)coord * s.stride[2][k];
    }
    out[i] = __fmaf_rn(TA ? __ldg(s.ptr[0] + oa) : va, TB ? __ldg(s.ptr[1] + ob) : vb,
                       TC ? __ldg(s.ptr[2] + oc) : vc);
  }
}

template <int KINDS, typename Idx>
cudaError_t launch_single(float* out, long long n, int ndim, bool vec, const Single& s,
                          cudaStream_t st) {
  if (vec) {
    const long long quads = n >> 2;
    fma_vec<KINDS, Idx><<<grid_for((quads > 8 ? quads : 8) / 2, BLOCKS_PER_SM), THREADS, 0,
                          st>>>(out, (Idx)n, s);
    return cudaGetLastError();
  }
  const int grid = grid_for(n, BLOCKS_PER_SM);
  switch (ndim) {
    case 1: fma_strided<KINDS, 1, Idx><<<grid, THREADS, 0, st>>>(out, (Idx)n, s); break;
    case 2: fma_strided<KINDS, 2, Idx><<<grid, THREADS, 0, st>>>(out, (Idx)n, s); break;
    case 3: fma_strided<KINDS, 3, Idx><<<grid, THREADS, 0, st>>>(out, (Idx)n, s); break;
    default: fma_strided<KINDS, 4, Idx><<<grid, THREADS, 0, st>>>(out, (Idx)n, s); break;
  }
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t dispatch_single(int kinds, float* out, long long n, int ndim, bool vec,
                            const Single& s, cudaStream_t st) {
  switch (kinds) {
    case 0: return launch_single<0, Idx>(out, n, ndim, vec, s, st);
    case 1: return launch_single<1, Idx>(out, n, ndim, vec, s, st);
    case 2: return launch_single<2, Idx>(out, n, ndim, vec, s, st);
    case 3: return launch_single<3, Idx>(out, n, ndim, vec, s, st);
    case 4: return launch_single<4, Idx>(out, n, ndim, vec, s, st);
    case 5: return launch_single<5, Idx>(out, n, ndim, vec, s, st);
    case 6: return launch_single<6, Idx>(out, n, ndim, vec, s, st);
    default: return launch_single<7, Idx>(out, n, ndim, vec, s, st);
  }
}

// Operand k is broadcast when every stride is 0; the float4 path needs the
// others to walk one axis contiguously from a 16-byte boundary.
cudaError_t run_single(float* out, long long n, int ndim, Single& s, cudaStream_t st) {
  int kinds = 0;
  bool vec = ndim == 1 && aligned16(out);
  for (int k = 0; k < 3; ++k) {
    bool walks = false;
    for (int axis = 0; axis < ndim; ++axis) walks = walks || (s.ptr[k] && s.stride[k][axis]);
    if (walks) {
      kinds |= 1 << k;
      vec = vec && s.stride[k][0] == 1 && aligned16(s.ptr[k]);
    }
  }
  if (n < (1LL << 31)) return dispatch_single<unsigned int>(kinds, out, n, ndim, vec, s, st);
  return dispatch_single<unsigned long long>(kinds, out, n, ndim, vec, s, st);
}

// ------------------------------------------------------------------ chains

constexpr int MAX_SLOTS = 8;
constexpr int MAX_LOADS = 16;
constexpr int MAX_STEPS = 16;
constexpr int REGS = 4;
constexpr int SRC_LOAD = REGS;                // sources REGS .. REGS + MAX_LOADS - 1
constexpr int SRC_CONST = REGS + MAX_LOADS;  // the step's own constant
constexpr int OP_FMA = 0, OP_MUL = 1, OP_ADD = 2;
constexpr int V = 4;  // elements a thread

struct Program {
  long long size[MAX_DIMS];
  long long stride[MAX_SLOTS][MAX_DIMS];
  const float* base[MAX_SLOTS];
  long long offset[MAX_LOADS];
  int slot[MAX_LOADS];
  float konst[MAX_STEPS][3];
  unsigned char op[MAX_STEPS], dst[MAX_STEPS], src[MAX_STEPS][3];
  int ndim, n_loads, n_steps;
};

__device__ __forceinline__ void copy(float (&to)[V], const float (&from)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) to[e] = from[e];
}

// Every case indexes the arrays with constants, so they stay in registers;
// the code is the same for the whole grid, so the branch never diverges.
__device__ __forceinline__ void fetch(int code, float k, float (&v)[V], const float (&r)[REGS][V],
                                      const float (&l)[MAX_LOADS][V]) {
  switch (code) {
    case 0: copy(v, r[0]); break;
    case 1: copy(v, r[1]); break;
    case 2: copy(v, r[2]); break;
    case 3: copy(v, r[3]); break;
#define LOAD_CASE(j) \
  case SRC_LOAD + j: copy(v, l[j]); break;
    LOAD_CASE(0) LOAD_CASE(1) LOAD_CASE(2) LOAD_CASE(3) LOAD_CASE(4) LOAD_CASE(5) LOAD_CASE(6)
    LOAD_CASE(7) LOAD_CASE(8) LOAD_CASE(9) LOAD_CASE(10) LOAD_CASE(11) LOAD_CASE(12)
    LOAD_CASE(13) LOAD_CASE(14) LOAD_CASE(15)
#undef LOAD_CASE
    default:
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = k;
  }
}

template <int NDIM>
struct Coords {
  long long c[V][NDIM > 0 ? NDIM : 1];
};

// the output coordinates of elements i0 .. i0 + V - 1 (the last one for
// those past n)
template <int NDIM, typename Idx>
__device__ __forceinline__ void coords_of(const Program& p, Idx i0, Idx n, Coords<NDIM>& at) {
  if (NDIM == 0) return;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    Idx rest = i0 + e < n ? i0 + e : n - 1;
#pragma unroll
    for (int k = (NDIM > 0 ? NDIM : 1) - 1; k >= 0; --k) {
      if (k > 0) {
        const Idx size = (Idx)p.size[k];
        const Idx outer = rest / size;
        at.c[e][k] = (long long)(rest - outer * size);
        rest = outer;
      } else {
        at.c[e][k] = (long long)rest;
      }
    }
  }
}

// load j at elements i0 .. i0 + V - 1: one float4 where the slot walks the
// output contiguously from a 16-byte boundary
template <int NDIM, typename Idx>
__device__ __forceinline__ void load(const Program& p, int j, Idx i0, Idx n, bool full,
                                     const Coords<NDIM>& at, float (&v)[V]) {
  const int slot = p.slot[j];
  const float* src = p.base[slot] + p.offset[j];
  if (NDIM == 0) {
    if (full && aligned16(src + i0)) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src + i0));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = i0 + e < n ? __ldg(src + i0 + e) : 0.0f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      long long off = 0;
#pragma unroll
      for (int k = 0; k < (NDIM > 0 ? NDIM : 1); ++k) off += at.c[e][k] * p.stride[slot][k];
      v[e] = i0 + e < n ? __ldg(src + off) : 0.0f;
    }
  }
}

__device__ __forceinline__ void apply(int op, const float (&x)[V], const float (&y)[V],
                                      const float (&z)[V], float (&t)[V]) {
  if (op == OP_FMA) {
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = __fmaf_rn(x[e], y[e], z[e]);
  } else if (op == OP_MUL) {
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = __fmul_rn(x[e], y[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = __fadd_rn(x[e], y[e]);
  }
}

__device__ __forceinline__ void put(int dst, float (&r)[REGS][V], const float (&t)[V]) {
  switch (dst) {
    case 0: copy(r[0], t); break;
    case 1: copy(r[1], t); break;
    case 2: copy(r[2], t); break;
    default: copy(r[3], t); break;
  }
}

template <typename Idx>
__device__ __forceinline__ void store(float* out, Idx i0, Idx n, bool full, const float (&t)[V]) {
  if (full && aligned16(out + i0)) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(t[0], t[1], t[2], t[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (i0 + e < n) out[i0 + e] = t[e];
  }
}

// The general program: every load read up front, then the steps with
// their codes read from the parameters.  NDIM 0: every slot walks the
// output with stride 1; otherwise NDIM strided axes.
template <int NDIM, typename Idx>
__global__ void __launch_bounds__(THREADS)
chain_kernel(float* __restrict__ out, Idx n, Program p) {
  const Idx quads = (n + V - 1) / V;
  const Idx step = (Idx)gridDim.x * THREADS;
  for (Idx q = (Idx)blockIdx.x * THREADS + threadIdx.x; q < quads; q += step) {
    const Idx i0 = q * V;
    const bool full = i0 + V <= n;
    Coords<NDIM> at;
    coords_of<NDIM>(p, i0, n, at);
    float l[MAX_LOADS][V];
#pragma unroll
    for (int j = 0; j < MAX_LOADS; ++j)
      if (j < p.n_loads) load<NDIM>(p, j, i0, n, full, at, l[j]);
    float r[REGS][V], t[V];
    for (int s = 0; s < p.n_steps; ++s) {
      float x[V], y[V], z[V];
      fetch(p.src[s][0], p.konst[s][0], x, r, l);
      fetch(p.src[s][1], p.konst[s][1], y, r, l);
      if (p.op[s] == OP_FMA) fetch(p.src[s][2], p.konst[s][2], z, r, l);
      apply(p.op[s], x, y, z, t);
      put(p.dst[s], r, t);
    }
    store(out, i0, n, full, t);
  }
}

// Programs compiled in full: each step's code is a constant, so every
// register and load index folds and the program is straight-line code.
// A code packs op | dst << 4 | source a << 8 | b << 16 | c << 24, sources as
// in Program (0..3 a register, SRC_LOAD + j load j, SRC_CONST the step's
// constant); loads are numbered in order of first use.  These are the
// programs of kernels/_fp.py's _log_polynomial, _exp_polynomial and
// contract's lane sum; the wrapper sends a program here only when its codes
// equal the table (tests/test_torch_fma_chain.py reads the tables back).
constexpr int KIND_GENERAL = 0, KIND_ACCUMULATE = 1, KIND_LOG = 2, KIND_EXP = 3,
              KIND_LANES = 4;
#define STEP(op, dst, a, b, c) \
  ((uint32_t)(op) | (uint32_t)(dst) << 4 | (uint32_t)(a) << 8 | (uint32_t)(b) << 16 | \
   (uint32_t)(c) << 24)
#define L(j) (SRC_LOAD + (j))
#define K SRC_CONST

template <int KIND>
struct Fixed;

template <>
struct Fixed<KIND_LOG> {  // r = L0, e = L1
  static constexpr int STEPS = 15, LOADS = 2;
  __device__ static __forceinline__ uint32_t code(int s) {
    constexpr uint32_t c[STEPS] = {
        STEP(OP_FMA, 0, L(0), K, K),  STEP(OP_FMA, 0, 0, L(0), K),   STEP(OP_FMA, 1, L(0), K, K),
        STEP(OP_FMA, 1, 1, L(0), K),  STEP(OP_MUL, 2, L(0), L(0), K), STEP(OP_MUL, 3, 2, L(0), K),
        STEP(OP_FMA, 0, 0, 3, 1),     STEP(OP_FMA, 1, L(0), K, K),   STEP(OP_FMA, 1, 1, L(0), K),
        STEP(OP_FMA, 0, 0, 3, 1),     STEP(OP_MUL, 1, L(1), K, K),   STEP(OP_FMA, 0, 0, 3, 1),
        STEP(OP_FMA, 1, K, 2, L(0)),  STEP(OP_ADD, 1, 1, 0, K),      STEP(OP_FMA, 0, K, L(1), 1)};
    return c[s];
  }
};

template <>
struct Fixed<KIND_EXP> {  // n = L0, x = L1
  static constexpr int STEPS = 10, LOADS = 2;
  __device__ static __forceinline__ uint32_t code(int s) {
    constexpr uint32_t c[STEPS] = {
        STEP(OP_FMA, 0, K, L(0), L(1)), STEP(OP_FMA, 0, K, L(0), 0), STEP(OP_FMA, 1, 0, K, K),
        STEP(OP_FMA, 1, 1, 0, K),       STEP(OP_FMA, 1, 1, 0, K),    STEP(OP_FMA, 1, 1, 0, K),
        STEP(OP_FMA, 1, 1, 0, K),       STEP(OP_MUL, 2, 0, 0, K),    STEP(OP_FMA, 1, 1, 2, 0),
        STEP(OP_ADD, 1, K, 1, K)};
    return c[s];
  }
};

template <>
struct Fixed<KIND_LANES> {  // (L0 + L1) + (L2 + L3)
  static constexpr int STEPS = 3, LOADS = 4;
  __device__ static __forceinline__ uint32_t code(int s) {
    constexpr uint32_t c[STEPS] = {STEP(OP_ADD, 0, L(0), L(1), K), STEP(OP_ADD, 1, L(2), L(3), K),
                                   STEP(OP_ADD, 0, 0, 1, K)};
    return c[s];
  }
};
#undef STEP
#undef L
#undef K

template <int KIND, int NDIM, typename Idx>
__global__ void __launch_bounds__(THREADS)
chain_fixed(float* __restrict__ out, Idx n, Program p) {
  using F = Fixed<KIND>;
  const Idx quads = (n + V - 1) / V;
  const Idx step = (Idx)gridDim.x * THREADS;
  for (Idx q = (Idx)blockIdx.x * THREADS + threadIdx.x; q < quads; q += step) {
    const Idx i0 = q * V;
    const bool full = i0 + V <= n;
    Coords<NDIM> at;
    coords_of<NDIM>(p, i0, n, at);
    float l[MAX_LOADS][V];
#pragma unroll
    for (int j = 0; j < F::LOADS; ++j) load<NDIM>(p, j, i0, n, full, at, l[j]);
    float r[REGS][V], t[V];
#pragma unroll
    for (int s = 0; s < F::STEPS; ++s) {
      const uint32_t c = F::code(s);
      const int op = c & 15, a = (c >> 8) & 255, b = (c >> 16) & 255, cz = (c >> 24) & 255;
      float x[V], y[V], z[V];
      fetch(a, p.konst[s][0], x, r, l);
      fetch(b, p.konst[s][1], y, r, l);
      if (op == OP_FMA) fetch(cz, p.konst[s][2], z, r, l);
      apply(op, x, y, z, t);
      put((c >> 4) & 15, r, t);
    }
    store(out, i0, n, full, t);
  }
}

// a source of an accumulating program: a load or the step's constant
template <int NDIM, typename Idx>
__device__ __forceinline__ void source(const Program& p, int s, int a, Idx i0, Idx n, bool full,
                                       const Coords<NDIM>& at, float (&v)[V]) {
  const int code = p.src[s][a];
  if (code == SRC_CONST) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = p.konst[s][a];
  } else {
    load<NDIM>(p, code - SRC_LOAD, i0, n, full, at, v);
  }
}

// acc = the first step of loads and constants, then acc = fma(xs, ys, acc)
// or acc + xs: sums of products and squares, the dot product's lanes and
// the moments' binomial sums.  One register, so the steps need no table;
// each source is read where it is used.
template <int NDIM, typename Idx>
__global__ void __launch_bounds__(THREADS)
chain_accumulate(float* __restrict__ out, Idx n, Program p) {
  const Idx quads = (n + V - 1) / V;
  const Idx step = (Idx)gridDim.x * THREADS;
  for (Idx q = (Idx)blockIdx.x * THREADS + threadIdx.x; q < quads; q += step) {
    const Idx i0 = q * V;
    const bool full = i0 + V <= n;
    Coords<NDIM> at;
    coords_of<NDIM>(p, i0, n, at);
    float x[V], y[V], z[V], acc[V];
    source<NDIM>(p, 0, 0, i0, n, full, at, x);
    source<NDIM>(p, 0, 1, i0, n, full, at, y);
    if (p.op[0] == OP_FMA) source<NDIM>(p, 0, 2, i0, n, full, at, z);
    apply(p.op[0], x, y, z, acc);
    for (int s = 1; s < p.n_steps; ++s) {
      if (p.op[s] == OP_ADD) {  // R0 + x: the source is the second
        source<NDIM>(p, s, 1, i0, n, full, at, x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
      } else {
        source<NDIM>(p, s, 0, i0, n, full, at, x);
        source<NDIM>(p, s, 1, i0, n, full, at, y);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fmaf_rn(x[e], y[e], acc[e]);
      }
    }
    store(out, i0, n, full, acc);
  }
}

template <int NDIM, typename Idx>
void launch_kind(int kind, int grid, float* out, Idx n, const Program& p, cudaStream_t st) {
  switch (kind) {
    case KIND_ACCUMULATE: chain_accumulate<NDIM, Idx><<<grid, THREADS, 0, st>>>(out, n, p); break;
    case KIND_LOG: chain_fixed<KIND_LOG, NDIM, Idx><<<grid, THREADS, 0, st>>>(out, n, p); break;
    case KIND_EXP: chain_fixed<KIND_EXP, NDIM, Idx><<<grid, THREADS, 0, st>>>(out, n, p); break;
    case KIND_LANES:
      chain_fixed<KIND_LANES, NDIM, Idx><<<grid, THREADS, 0, st>>>(out, n, p);
      break;
    default: chain_kernel<NDIM, Idx><<<grid, THREADS, 0, st>>>(out, n, p); break;
  }
}

template <typename Idx>
cudaError_t launch_chain(int kind, float* out, long long n, const Program& p, cudaStream_t st) {
  const int grid = grid_for((n + V - 1) / V, kind == KIND_GENERAL ? 4 : BLOCKS_PER_SM);
  switch (p.ndim) {
    case 0: launch_kind<0, Idx>(kind, grid, out, (Idx)n, p, st); break;
    case 1: launch_kind<1, Idx>(kind, grid, out, (Idx)n, p, st); break;
    case 2: launch_kind<2, Idx>(kind, grid, out, (Idx)n, p, st); break;
    case 3: launch_kind<3, Idx>(kind, grid, out, (Idx)n, p, st); break;
    default: launch_kind<4, Idx>(kind, grid, out, (Idx)n, p, st); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n float32, C order over shape[0..ndim)) = a*b + c.  ptrs[k] is
// operand k's float32 data or null for the number values[k]; its element
// strides are strides[k * 4 + axis] (all 0: one value, broadcast).
int fma_f32(void* out, long long n, int ndim, const long long* shape, const void* const* ptrs,
            const float* values, const long long* strides, void* stream) {
  if (n < 1 || ndim < 1 || ndim > MAX_DIMS) return (int)cudaErrorInvalidValue;
  Single s;
  for (int axis = 0; axis < MAX_DIMS; ++axis) s.size[axis] = axis < ndim ? shape[axis] : 1;
  for (int k = 0; k < 3; ++k) {
    s.ptr[k] = (const float*)ptrs[k];
    s.value[k] = values[k];
    for (int axis = 0; axis < MAX_DIMS; ++axis)
      s.stride[k][axis] = axis < ndim ? strides[k * MAX_DIMS + axis] : 0;
  }
  return (int)run_single((float*)out, n, ndim, s, (cudaStream_t)stream);
}

// The same on n contiguous elements: a, b and c are each a pointer to n
// float32 values, a pointer to one value that every element reads (bit k
// of `broadcast` set for operand k), or null for the number va, vb or vc.
int fma_f32_flat(void* out, long long n, const void* a, const void* b, const void* c, float va,
                 float vb, float vc, int broadcast, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Single s;
  const void* ptrs[3] = {a, b, c};
  const float values[3] = {va, vb, vc};
  for (int axis = 0; axis < MAX_DIMS; ++axis) s.size[axis] = axis ? 1 : n;
  for (int k = 0; k < 3; ++k) {
    s.ptr[k] = (const float*)ptrs[k];
    s.value[k] = values[k];
    for (int axis = 0; axis < MAX_DIMS; ++axis)
      s.stride[k][axis] = axis || (broadcast >> k & 1) ? 0 : 1;
  }
  return (int)run_single((float*)out, n, 1, s, (cudaStream_t)stream);
}

// out (n float32, C order) = the chain program.  meta (int64):
//   [0] ndim (0: every slot contiguous over n), [1..4] sizes, [5] slots,
//   [6..37] the slots' strides (slot * 4 + axis), [38] loads,
//   [39..54] each load's slot, [55..70] its element offset, [71] steps,
//   [72..151] each step's op, destination and three sources (5 a step),
//   [152] the kind (0 general, 1 accumulating, 2 log, 3 exp, 4 lane sum:
//   the wrapper matched the codes to that form).
// bases: the slots' float32 pointers; konst: three float32 constants a step.
// Sources: 0..3 a register, 4..19 a load, 20 the step's constant.
int fma_chain(void* out, long long n, const long long* meta, const void* const* bases,
              const float* konst, void* stream) {
  constexpr int SIZES = 1, SLOTS = 5, STRIDES = 6, LOADS = 38, LOAD_SLOT = 39,
                LOAD_OFFSET = 55, STEPS = 71, CODE = 72, KIND = 152;
  Program p;
  p.ndim = (int)meta[0];
  const int n_slots = (int)meta[SLOTS];
  p.n_loads = (int)meta[LOADS];
  p.n_steps = (int)meta[STEPS];
  if (n < 1 || p.ndim < 0 || p.ndim > MAX_DIMS || n_slots < 0 || n_slots > MAX_SLOTS ||
      p.n_loads < 0 || p.n_loads > MAX_LOADS || p.n_steps < 1 || p.n_steps > MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  for (int axis = 0; axis < MAX_DIMS; ++axis) p.size[axis] = meta[SIZES + axis];
  for (int k = 0; k < MAX_SLOTS; ++k) {
    p.base[k] = k < n_slots ? (const float*)bases[k] : nullptr;
    for (int axis = 0; axis < MAX_DIMS; ++axis)
      p.stride[k][axis] = k < n_slots ? meta[STRIDES + k * MAX_DIMS + axis] : 0;
  }
  for (int j = 0; j < MAX_LOADS; ++j) {
    p.slot[j] = j < p.n_loads ? (int)meta[LOAD_SLOT + j] : 0;
    p.offset[j] = j < p.n_loads ? meta[LOAD_OFFSET + j] : 0;
    if (p.slot[j] < 0 || (j < p.n_loads && p.slot[j] >= n_slots))
      return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < MAX_STEPS; ++s) {
    const long long* c = meta + CODE + 5 * s;
    const bool used = s < p.n_steps;
    p.op[s] = used ? (unsigned char)c[0] : 0;
    p.dst[s] = used ? (unsigned char)c[1] : 0;
    for (int a = 0; a < 3; ++a) {
      p.src[s][a] = used ? (unsigned char)c[2 + a] : SRC_CONST;
      p.konst[s][a] = used ? konst[3 * s + a] : 0.0f;
      if (used && (c[2 + a] < 0 || c[2 + a] > SRC_CONST ||
                   (c[2 + a] >= SRC_LOAD && c[2 + a] < SRC_CONST &&
                    c[2 + a] - SRC_LOAD >= p.n_loads)))
        return (int)cudaErrorInvalidValue;
    }
    if (used && (c[0] < OP_FMA || c[0] > OP_ADD || c[1] < 0 || c[1] >= REGS))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int kind = (int)meta[KIND];
  if (kind < KIND_GENERAL || kind > KIND_LANES) return (int)cudaErrorInvalidValue;
  if (n < (1LL << 31)) return (int)launch_chain<unsigned int>(kind, (float*)out, n, p, st);
  return (int)launch_chain<unsigned long long>(kind, (float*)out, n, p, st);
}

}  // extern "C"
