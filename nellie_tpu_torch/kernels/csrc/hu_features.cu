// The tracker's log-Hu features of a chunk of ROIs, for Hopper (sm_90a): one
// launch a call, no host read.
//
// Replaces nellie_tpu/kernels/moments.py::raw_moments, central_moments,
// normalized_moments, hu_moments, log_hu, hu_2d and hu_3d (moments.py:25-108)
// as nellie_tpu/stages/hu_tracking.py:129-130 composes them, log_hu(hu_3d(x))
// or log_hu(hu_2d(x)) of one chunk of ROI cubes, and the port's plain body
// (kernels/moments.py::hu_features_plain), which is that composition in torch:
// about 8,300 CUDA launches a 3D call and 2,800 a 2D one.
//
// What it computes, exactly as the plain body does (built with -fmad=false,
// every contraction an explicit __fmaf_rn, every other float op rounded once
// to nearest, subnormals kept but where a flush is written):
//  * the images: a 2D ROI (H, W) itself; a 3D ROI (Z, Y, X) gives three, its
//    maxima over Z (Y, X), over Y (Z, X) and over X (Z, Y), in that order;
//  * raw moments M[p][q] = sum_h (sum_w x[h][w] w^p) h^q as moments._dot
//    rounds each sum: the largest multiple of 4 of the k in four lanes over
//    k mod 4, each the first product followed by fmas in k order, combined
//    as (s0 + s1) + (s2 + s3) (_fp.contract), then the other k's products
//    added left to right and that sum added last; the powers w^p and h^q are
//    exact integers;
//  * central moments by moments._sum_terms: for mu_pq the terms
//    C(p,i) C(q,j) (-xb)^(p-i) (-yb)^(q-j) M[i][j], i and j ascending, each
//    factor multiplied left to right without those equal to 1 (x^2 = x x,
//    x^3 = (x x) x), the first two terms joined by XLA's fusion rule
//    (FUSE_RIGHT, or FUSE_RIGHT_LOOPED for the reference's lax.map loop body)
//    and every later term fused into the running sum; xb = M10 / (M00 + 1e-12)
//    and yb likewise, IEEE divisions;
//  * eta_pq = mu_pq / (powf(M00, (p + q + 2) / 2) + 1e-12) with glibc's powf as
//    _fp.pow mirrors it in float64 (its fmas as Dekker's exact products, as
//    _fp._fma64 writes them) under XLA's flushes;
//  * the six Hu invariants with moments.hu_moments' contractions (a 3D ROI's
//    projections fuse h1 and the right product of h4);
//  * log-Hu: a value below the smallest normal float is 0, then
//    -sign(h) log10(max(|h|, tiny)) with _fp.log's polynomial times
//    f32(1 / ln 10), a non-finite result 0.
//
// What bounds it: bytes, each ROI read once (16 KB a 3D ROI of 16^3) and 72
// bytes of features written, about 1.4 MB on the 3D path's largest call.  The
// design is the simple one: a block an ROI; its threads take the projections
// into shared memory (a max over one axis a thread and element), then the
// first contraction's sums (one (projection, row, power) a thread), then the
// second's (one (projection, p, q) a thread), and one thread a projection runs
// the scalar tail.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int K = 4;  // moments up to order 3
constexpr float kTiny = 0x1p-126f;
constexpr float kOneE12 = 0x1.197998p-40f;  // f32(1e-12)

// glibc's powf tables and polynomials (kernels/_fp.py _POWF_*, _EXP2F_*)
__constant__ double kPowfTab[32] = {
    0x1.661ec79f8f3bep+0,  -0x1.efec65b963019p-2, 0x1.571ed4aaf883dp+0,  -0x1.b0b6832d4fca4p-2,
    0x1.49539f0f010b0p+0,  -0x1.7418b0a1fb77bp-2, 0x1.3c995b0b80385p+0,  -0x1.39de91a6dcf7bp-2,
    0x1.30d190c8864a5p+0,  -0x1.01d9bf3f2b631p-2, 0x1.25e227b0b8ea0p+0,  -0x1.97c1d1b3b7af0p-3,
    0x1.1bb4a4a1a343fp+0,  -0x1.2f9e393af3c9fp-3, 0x1.12358f08ae5bap+0,  -0x1.960cbbf788d5cp-4,
    0x1.0953f419900a7p+0,  -0x1.a6f9db6475fcep-5, 0x1.0000000000000p+0, 0x0.0p+0,
    0x1.e608cfd9a47acp-1,  0x1.338ca9f24f53dp-4,  0x1.ca4b31f026aa0p-1,  0x1.476a9543891bap-3,
    0x1.b2036576afce6p-1,  0x1.e840b4ac4e4d2p-3,  0x1.9c2d163a1aa2dp-1,  0x1.40645f0c6651cp-2,
    0x1.886e6037841edp-1,  0x1.88e9c2c1b9ff8p-2,  0x1.767dcf5534862p-1,  0x1.ce0a44eb17bccp-2};
__constant__ double kPowfA[5] = {0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2, 0x1.ec70a6ca7baddp-2,
                              -0x1.7154748bef6c8p-1, 0x1.71547652ab82bp+0};
__constant__ unsigned long long kExp2fTab[32] = {
    0x3ff0000000000000ULL, 0x3fefd9b0d3158574ULL, 0x3fefb5586cf9890fULL, 0x3fef9301d0125b51ULL,
    0x3fef72b83c7d517bULL, 0x3fef54873168b9aaULL, 0x3fef387a6e756238ULL, 0x3fef1e9df51fdee1ULL,
    0x3fef06fe0a31b715ULL, 0x3feef1a7373aa9cbULL, 0x3feedea64c123422ULL, 0x3feece086061892dULL,
    0x3feebfdad5362a27ULL, 0x3feeb42b569d4f82ULL, 0x3feeab07dd485429ULL, 0x3feea47eb03a5585ULL,
    0x3feea09e667f3bcdULL, 0x3fee9f75e8ec5f74ULL, 0x3feea11473eb0187ULL, 0x3feea589994cce13ULL,
    0x3feeace5422aa0dbULL, 0x3feeb737b0cdc5e5ULL, 0x3feec49182a3f090ULL, 0x3feed503b23e255dULL,
    0x3feee89f995ad3adULL, 0x3feeff76f2fb5e47ULL, 0x3fef199bdd85529cULL, 0x3fef3720dcef9069ULL,
    0x3fef5818dcfba487ULL, 0x3fef7c97337b9b5fULL, 0x3fefa4afa2a490daULL, 0x3fefd0765b6e4540ULL};
constexpr double kExp2fShift = 0x1.8p+47;
__constant__ double kExp2fC[3] = {0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3,
                               0x1.62e42ff0c52d6p-1};
constexpr double kVeltkamp = 134217729.0;  // 2^27 + 1
constexpr long long kPowfOff = 0x3F330000;

// XLA's CPU log (kernels/_fp.py _LOG_*)
__constant__ float kLogP[9] = {0x1.204376p-4f,  -0x1.d7a37p-4f, 0x1.de4a34p-4f,
                            -0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555ca0p-3f,
                            0x1.999d58p-3f,  -0x1.fffff8p-3f, 0x1.555554p-2f};
constexpr float kLogQ1 = -0x1.bd0106p-13f, kLogQ2 = 0x1.63p-1f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kInvLn10 = 0x1.bcb7b2p-2f;  // f32(1 / ln 10)

// _fp._fma64: a*b + c in double with the product's error kept (Dekker)
__device__ __forceinline__ double fma64(double a, double b, double c) {
  const double p = a * b;
  double ah = a * kVeltkamp;
  ah = ah - (ah - a);
  double bh = b * kVeltkamp;
  bh = bh - (bh - b);
  const double err = ((ah * bh - p) + ah * (b - bh) + (a - ah) * bh) + (a - ah) * (b - bh);
  const double s = p + c;
  const double bp = s - p;
  const double t = (p - (s - bp)) + (c - bp);
  return s + (t + err);
}

// _fp.pow(x, y) for a positive float32 exponent y: glibc's powf as XLA's CPU
// code calls it, its input and result flushed
__device__ float powf_xla(float x, float yf) {
  x = fabsf(x) < kTiny ? 0.f : x;
  const double y = (double)yf;
  const float ax = fabsf(x);
  const long long ix = (long long)__float_as_uint(ax);
  const long long tmp = ix - kPowfOff;
  const int i = (int)((tmp >> 19) & 15);
  const long long top = tmp & -0x800000LL;
  const double iz = (double)__int_as_float((int)(ix - top));
  const double k = (double)(top >> 23);
  const double invc = kPowfTab[2 * i], logc = kPowfTab[2 * i + 1];
  double r = fma64(iz, invc, -1.0);
  const double y0 = logc + k;
  double r2 = r * r;
  const double a = fma64(r, kPowfA[0], kPowfA[1]);
  const double p = fma64(r, kPowfA[2], kPowfA[3]);
  const double r4 = r2 * r2;
  double q = fma64(r, kPowfA[4], y0);
  q = fma64(p, r2, q);
  const double logx = fma64(a, r4, q);
  const double ylogx = logx * y;
  double kd = ylogx + kExp2fShift;
  kd = kd - kExp2fShift;
  r = ylogx - kd;
  const long long ki = (long long)rint(kd * 32.0);
  const unsigned long long t = kExp2fTab[ki & 31] + ((unsigned long long)ki << 47);
  const double s = __longlong_as_double((long long)t);
  const double z = fma64(r, kExp2fC[0], kExp2fC[1]);
  r2 = r * r;
  double out64 = fma64(r, kExp2fC[2], 1.0);
  float out = __double2float_rn(fma64(z, r2, out64) * s);
  out = fabsf(out) < kTiny ? 0.f : out;
  if (ylogx > 0x1.fffffffd1d571p+6) out = INFINITY;
  if (ylogx <= -150.0) out = 0.f;
  if (y > 0.0 && ax == 0.f) out = 0.f;
  if (y > 0.0 && isinf(ax)) out = ax;
  const bool integer = y == floor(y);
  const bool odd = integer && fmod(y, 2.0) == 1.0;
  if (x < 0.f && odd) out = -out;
  if (x < 0.f && !integer) out = NAN;
  if (isnan(x)) out = x;
  return out;
}

// _fp.log10 of a float32 that is at least the smallest normal (or +inf, NaN)
__device__ float log10_xla(float x) {
  const int bits = __float_as_int(x);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.f);
  const float m = __int_as_float((bits & -2139095041) | 0x3F000000);  // in [0.5, 1)
  const bool small = m < kSqrtHalf;
  e = __fsub_rn(e, small ? 1.f : 0.f);
  const float r = __fadd_rn(__fsub_rn(m, 1.f), small ? m : 0.f);
  float y0 = __fmaf_rn(__fmaf_rn(r, kLogP[0], kLogP[1]), r, kLogP[2]);
  float y1 = __fmaf_rn(__fmaf_rn(r, kLogP[3], kLogP[4]), r, kLogP[5]);
  const float r2 = __fmul_rn(r, r), r3 = __fmul_rn(r2, r);
  float acc = __fmaf_rn(y0, r3, y1);
  y1 = __fmaf_rn(__fmaf_rn(r, kLogP[6], kLogP[7]), r, kLogP[8]);
  acc = __fmaf_rn(acc, r3, y1);
  acc = __fmaf_rn(acc, r3, __fmul_rn(e, kLogQ1));
  const float head = __fadd_rn(__fmaf_rn(-0.5f, r2, r), acc);
  float out = __fmaf_rn(kLogQ2, e, head);
  if (x < 0.f) out = NAN;
  if (x == 0.f) out = -INFINITY;
  if ((isinf(x) && x > 0.f) || isnan(x)) out = x;
  return __fmul_rn(out, kInvLn10);
}

__device__ __forceinline__ float neg_pow(float x, int k) {  // (-x)^k, k in 1..3
  const float v = -x;
  return k == 1 ? v : k == 2 ? __fmul_rn(v, v) : __fmul_rn(__fmul_rn(v, v), v);
}

__device__ __forceinline__ int comb(int n, int k) {
  return (n == 3 && (k == 1 || k == 2)) ? 3 : (n == 2 && k == 1) ? 2 : 1;
}

// whether XLA fuses the right product of mu_pq's first addition
// (moments._FUSE_RIGHT; the looped program leaves out (3, 0))
__device__ __forceinline__ bool fuse_right(int p, int q, bool looped) {
  const int key = 4 * p + q;
  switch (key) {
    case 4 * 0 + 3: case 4 * 1 + 2: case 4 * 1 + 3: case 4 * 2 + 1: case 4 * 2 + 3:
    case 4 * 3 + 1:
      return true;
    case 4 * 3 + 0:
      return !looped;
    default:
      return false;
  }
}

// mu_pq by moments._sum_terms
__device__ float central(const float (*m)[K], int p, int q, float xb, float yb, bool looped) {
  const bool right = fuse_right(p, q, looped);
  float acc = 0.f, f0 = 0.f, v0 = 0.f;
  bool has0 = false;
  int n = 0;
  for (int i = 0; i <= p; ++i) {
    for (int j = 0; j <= q; ++j) {
      bool has = false;
      float f = 0.f;
      const int c = comb(p, i) * comb(q, j);
      if (c != 1) {
        f = (float)c;
        has = true;
      }
      if (p != i) {
        const float xp = neg_pow(xb, p - i);
        f = has ? __fmul_rn(f, xp) : xp;
        has = true;
      }
      if (q != j) {
        const float yp = neg_pow(yb, q - j);
        f = has ? __fmul_rn(f, yp) : yp;
        has = true;
      }
      const float v = m[i][j];
      if (n == 0) {
        f0 = f, v0 = v, has0 = has;
      } else if (n == 1) {
        if (has && (!has0 || right)) {
          acc = has0 ? __fmaf_rn(f, v, __fmul_rn(f0, v0)) : __fmaf_rn(f, v, v0);
        } else if (has0) {
          acc = has ? __fmaf_rn(f0, v0, __fmul_rn(f, v)) : __fmaf_rn(f0, v0, v);
        } else {
          acc = __fadd_rn(v0, v);
        }
      } else {
        acc = has ? __fmaf_rn(f, v, acc) : __fadd_rn(acc, v);
      }
      ++n;
    }
  }
  if (n == 1) return has0 ? __fmul_rn(f0, v0) : v0;
  return acc;
}

// log-Hu of one image's raw moments into out[0..6)
__device__ void hu_tail(const float (*m)[K], bool looped, bool projections, float* out) {
  const float m00 = __fadd_rn(m[0][0], kOneE12);
  const float xb = __fdiv_rn(m[1][0], m00), yb = __fdiv_rn(m[0][1], m00);
  float eta[K][K];
  float powers[9];
  for (int e = 2; e <= 8; ++e) powers[e] = powf_xla(m[0][0], 0.5f * (float)e);
  for (int p = 0; p < K; ++p)
    for (int q = 0; q < K; ++q)
      eta[p][q] = __fdiv_rn(central(m, p, q, xb, yb, looped),
                            __fadd_rn(powers[p + q + 2], kOneE12));
  const float e20 = eta[2][0], e02 = eta[0][2], e11 = eta[1][1];
  const float e30 = eta[3][0], e12 = eta[1][2], e21 = eta[2][1], e03 = eta[0][3];
  const float a = __fadd_rn(e30, e12), b = __fadd_rn(e21, e03);
  const float a2 = __fmul_rn(a, a), b2 = __fmul_rn(b, b);
  const float s1 = __fmaf_rn(-3.f, e12, e30);
  const float s2 = __fmaf_rn(3.f, e21, -e03);
  const float d = __fsub_rn(e20, e02);
  const float p1 = __fmul_rn(s1, a), t1 = __fmaf_rn(-3.f, b2, a2);
  const float p2 = __fmul_rn(s2, b), t2 = __fmaf_rn(3.f, a2, -b2);
  const float e11sq4 = __fmul_rn(4.f, __fmul_rn(e11, e11));
  float hu[6];
  hu[0] = __fadd_rn(e20, e02);
  hu[2] = __fmaf_rn(s1, s1, __fmul_rn(s2, s2));
  hu[3] = __fmaf_rn(a, a, b2);
  if (projections) {
    hu[1] = __fmaf_rn(d, d, e11sq4);
    hu[4] = __fmaf_rn(p2, t2, __fmul_rn(p1, t1));
  } else {
    hu[1] = __fadd_rn(__fmul_rn(d, d), e11sq4);
    hu[4] = __fmaf_rn(p1, t1, __fmul_rn(p2, t2));
  }
  hu[5] = __fmaf_rn(__fmul_rn(__fmul_rn(4.f, e11), a), b,
                    __fmul_rn(d, __fmaf_rn(a, a, -b2)));
  for (int k = 0; k < 6; ++k) {
    // -sign(h) log10(max(|h|, tiny)) after the flush, non-finite results
    // 0: a zero h (or one flushed) gives -0 * log10(tiny) = +0, a NaN or an
    // infinite h 0, and otherwise -L or L exactly
    const float h = hu[k];
    float v = 0.f;
    if (isfinite(h) && fabsf(h) >= kTiny) {
      const float l = log10_xla(fabsf(h));
      v = h > 0.f ? -l : l;
      if (!isfinite(v)) v = 0.f;
    }
    out[k] = v;
  }
}

// k^power for power 0..3, exact (k < 256)
__device__ __forceinline__ float power_of(int k, int power) {
  return (float)(power == 0 ? 1 : power == 1 ? k : power == 2 ? k * k : k * k * k);
}

// one sum of moments._dot: sum_k x[k * xs] * c(k), k < n, c(k) = k^power; the
// largest multiple of 4 of n in four lanes over k mod 4 (_fp.contract), the
// rest's products rounded and added left to right, that sum added last
__device__ float contract(const float* x, int xs, int n, int power) {
  const int main = n - n % 4;
  float rest = 0.f;
  for (int k = main; k < n; ++k) {
    const float p = __fmul_rn(x[k * xs], power_of(k, power));
    rest = k == main ? p : __fadd_rn(rest, p);
  }
  if (main == 0) return rest;
  float lane[4];
  for (int l = 0; l < 4; ++l) {
    lane[l] = __fmul_rn(x[l * xs], power_of(l, power));
    for (int k = l + 4; k < main; k += 4)
      lane[l] = __fmaf_rn(x[k * xs], power_of(k, power), lane[l]);
  }
  const float head = __fadd_rn(__fadd_rn(lane[0], lane[1]), __fadd_rn(lane[2], lane[3]));
  return main == n ? head : __fadd_rn(head, rest);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(b) || b > a) ? b : a;
}

// a block an ROI: images (projections of a 3D ROI, or the 2D ROI) in shared
// memory, the two contractions, and one thread an image's tail
__global__ void __launch_bounds__(THREADS)
    hu_features_kernel(const float* __restrict__ rois, long long n_roi, int nz, int ny, int nx,
                       int looped, float* __restrict__ out) {
  extern __shared__ float smem[];
  const long long roi = blockIdx.x;
  if (roi >= n_roi) return;
  const bool is3d = nz > 0;
  const int n_img = is3d ? 3 : 1;
  // image g: rows h_g, columns w_g
  int hs[3], ws[3], offs[3];
  if (is3d) {
    hs[0] = ny, ws[0] = nx;  // max over Z
    hs[1] = nz, ws[1] = nx;  // max over Y
    hs[2] = nz, ws[2] = ny;  // max over X
  } else {
    hs[0] = ny, ws[0] = nx;
  }
  int total = 0;
  for (int g = 0; g < n_img; ++g) offs[g] = total, total += hs[g] * ws[g];
  float* img = smem;                          // the images
  float* tmp = smem + total;                  // (image, row, p) first sums
  int tmp_total = 0;
  int tmp_offs[3];
  for (int g = 0; g < n_img; ++g) tmp_offs[g] = tmp_total, tmp_total += hs[g] * K;
  float* mom = tmp + tmp_total;               // (image, p, q)
  const long long voxels = is3d ? (long long)nz * ny * nx : (long long)ny * nx;
  const float* x = rois + roi * voxels;

  if (is3d) {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      float v;
      if (e < offs[1]) {
        const int yy = e / nx, xx = e % nx;
        v = x[(long long)yy * nx + xx];
        for (int z = 1; z < nz; ++z) v = nan_max(v, x[((long long)z * ny + yy) * nx + xx]);
      } else if (e < offs[2]) {
        const int i = e - offs[1], z = i / nx, xx = i % nx;
        v = x[(long long)z * ny * nx + xx];
        for (int yy = 1; yy < ny; ++yy) v = nan_max(v, x[((long long)z * ny + yy) * nx + xx]);
      } else {
        const int i = e - offs[2], z = i / ny, yy = i % ny;
        const float* row = x + ((long long)z * ny + yy) * nx;
        v = row[0];
        for (int xx = 1; xx < nx; ++xx) v = nan_max(v, row[xx]);
      }
      img[e] = v;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += blockDim.x) img[e] = x[e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tmp_total; t += blockDim.x) {
    int g = 0;
    while (g + 1 < n_img && t >= tmp_offs[g + 1]) ++g;
    const int i = t - tmp_offs[g], h = i / K, p = i % K;
    tmp[t] = contract(img + offs[g] + h * ws[g], 1, ws[g], p);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_img * K * K; t += blockDim.x) {
    const int g = t / (K * K), p = (t / K) % K, q = t % K;
    mom[t] = contract(tmp + tmp_offs[g] + p, K, hs[g], q);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_img; g += blockDim.x) {
    float m[K][K];
    for (int p = 0; p < K; ++p)
      for (int q = 0; q < K; ++q) m[p][q] = mom[g * K * K + p * K + q];
    hu_tail(m, looped != 0, is3d, out + roi * 6 * n_img + 6 * g);
  }
}

}  // namespace

extern "C" {

// The log-Hu features of n_roi C-contiguous float32 ROIs on the device: 3D
// ROIs (nz, ny, nx) when nz > 0, else 2D ROIs (ny, nx); out (n_roi, 18) or
// (n_roi, 6) float32.  looped: the rounding of the reference's program over
// more than one chunk of ROIs.  kernels (host): the CUDA kernels launched.
int hu_features(const void* rois, long long n_roi, int nz, int ny, int nx, int looped, void* out,
                int* kernels, void* stream) {
  *kernels = 0;
  if (n_roi < 0 || ny < 1 || nx < 1 || nz < 0) return (int)cudaErrorInvalidValue;
  if (n_roi == 0) return 0;
  if (n_roi > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long images = nz > 0 ? (long long)ny * nx + (long long)nz * nx + (long long)nz * ny
                                  : (long long)ny * nx;
  const long long rows = nz > 0 ? (long long)ny + 2LL * nz : ny;
  const long long floats = images + rows * K + (nz > 0 ? 3 : 1) * K * K;
  const size_t shared = sizeof(float) * (size_t)floats;
  int device;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (shared > 48 * 1024) {
    static int allowed[64] = {0};
    if (device >= 64 || (long long)shared > allowed[device]) {
      if ((err = cudaFuncSetAttribute(hu_features_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)shared)) != cudaSuccess)
        return (int)err;
      if (device < 64) allowed[device] = (int)shared;
    }
  }
  hu_features_kernel<<<(unsigned)n_roi, THREADS, shared, (cudaStream_t)stream>>>(
      (const float*)rois, n_roi, nz, ny, nx, looped, (float*)out);
  *kernels = 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
