"""The tracker's log-Hu features against the JAX package, and the kernel's
source against its plain body.

``moments.hu_features_plain`` (the CPU path of ``moments.hu_features``, and
the body that ``csrc/hu_features.cu`` is held to on the card) equals the
reference's jitted ``log_hu(hu_3d(x))`` and ``log_hu(hu_2d(x))`` bit for
bit, inlined (one chunk of ROIs) and in a ``lax.map`` loop body (several,
``looped``), on seeded ROIs at r = 16 and 20 (the main paths'), 13 and 7
(whose raw moments add the products past the largest multiple of 4 last,
as XLA's dot does: ``moments._dot``), all-zero ROIs among them, and on a
mirror-symmetric ROI whose h4 cancels to a subnormal (0 after the flush).
The tracker's ``_frame_features_fused`` equals the reference's at r = 13
with one chunk and with several.  And the kernel's source, compiled for
the host with ``g++`` (one thread a block, CUDA's rounding intrinsics as
the C library's correctly rounded operations), equals the plain body bit
for bit on every case: the schedule of ``hu_features.cu`` run on the CPU.
"""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu.kernels import moments as j_moments
from nellie_tpu.stages import hu_tracking as j_tracking
from nellie_tpu_torch.kernels import moments
from nellie_tpu_torch.kernels._cuda import CSRC
from nellie_tpu_torch.stages import hu_tracking
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

SHAPES = [(16, 16, 16), (20, 20), (13, 13, 13), (7, 7), (7, 7, 7), (13, 13)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def rois(shape, n=64, seed=0):
    return chip_smoke.hu_rois((n,) + tuple(shape), seed)


@pytest.fixture(scope="module")
def reference():
    def one(x):
        return j_moments.log_hu(j_moments.hu_3d(x) if x.ndim == 4 else j_moments.hu_2d(x))

    inlined = jax.jit(one)
    looped = jax.jit(lambda x: jax.lax.map(one, x))

    def run(x, is_looped):
        if not is_looped:
            return np.asarray(inlined(jnp.asarray(x)))
        chunks = jnp.asarray(x.reshape((2, x.shape[0] // 2) + x.shape[1:]))
        return np.asarray(looped(chunks)).reshape(x.shape[0], -1)

    return run


def assert_bitwise(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("looped", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_against_reference(shape, looped, reference):
    x = rois(shape)
    got = moments.hu_features_plain(torch.from_numpy(x), looped)
    assert got.shape == (x.shape[0], 18 if len(shape) == 3 else 6)
    assert_bitwise(got, reference(x, looped))
    assert_bitwise(moments.hu_features(torch.from_numpy(x), looped), got)


def test_subnormal_hu_value(reference):
    """A Hu value that cancels to a subnormal counts as 0, as XLA flushes
    it: the feature is 0, not ±37.9."""
    x = chip_smoke.symmetric_hu_rois()
    hu = moments.hu_2d(torch.from_numpy(x), True).numpy()
    tiny = np.finfo(np.float32).tiny
    sub = (np.abs(hu) < tiny) & (hu != 0)
    assert sub.any()
    got = moments.hu_features_plain(torch.from_numpy(x), True).numpy()
    assert (got[sub] == 0).all()
    assert_bitwise(got, reference(x, True))


@pytest.mark.parametrize("ndim, n", [(3, 200), (3, 600), (2, 200), (2, 600)])
def test_frame_features_at_odd_radius(ndim, n):
    """The tracker's features at a cube side of 13 (not a multiple of 4):
    200 markers in one chunk of 256, 600 in three (the loop body)."""
    from test_torch_parity_repairs import marker_frame

    intensity, frangi_im, distance, coords = marker_frame(ndim, n)
    chunk, r = 256, 13
    nb = chunk
    while nb < n:
        nb *= 2
    cpad = np.zeros((nb, ndim), np.int32)
    cpad[:n] = coords
    scaling = (0.5, 0.2, 0.2)[-ndim:]
    want, _ = j_tracking._frame_features_fused(
        jnp.asarray(intensity), jnp.asarray(frangi_im), jnp.asarray(distance), jnp.asarray(cpad),
        jnp.asarray(np.arange(nb) < n), r=r, no_z=ndim == 2, chunk=chunk, scaling=scaling)
    got, _ = hu_tracking._frame_features_fused(
        torch.from_numpy(intensity.astype(np.int32)), torch.from_numpy(frangi_im),
        torch.from_numpy(distance), torch.from_numpy(coords), r, chunk, scaling)
    assert_bitwise(got, np.asarray(want)[:n])


def test_other_devices_raise():
    with pytest.raises(ValueError):
        moments.hu_features(torch.zeros((2, 4, 4), device="meta"))


# the kernel's source on the host: CUDA's intrinsics as C's operations
_HOST_SHIMS = r'''
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
using std::isfinite; using std::isinf; using std::isnan;
#define __device__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __launch_bounds__(x)
#define __syncthreads()
static struct { unsigned x; } threadIdx, blockIdx, blockDim;
static float* g_smem;
static inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
static inline unsigned __float_as_uint(float x) { unsigned u; memcpy(&u, &x, 4); return u; }
static inline int __float_as_int(float x) { int u; memcpy(&u, &x, 4); return u; }
static inline float __int_as_float(int x) { float u; memcpy(&u, &x, 4); return u; }
static inline double __longlong_as_double(long long x) { double u; memcpy(&u, &x, 8); return u; }
static inline float __double2float_rn(double x) { return (float)x; }
'''
_HOST_DRIVER = r'''
extern "C" void hu_features_host(const float* rois, long long n, int nz, int ny, int nx,
                                 int looped, float* out) {
  g_smem = (float*)malloc(1 << 22);
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long b = 0; b < n; ++b) {
    blockIdx.x = (unsigned)b;
    hu_features_kernel(rois, n, nz, ny, nx, looped, out);
  }
  free(g_smem);
}
'''


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """hu_features.cu's kernel body built for the host: one thread runs a
    block's every phase in turn."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's source for the host")
    with open(os.path.join(CSRC, "hu_features.cu")) as f:
        src = f.read()
    body = src[src.index("namespace {") + len("namespace {"):src.index("}  // namespace")]
    body = body.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    d = tmp_path_factory.mktemp("hu_host")
    cpp, lib = d / "hu_features_host.cpp", d / "hu_features_host.so"
    cpp.write_text(_HOST_SHIMS + body + _HOST_DRIVER)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib), str(cpp)], check=True, capture_output=True)
    handle = ctypes.CDLL(str(lib))

    def run(x, looped):
        x = np.ascontiguousarray(x, np.float32)
        nz = x.shape[1] if x.ndim == 4 else 0
        out = np.zeros((x.shape[0], 18 if nz else 6), np.float32)
        handle.hu_features_host(x.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(x.shape[0]),
                                nz, x.shape[-2], x.shape[-1], int(looped),
                                out.ctypes.data_as(ctypes.c_void_p))
        return out

    return run


@pytest.mark.parametrize("looped", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(5, 9, 6), (3, 3), (1, 1), (16, 4, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_source_on_host(shape, looped, host_kernel):
    x = rois(shape, n=32, seed=len(shape))
    assert_bitwise(host_kernel(x, looped),
                   moments.hu_features_plain(torch.from_numpy(x), looped))


def test_kernel_source_on_host_subnormal(host_kernel):
    x = chip_smoke.symmetric_hu_rois()
    assert_bitwise(host_kernel(x, True), moments.hu_features_plain(torch.from_numpy(x), True))
