"""Dim inputs whose intermediate values reach float32's subnormal range
(below 1.18e-38), the port against the JAX package on the CPU.

XLA's CPU code runs with flush-to-zero: subnormal operands and results
are zeros.  PyTorch keeps them.  The port mirrors the flush where it
changes a result:

- the Filter: a frame scaled to about 1e-19 (1e-21) has Hessian
  components near 1e-19 (1e-21), whose squares in the Frobenius norm are
  subnormal; flushed, they change the norm, hence the Frobenius mask
  (``hessian.frobenius_norm``).  The vesselness itself is 0 on such a
  frame either way (γ is clamped at float32's epsilon).  A uint16 frame
  never gets there: its differences of smoothed values stay near 1e-5.
  The float16 carry divides the frame by its largest value first, so it
  is held here too, unchanged.
- the tracker: the variance of a dim, nearly flat ROI cancels to below
  the smallest normal, and its voxels' squares are subnormal
  (``moments.masked_mean_variance``); the moments and the matcher's
  costs are normalised and see no subnormal.

Each case first prints how many values of the plain version's
intermediate lie in the subnormal range, and asserts there are some.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.kernels import matching as j_matching
from nellie_tpu.kernels import moments as j_moments
from nellie_tpu_torch.kernels import frangi, hessian, matching, moments

TINY = float(np.finfo(np.float32).tiny)
SETUPS = {3: ((0.625, 0.8333, 1.0417, 1.25), (0.5, 0.2, 0.2), 2.5),
          2: ((0.5, 0.75, 1.0), (0.1, 0.1), 1.0)}


def subnormal(x) -> int:
    x = np.asarray(x, np.float32)
    return int(((np.abs(x) < TINY) & (x != 0)).sum())


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    differ = (got.view(np.int32) != want.view(np.int32)) & ~(np.isnan(got) & np.isnan(want))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


def dim_frame(ndim, scale):
    frame = (D.tube_series()[0] if ndim == 3 else D.tube_series_2d()[0]).astype(np.float32)
    return (frame * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize("carry", ["float32", "float16"])
@pytest.mark.parametrize("scale", [1e-19, 1e-21])
@pytest.mark.parametrize("ndim", [3, 2])
def test_vesselness_of_a_dim_frame(ndim, scale, carry):
    frame = dim_frame(ndim, scale)
    sigmas, spacing, z_ratio = SETUPS[ndim]
    h, _ = hessian.hessian_unnormalized(torch.from_numpy(frame), spacing)
    squares = sum(subnormal(c * c) for c in h.values())
    print(f"{ndim}D frame at {scale:g}: {squares} subnormal squares of Hessian components")
    assert squares > 0
    j_params = j_frangi.FrangiParams(sigmas=sigmas, spacing=spacing, z_ratio=z_ratio,
                                     carry_dtype=carry)
    params = frangi.FrangiParams(sigmas=sigmas, spacing=spacing, z_ratio=z_ratio,
                                 carry_dtype=carry)
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_params))(frame)
    v_p, m_p = frangi.vesselness_frame(torch.from_numpy(frame), params)
    assert_bitwise(v_p.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("scale", [1e-18, 1e-20])
def test_masked_mean_variance_of_dim_rois(scale):
    rng = np.random.default_rng(5)
    cubes = ((1 + 1e-3 * rng.random((40, 12, 12, 12))) * scale
             * (rng.random((40, 12, 12, 12)) > 0.2)).astype(np.float32)
    wide = cubes.astype(np.float64)
    n_sub = subnormal((wide * wide).astype(np.float32))
    count = np.maximum((cubes != 0).sum(axis=(1, 2, 3)), 1).astype(np.float32)
    total = wide.sum(axis=(1, 2, 3)).astype(np.float32)
    total_sq = (wide * wide).sum(axis=(1, 2, 3)).astype(np.float32)
    n_sub += subnormal((total_sq - total * total / count) / count)  # the variance, unflushed
    print(f"ROIs at {scale:g}: {n_sub} subnormal squares and variances")
    assert n_sub > 0
    want = np.asarray(jax.jit(j_moments.masked_mean_variance)(jnp.asarray(cubes)))
    assert_bitwise(moments.masked_mean_variance(torch.from_numpy(cubes)).numpy(), want)
    proj = cubes.max(axis=1)
    for name in ("raw_moments", "normalized_moments"):
        want = np.asarray(jax.jit(getattr(j_moments, name))(jnp.asarray(proj)))
        assert_bitwise(getattr(moments, name)(torch.from_numpy(proj)).numpy(), want)


@pytest.mark.parametrize("scale", [1e-18, 1e-20])
def test_matcher_on_dim_features(scale):
    """The matcher z-scores the features, so dim ones change nothing: the
    same matches, and the costs at ``test_torch_tracking``'s bar."""
    rng = np.random.default_rng(4)
    n_post, n_pre, n_feat = 70, 60, 22
    coords_pre = (rng.integers(0, 20, (n_pre, 3)) * np.float32([0.5, 0.2, 0.2])).astype(np.float32)
    coords_post = (coords_pre[rng.integers(0, n_pre, n_post)]
                   + rng.normal(0, 0.2, (n_post, 3))).astype(np.float32)
    feats_pre = ((1 + 0.1 * rng.normal(0, 1, (n_pre, n_feat))) * scale).astype(np.float32)
    feats_post = ((1 + 0.1 * rng.normal(0, 1, (n_post, n_feat))) * scale).astype(np.float32)
    print(f"features at {scale:g}: {subnormal(feats_pre * feats_pre)} subnormal squares")
    pad = 128

    def padded(a, fill=0):
        out = np.full((pad,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return jnp.asarray(out)

    ref = j_matching.match_frames_device(
        padded(coords_post), padded(feats_post), padded(np.ones(n_post, bool), False), n_post,
        padded(coords_pre), padded(feats_pre), padded(np.ones(n_pre, bool), False), n_pre,
        1.0, 4)
    got = matching.match_frames_device(
        torch.from_numpy(coords_post), torch.from_numpy(feats_post),
        torch.from_numpy(coords_pre), torch.from_numpy(feats_pre), 1.0, 4)
    assert len(ref[0]) > 0
    assert got[0] == ref[0] and got[1] == ref[1]
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)
