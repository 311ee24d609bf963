"""The port's rounding mirrors of XLA's CPU code and its device free-memory
figure, held to the JAX package on the CPU.

* ``_fp.cos``, ``_fp.acos`` / ``_fp.atan2``, ``_fp.exp`` and ``_fp.log``
  equal ``jax.jit`` of the ``jnp`` functions bit for bit on 10**6 seeded
  points of the ranges the kernels give them (the 3D eigen solver's angles
  and its ``acos`` argument, the Frangi response's exponents, the log of
  the tracker's and Label's positive values).
* ``eigvalsh3`` and the 3D vesselness then equal the reference's bit for
  bit, in one window and in the low-memory Filter's windows.
* The tracker's masked pair sums (XLA's 32 x 32 tree reduction), its pair
  costs, and its Hu features in both of the reference's programs (one
  chunk of markers, inlined, and several, a loop) are bitwise (the
  ``mode="sparse"`` tracking run is held to the reference exactly in
  ``tests/test_torch_low_memory.py``).
* ``device_free_bytes`` counts the caching allocator's unused blocks as
  free.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

import torch_port_data as D
from nellie_tpu.kernels import eigen as j_eigen
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.kernels import matching as j_matching
from nellie_tpu.stages import hu_tracking as j_tracking
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu_torch.kernels import _fp, eigen, frangi, matching
from nellie_tpu_torch.stages import hu_tracking
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.utils import adaptive_run

N = 1_000_000
T = torch.from_numpy


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    differ = (got.view(np.int32) != want.view(np.int32)) & ~(np.isnan(got) & np.isnan(want))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


# -- A1: the transcendentals ---------------------------------------------------

@pytest.mark.parametrize("lo, hi", [(0.0, np.pi / 3), (2 * np.pi / 3, np.pi), (-100.0, 100.0)])
def test_cos_bitwise_to_xla(lo, hi):
    """The eigen solver's angles: phi in [0, pi/3] and phi + 2pi/3."""
    x = np.random.default_rng(0).uniform(lo, hi, N).astype(np.float32)
    assert_bitwise(_fp.cos(T(x)), jax.jit(jnp.cos)(x))


def test_acos_bitwise_to_xla():
    """The solver's clamped det/2 in [-1, 1], its ends and near-ends."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, N).astype(np.float32)
    x[:2000] = np.float32(1) - rng.uniform(0, 1e-5, 2000).astype(np.float32)
    x[2000:4000] = -x[:2000]
    x[4000:4006] = [1, -1, 0, -0.0, 0.99999994, -0.99999994]
    assert_bitwise(_fp.acos(T(x)), jax.jit(jnp.arccos)(x))


def test_atan2_bitwise_to_xla():
    rng = np.random.default_rng(2)
    y = rng.normal(0, 10, N).astype(np.float32)
    x = rng.normal(0, 10, N).astype(np.float32)
    x[:1000], y[1000:2000] = 0.0, 0.0
    x[2000:3000] = 1.0
    assert_bitwise(_fp.atan2(T(y), T(x)), jax.jit(jnp.arctan2)(y, x))


def test_exp_bitwise_to_xla_on_the_response_range():
    x = np.random.default_rng(3).uniform(-100.0, 0.0, N).astype(np.float32)
    assert_bitwise(_fp.exp(T(x)), jax.jit(jnp.exp)(x))


def test_log_bitwise_to_xla():
    rng = np.random.default_rng(4)
    x = np.exp(rng.uniform(np.log(1e-38), np.log(1e38), N)).astype(np.float32)
    x[:8] = [0, -1, np.inf, -np.inf, np.nan, 1e-45, 1.0, 3.4e38]
    assert_bitwise(_fp.log(T(x)), jax.jit(jnp.log)(x))
    assert_bitwise(_fp.log10(T(x)), jax.jit(jnp.log10)(x))


def test_eigvalsh3_bitwise():
    rng = np.random.default_rng(5)
    h = [rng.normal(0, 3, 50_000).astype(np.float32) for _ in range(6)]
    h[3][:1000] = h[0][:1000]  # repeated diagonals
    want = jax.jit(j_eigen.eigvalsh3)(*h)
    for w, g in zip(want, eigen.eigvalsh3(*[T(a) for a in h])):
        assert_bitwise(g, w)


@pytest.mark.parametrize("t", range(3))
def test_vesselness_3d_bitwise(t):
    frame = D.tube_series()[t].astype(np.float32)
    sigmas, spacing = (0.625, 0.8333, 1.0417, 1.25), (0.5, 0.2, 0.2)
    params = frangi.FrangiParams(sigmas=sigmas, spacing=spacing, z_ratio=2.5)
    j_params = j_frangi.FrangiParams(sigmas=sigmas, spacing=spacing, z_ratio=2.5)
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_params))(frame)
    v_p, m_p = frangi.vesselness_frame(T(frame), params)
    assert_bitwise(v_p, v_j)
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("kw", [{}, dict(low_memory=True, max_chunk_voxels=12 * 24 * 24)])
def test_filter_3d_equals_the_reference(tmp_path, kw):
    """``im_preprocessed`` of the 3D tube series, whole frames and the
    low-memory windows: the reference's bit for bit."""
    ref, port = D.two_copies(tmp_path)
    JFilter(ref, **kw).run()
    Filter(port, device="cpu", **kw).run()
    D.assert_artifact_equal(ref, port, "im_preprocessed", "exact")


# -- A2: the tiled matcher -----------------------------------------------------

def matcher_tiles(seed=0, n_post=300, n_pre=260, n_feat=22):
    rng = np.random.default_rng(seed)
    coords_pre = (rng.integers(0, 24, (n_pre, 3)) * np.array([0.5, 0.2, 0.2])).astype(np.float32)
    coords_post = (coords_pre[rng.integers(0, n_pre, n_post)]
                   + rng.normal(0, 0.2, (n_post, 3))).astype(np.float32)
    feats = [rng.normal(0, 1, (n, n_feat)).astype(np.float32) for n in (n_post, n_pre)]
    return coords_post, coords_pre, feats[0], feats[1]


def reference_tile(cp, cq, fp, fq):
    """The reference's padded tile: rows and columns to powers of two,
    with their validity masks."""
    nb, nbq = j_matching._bucket(len(cp)), j_matching._bucket(len(cq))
    padded = [j_matching._pad_to(a, n) for a, n in ((cp, nb), (cq, nbq), (fp, nb), (fq, nbq))]
    valid = [j_matching._pad_to(np.ones(n, bool), b, False)
             for n, b in ((len(cp), nb), (len(cq), nbq))]
    return padded + valid


def test_pair_stats_and_costs_bitwise():
    """One tile of the reference (padded, masked) against the port's
    unpadded tile: the sums over 32 x 32 windows, then the window sums in
    row-major order, and the costs and their minima."""
    cp, cq, fp, fq = matcher_tiles()
    tile = reference_tile(cp, cq, fp, fq)
    max_d = np.float32(1.0)
    count, sums, sumsqs = j_matching.pair_stats(*tile, max_d)
    got = matching.pair_stats(T(cp), T(cq), T(fp), T(fq), float(max_d))
    assert got[0] == int(count) > 0
    assert_bitwise(got[1], sums)
    assert_bitwise(got[2], sumsqs)
    mean, std = matching._moments(int(count), np.asarray(sums, np.float64),
                                  np.asarray(sumsqs, np.float64))
    mean, std = mean.astype(np.float32), std.astype(np.float32)
    want = j_matching.pair_costs(*tile, max_d, mean, std, n_stats=4)
    got = matching.pair_costs(T(cp), T(cq), T(fp), T(fq), float(max_d), T(mean), T(std), 4)
    for g, w, n in zip(got, want, (len(cp), len(cp), len(cq), len(cq))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n])


def test_pair_stats_second_window_level():
    """A tile of more than 1,024 padded rows against a narrow one (2,048 x
    128): XLA sums the 64 x 4 window sums in 32 x 4 windows in an order
    not identified yet (neither row- nor column-major), so some of the 23
    sums differ from the port's in their last bits.  Held at the measured
    4.4e-7 of the sum."""
    cp, cq, fp, fq = matcher_tiles(n_post=1100, n_pre=70)
    count, sums, sumsqs = j_matching.pair_stats(*reference_tile(cp, cq, fp, fq),
                                                np.float32(1.0))
    got = matching.pair_stats(T(cp), T(cq), T(fp), T(fq), 1.0)
    assert got[0] == int(count)
    for g, w in ((got[1], sums), (got[2], sumsqs)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=4.4e-7, atol=0)


def marker_frame(ndim, n, seed=3):
    """A smooth frame and ``n`` marker coordinates (sorted, as argwhere)."""
    rng = np.random.default_rng(seed)
    shape = (12, 64, 64) if ndim == 3 else (128, 128)
    smooth = ndimage.gaussian_filter(rng.normal(size=shape), 1.5)
    intensity = (300 + 100 * smooth / smooth.std()).astype(np.uint16)
    frangi_im = (np.abs(smooth) * 1e-3).astype(np.float32)
    distance = (1.0 + rng.random(shape)).astype(np.float32)
    flat = np.sort(rng.choice(int(np.prod(shape)), n, replace=False))
    return intensity, frangi_im, distance, np.stack(np.unravel_index(flat, shape), 1)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("n", [200, 600])
def test_tracking_features_bitwise(ndim, n):
    """Chunks of 256 markers: 200 take the reference's inlined program, 600
    its loop over three chunks, whose multiply-adds differ."""
    intensity, frangi_im, distance, coords = marker_frame(ndim, n)
    chunk = 256
    nb = chunk
    while nb < n:
        nb *= 2
    cpad = np.zeros((nb, ndim), np.int32)
    cpad[:n] = coords
    valid = np.arange(nb) < n
    scaling = (0.5, 0.2, 0.2)[-ndim:]
    dmax = float(distance.max())
    r = j_tracking._next_multiple(max(int(np.ceil(2 * dmax)) * 2 + 1, 3), 4)
    want, _ = j_tracking._frame_features_fused(
        jnp.asarray(intensity), jnp.asarray(frangi_im), jnp.asarray(distance), jnp.asarray(cpad),
        jnp.asarray(valid), r=r, no_z=ndim == 2, chunk=chunk, scaling=scaling)
    got, _ = hu_tracking._frame_features_fused(
        T(intensity.astype(np.int32)), T(frangi_im), T(distance), T(coords), r, chunk, scaling)
    assert_bitwise(got, np.asarray(want)[:n])


# -- A3: free device memory ----------------------------------------------------

def test_free_bytes_count_cached_blocks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (3 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 10 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 4 << 30)
    assert adaptive_run.device_free_bytes(torch.device("cuda", 0)) == (3 + 10 - 4) << 30
    assert adaptive_run.device_free_bytes(torch.device("cpu")) is None
