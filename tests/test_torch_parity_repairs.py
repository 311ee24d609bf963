"""The port's rounding mirrors of XLA's CPU code and its device free-memory
figure, held to the JAX package on the CPU.

* ``_fp.cos``, ``_fp.acos`` / ``_fp.atan2``, ``_fp.exp`` and ``_fp.log``
  equal ``jax.jit`` of the ``jnp`` functions bit for bit on 10**6 seeded
  points of the ranges the kernels give them (the 3D eigen solver's angles
  and its ``acos`` argument, the Frangi response's exponents, the log of
  the tracker's and Label's positive values).
* ``eigvalsh3`` equals the reference's bit for bit.
* The tracker's masked pair sums (XLA's 32 x 32 tree reduction), its pair
  costs, and its Hu features in both of the reference's programs (one
  chunk of markers, inlined, and several, a loop) are bitwise (the
  ``mode="sparse"`` tracking run is held to the reference exactly in
  ``tests/test_torch_low_memory_tracking.py``).
* ``_fp.pow`` equals ``jax.jit`` of ``jnp.power`` at the Hu moments'
  exponents (1, 1.5, ..., 4, formed in the program as the tracker forms
  them) bit for bit on 2 * 10**5 seeded values around the tracker's
  ``m00`` range.
* The matcher's second window level (LLVM's vectorised reduce-window) is
  bitwise too, and a whole 3D Filter frame at the one width where XLA fuses
  the Hessian's inner gradient whole (128).  The 3D and 2D vesselness, the
  Filter stage and the frame at width 256 are in
  ``tests/test_torch_parity_repairs_filter.py``.
* ``nearest_neighbors`` and ``match_frames`` default to the card.
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
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import eigen as j_eigen
from nellie_tpu.kernels import matching as j_matching
from nellie_tpu.stages import hu_tracking as j_tracking
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import _fp, eigen, matching, nn
from nellie_tpu_torch.stages import hu_tracking
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.utils import adaptive_run

N = 1_000_000
T = torch.from_numpy


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    differ = (got.view(np.int32) != want.view(np.int32)) & ~(np.isnan(got) & np.isnan(want))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


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


# the tracker's m00 on the test inputs lies in [2.8e4, 8.3e4] (3D and 2D
# series); the sweep covers a decade on either side and the edge values
M00_RANGE = (2.7e3, 8.3e5)


@pytest.mark.parametrize("exponent", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0])
def test_pow_bitwise_to_xla(exponent):
    """``_fp.pow`` against ``jnp.power`` at the Hu normalisation's
    exponents, formed in the program from i + j as the reference's tracker
    forms them (its compiled loop calls ``powf`` for every exponent)."""
    rng = np.random.default_rng(int(exponent * 10))
    x = (10 ** rng.uniform(*np.log10(M00_RANGE), N // 5)).astype(np.float32)
    x[:8] = [0, 1, 2, 1e-40, 3e-39, np.inf, np.nan, 3.4e38]
    ipj = np.add.outer(np.arange(4), np.arange(4)).astype(np.int32)
    i, j = np.argwhere((ipj + 2) / 2.0 == exponent)[0]
    want = jax.jit(lambda m, k: m[:, None, None] ** ((k[None] + 2) / 2.0))(x, ipj)
    assert_bitwise(_fp.pow(T(x), exponent), np.asarray(want)[:, i, j])


def test_eigvalsh3_bitwise():
    rng = np.random.default_rng(5)
    h = [rng.normal(0, 3, 50_000).astype(np.float32) for _ in range(6)]
    h[3][:1000] = h[0][:1000]  # repeated diagonals
    want = jax.jit(j_eigen.eigvalsh3)(*h)
    for w, g in zip(want, eigen.eigvalsh3(*[T(a) for a in h])):
        assert_bitwise(g, w)


@pytest.mark.parametrize("width", [128])
def test_filter_3d_whole_frames_at_fused_widths(tmp_path, width):
    """Whole 3D frames whose last axis is 128, the one width at which XLA
    fuses the inner gradient of ``hzz`` whole (``hessian._fuses_inner_gradient``),
    and the main 3D shape's width, 256: ``im_preprocessed`` bit for bit."""
    ref, port = D.two_copies(tmp_path, D.tube_series((3, 12, 48, width)))
    JFilter(ref).run()
    Filter(port, device="cpu").run()
    D.assert_artifact_equal(ref, port, "im_preprocessed", "exact")


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
    got = matching.pair_stats(T(cp), T(cq), T(fp), T(fq), float(max_d),
                              padded=(len(tile[0]), len(tile[1])))
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


@pytest.mark.parametrize("n_post, n_pre", [(1100, 70), (1100, 200), (2500, 70)])
def test_pair_stats_second_window_level(n_post, n_pre):
    """Tiles of more than 1,024 padded rows against a narrow one (2,048 x
    128, 2,048 x 256, 4,096 x 128): XLA sums the window sums in 32-row
    windows whose kernel LLVM vectorises across rows (8 lanes of 4
    columns, 4 lanes of 8), then adds the lanes in halves.  Bitwise."""
    cp, cq, fp, fq = matcher_tiles(n_post=n_post, n_pre=n_pre)
    tile = reference_tile(cp, cq, fp, fq)
    count, sums, sumsqs = j_matching.pair_stats(*tile, np.float32(1.0))
    got = matching.pair_stats(T(cp), T(cq), T(fp), T(fq), 1.0,
                              padded=(len(tile[0]), len(tile[1])))
    assert got[0] == int(count)
    assert_bitwise(got[1], sums)
    assert_bitwise(got[2], sumsqs)


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


def test_host_array_entry_points_default_to_cuda(monkeypatch):
    """``nearest_neighbors`` and ``match_frames`` without ``device`` ask for
    the card, and without one raise ``resolve_device``'s error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device("cuda")
    pts = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    feats = np.ones((20, 4), np.float32)
    with pytest.raises(RuntimeError) as got:
        nn.nearest_neighbors(pts, pts)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError) as got:
        matching.match_frames(pts, pts, feats, feats, feats, feats, 1.0)
    assert str(got.value) == str(want.value)


def test_free_bytes_count_cached_blocks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (3 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 10 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 4 << 30)
    assert adaptive_run.device_free_bytes(torch.device("cuda", 0)) == (3 + 10 - 4) << 30
    assert adaptive_run.device_free_bytes(torch.device("cpu")) is None
