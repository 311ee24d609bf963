"""The port's capacity path against the JAX package's, on the CPU: the
chunked strategy, a 2D image and ``segment_path``.

The chunked strategy runs on a deliberately fine 3x3x3 grid (both
packages' ``_ccl_grid`` replaced), so that every merge path runs on a
small volume: its results equal the JAX package's chunked strategy (byte
counts included) and the monolith's product, and its pieces are held to
scipy.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.pipeline import capacity as j_cap
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.pipeline import capacity

PARAMS = dict(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
PARAMS_2D = dict(sigmas=(0.75, 1.1), spacing=(0.1, 0.1))
KW = dict(min_area=4, max_chunk_voxels=16 * 64 * 64)  # four vesselness windows
EMITS = ("labels", "sparse_labels", "mask")
KEYS = ("n_labels", "fg_count", "label_overflow", "emit", "strategy", "bytes_up", "bytes_down")


def tube_volume(shape=(24, 64, 64), seed=0):
    """One wavy tube on noise (the JAX package's chunked-capacity input)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    tube = 800.0 * np.exp(-(((z - 12) ** 2) * 0.3 + (y - 32 + 6 * np.sin(x / 8.0)) ** 2 / 2)
                          / (2 * 2.0 ** 2))
    return np.clip(tube + rng.normal(100, 5, shape), 0, 65535).astype(np.uint16)


def blob_mask(shape=(20, 40, 48), seed=1, thresh=0.8):
    """A random blobby mask with many components, holes and specks."""
    noise = ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=shape), 2.0)
    return noise > thresh * noise.std()


def tiny_grid(shape, n=3):
    return [tuple(int(round(d * i / n)) for i in range(n + 1)) for d in shape]


@pytest.fixture
def fine_grid(monkeypatch):
    for module in (j_cap, capacity):
        monkeypatch.setattr(module, "_ccl_grid", lambda shape, **_: tiny_grid(shape))


def assert_same_result(ref, got):
    for key in KEYS:
        if key in ref:
            assert got[key] == ref[key], (key, got[key], ref[key])
    if "labels" in ref:
        assert got["labels"].dtype == ref["labels"].dtype
        np.testing.assert_array_equal(got["labels"], ref["labels"])
    else:
        np.testing.assert_array_equal(got["mask_packed"], ref["mask_packed"])


@pytest.fixture(scope="module")
def jax_monolith():
    vol = tube_volume()
    return {emit: j_cap.segment_volume(vol, j_frangi.FrangiParams(**PARAMS), emit=emit,
                                       strategy="monolith", **KW) for emit in EMITS}


@pytest.mark.parametrize("emit", ("sparse_labels", "mask"))
def test_chunked_equals_jax_and_monolith(jax_monolith, fine_grid, emit):
    """The chunked strategy equals the JAX package's chunked strategy (byte
    counts included) and the monolith's product."""
    vol = tube_volume()
    ref = j_cap.segment_volume(vol, j_frangi.FrangiParams(**PARAMS), emit=emit,
                               strategy="chunked", **KW)
    got = capacity.segment_volume(vol, frangi.FrangiParams(**PARAMS), emit=emit,
                                  strategy="chunked", device="cpu", **KW)
    assert_same_result(ref, got)
    assert set(got["seconds"]) >= {"vesselness", "thresholds", "fill_holes", "area_filter",
                                   "smoothing", "cell_roots", "host_merge"}
    mono = jax_monolith[emit]
    if emit == "mask":
        np.testing.assert_array_equal(got["mask_packed"], mono["mask_packed"])
    else:
        assert got["n_labels"] == mono["n_labels"]
        np.testing.assert_array_equal(got["labels"], mono["labels"])


def test_chunked_labels_emit_equals_monolith(jax_monolith, fine_grid):
    got = capacity.segment_volume(tube_volume(), frangi.FrangiParams(**PARAMS), emit="labels",
                                  strategy="chunked", device="cpu", **KW)
    assert got["emit"] == "sparse_labels" and got["strategy"] == "chunked"
    np.testing.assert_array_equal(got["labels"], jax_monolith["labels"]["labels"])


def test_2d_volume_equals_jax():
    img = D.tube_series_2d(shape=(1, 96, 128))[0]
    ref = j_cap.segment_volume(img, j_frangi.FrangiParams(**PARAMS_2D), min_area=4,
                               emit="sparse_labels", max_chunk_voxels=48 * 128)
    got = capacity.segment_volume(img, frangi.FrangiParams(**PARAMS_2D), min_area=4,
                                  emit="sparse_labels", max_chunk_voxels=48 * 128, device="cpu")
    assert ref["n_labels"] > 0
    # more foreground than the sparse emit holds: both fall back to dense labels
    assert got["emit"] == ref["emit"] == "labels"
    assert_same_result(ref, got)
    chunked = capacity.segment_volume(img, frangi.FrangiParams(**PARAMS_2D), min_area=4,
                                      emit="sparse_labels", max_chunk_voxels=48 * 128,
                                      strategy="chunked", device="cpu")
    np.testing.assert_array_equal(chunked["labels"], ref["labels"])


def test_segment_path_writes_the_artifact(tmp_path):
    vol = tube_volume()
    paths = {}
    for side in ("jax", "port"):
        paths[side] = D.write_input(tmp_path / side, vol, D.DIM_RES_ZYX, axes="ZYX")
    ref = j_cap.segment_path(paths["jax"], min_area=4, sigmas=PARAMS["sigmas"])
    got = capacity.segment_path(paths["port"], min_area=4, sigmas=PARAMS["sigmas"], device="cpu")
    assert_same_result(ref, got)
    a = D.read(ref["im_info"], "im_instance_label")
    b = D.read(got["im_info"], "im_instance_label")
    assert a.dtype == b.dtype == np.int32 and a.max() > 0
    np.testing.assert_array_equal(b, a)


def _label_case(mask, n):
    labels, count, fg, _ = capacity._label_chunked(
        torch.from_numpy(mask), mask.shape, tiny_grid(mask.shape, n),
        capacity._Phases(torch.device("cpu")))
    ref, ref_n = ndimage.label(mask, structure=np.ones((3,) * mask.ndim))
    assert count == ref_n and fg == int(mask.sum())
    np.testing.assert_array_equal(labels.astype(np.int64), ref)
    return labels


@pytest.mark.parametrize("case", ["3d", "2d"])
def test_chunked_label_matches_scipy(case):
    mask = blob_mask() if case == "3d" else blob_mask((40, 48), seed=3)
    assert _label_case(mask, 3 if case == "3d" else 4).dtype == np.uint16


def test_chunked_label_widens_past_65535():
    mask = np.zeros((600, 600), bool)
    mask[::2, ::2] = True  # 90,000 isolated voxels
    assert _label_case(mask, 3).dtype == np.int32


def test_chunked_fill_holes_matches_scipy():
    mask = blob_mask()
    mask[4:11, 10:20, 12:24] = True  # a closed shell across three cell boundaries
    mask[5:10, 11:19, 13:23] = False
    got = torch.from_numpy(mask.copy())
    capacity._fill_holes_chunked(got, mask.shape, tiny_grid(mask.shape),
                                 capacity._Phases(torch.device("cpu")))
    want = ndimage.binary_fill_holes(mask)
    assert (want & ~mask).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_remove_small_matches_whole_volume():
    mask = blob_mask()
    got = torch.from_numpy(mask.copy())
    capacity._remove_small_chunked(got, mask.shape, tiny_grid(mask.shape), 9,
                                   capacity._Phases(torch.device("cpu")))
    labels, _ = ndimage.label(mask, structure=np.ones((3, 3, 3)))
    sizes = np.bincount(labels.ravel())
    want = mask & (sizes[labels] >= 9)
    assert (mask & ~want).any()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, ccl.remove_small_components(torch.from_numpy(mask), 9).numpy())
