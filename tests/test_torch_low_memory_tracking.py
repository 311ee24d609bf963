"""The port's row-tiled matcher against the JAX package, on the CPU: a
``mode="sparse"`` tracking run from a config, with more markers than one
tile (every flow row exact, costs included), and ``matching.match_frames``
with small tiles.
"""
import numpy as np
import pytest
from scipy import ndimage

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import matching as j_matching
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu_torch.config import SettingsConfig
from nellie_tpu_torch.kernels import matching
from nellie_tpu_torch.pipeline.run import params_from_config
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking

COST_ATOL = 1e-4


def write_artifacts(im_info, arrays):
    for name, arr in arrays.items():
        im_info.allocate_memory(im_info.pipeline_paths[name], dtype=arr.dtype.name, data=arr,
                                description=name)


def many_markers(shape=(2, 12, 64, 64), n=1500, seed=5):
    """Artifacts for tracking alone: smooth intensity and Frangi images
    (frame 1 is frame 0 moved one voxel along X), ``n`` markers a frame,
    moved likewise, and a small distance image."""
    rng = np.random.default_rng(seed)
    smooth = ndimage.gaussian_filter(rng.normal(size=shape[1:]), 1.5)
    frame = 300 + 100 * smooth / smooth.std()
    im = np.stack([np.roll(frame, t, axis=2) for t in range(shape[0])]).astype(np.uint16)
    frangi = np.stack([np.roll(np.abs(smooth), t, axis=2) for t in range(shape[0])])
    frangi = (frangi * 1e-3).astype(np.float32)
    marker = np.zeros(shape, np.uint8)
    flat = rng.choice(int(np.prod(shape[1:])), n, replace=False)
    idx = np.stack(np.unravel_index(flat, shape[1:]), 1)
    for t in range(shape[0]):
        moved = idx.copy()
        moved[:, 2] = (moved[:, 2] + t) % shape[3]
        marker[(t,) + tuple(moved.T)] = 1
    distance = (1.0 + rng.random(shape)).astype(np.float32)
    return im, {"im_preprocessed": frangi, "im_marker": marker, "im_distance": distance}


def test_tracking_tiles_from_config(tmp_path):
    """``tracking_mode="sparse"`` reaches tracking, whose 1,024-row tiles
    (1,500 markers a frame) give the JAX package's flow rows exactly, costs
    included; the constructor takes ``mode`` itself too."""
    im, arrays = many_markers()
    arrays["im_instance_label"] = arrays["im_marker"].astype(np.int32)
    jax_info, port_info = D.two_copies(tmp_path, im)
    for im_info in (jax_info, port_info):
        write_artifacts(im_info, arrays)
    JTracking(jax_info, mode="sparse").run()
    HuMomentTracking(port_info, device="cpu", **params_from_config(
        SettingsConfig(tracking_mode="sparse"))["tracking"]).run()
    a, b = D.read(jax_info, "flow_vector_array"), D.read(port_info, "flow_vector_array")
    assert a.shape == b.shape and a.shape[0] > 1024
    np.testing.assert_array_equal(b, a)
    assert HuMomentTracking(port_info, device="cpu", mode="sparse")._tile_rows(1500, 1500) == 1024


@pytest.mark.parametrize("tile_rows", [16, 50, 1000])
def test_match_frames_tiled(tile_rows):
    """Tiles smaller than the marker count: the same matches, costs within
    1e-4."""
    rng = np.random.default_rng(tile_rows)
    n_post, n_pre = 170, 150
    coords_pre = rng.integers(0, 20, (n_pre, 3)) * np.array([0.5, 0.2, 0.2])
    coords_post = coords_pre[rng.integers(0, n_pre, n_post)] + rng.normal(0, 0.2, (n_post, 3))
    feats = [rng.normal(0, 1, (n, 22)).astype(np.float32) for n in (n_post, n_pre)]
    args = (coords_post, coords_pre, feats[0][:, :4], feats[1][:, :4], feats[0][:, 4:],
            feats[1][:, 4:], 1.0)
    ref = j_matching.match_frames(*args, tile_rows=tile_rows)
    got = matching.match_frames(*args, tile_rows=tile_rows, device="cpu")
    assert len(ref[0]) > 0
    assert got[0] == ref[0] and got[1] == ref[1]
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=COST_ATOL)
