"""The hand-written CUDA ROI statistics against their plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_roi_stats_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``moments.masked_mean_variance`` on a CUDA tensor launches
``kernels/csrc/roi_stats.cu`` once (one CUDA kernel, no host read) and
equals ``masked_mean_variance_plain`` bit for bit, on the card and on CPU
copies: the ROI sets of ``chip_smoke.ROI_CASES`` (16^3, 20^2 and 20^3 ROIs,
sums that stay subnormal, subnormal voxels, 17^3 ROIs that start off 16
bytes, 48^3 ROIs past shared memory, ROI counts below and above the SMs,
an empty ROI each), signed voxels cancelling at a block's end, an odd
number of ROIs, ROIs from a base off 16 bytes, float16 ROIs, and the
tracker's features end to end.  ``ROI_STATS_KERNEL.chain_floor`` (the
chain that bounds the kernel, run alone) gives the plain sum of squares.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import moments
from nellie_tpu_torch.stages import hu_tracking


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.ROI_CASES))
def test_cases(cuda, name):
    shape, scale, fill = chip_smoke.ROI_CASES[name]
    images = torch.from_numpy(chip_smoke.roi_inputs(shape, scale, fill, seed=1)).to(cuda)
    assert chip_smoke.check_roi_stats(name, images, against_cpu=True) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("images", ["signed", "odd", "float16", "base + 4"])
def test_other_inputs(cuda, images):
    x = {"signed": lambda: chip_smoke.signed_rois(),
         "odd": lambda: chip_smoke.roi_inputs((33, 9, 9, 9), seed=2),
         "float16": lambda: chip_smoke.roi_inputs((40, 20, 20), seed=3).astype(np.float16),
         "base + 4": lambda: chip_smoke.roi_inputs((41, 10, 10), seed=4)}[images]()
    t = torch.from_numpy(x).to(cuda)
    if images == "base + 4":  # a view whose first ROI starts 4 bytes past 16
        t = t.reshape(-1)[1:1 + 40 * 100].reshape(40, 10, 10)
        assert t.data_ptr() % 16 == 4
    assert chip_smoke.check_roi_stats(images, t, against_cpu=True) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("voxels", [400, 4096, 4913])
def test_chain_floor(cuda, voxels):
    """The chain run alone is the plain body's sum of squares: a float64
    term added to the float32 sum and rounded, terms dropped until the
    first normal one at each block of 4,096."""
    x = chip_smoke.roi_inputs((2, voxels), seed=voxels)[1]
    x[:7] = 1e-30  # squares below the smallest normal float32: dropped
    want, keep = np.float32(0), False
    for k, v in enumerate(x.astype(np.float64)):
        keep = (keep or np.float32(v * v) >= np.finfo(np.float32).tiny) if k % 4096 else \
            (want != 0 or np.float32(v * v) >= np.finfo(np.float32).tiny)
        want = np.float32(np.float64(want) + (v * v if keep else 0.0))
    got = moments.ROI_STATS_KERNEL.chain_floor(torch.from_numpy(x).to(cuda))
    assert chip_smoke.same_bits(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_tracking_features(cuda):
    """The tracker's frame features on the card equal those on the CPU."""
    rng = np.random.default_rng(4)
    shape = (16, 48, 48)
    intensity = torch.from_numpy(rng.integers(0, 1000, shape).astype(np.int32))
    frangi = torch.from_numpy((rng.random(shape) * (rng.random(shape) < 0.3)).astype(np.float32))
    distance = torch.from_numpy((1 + 2.5 * rng.random(shape)).astype(np.float32))
    coords = torch.from_numpy(np.argwhere(rng.random(shape) < 0.002))
    want, _ = hu_tracking._frame_features_fused(intensity, frangi, distance, coords, 16, 1024,
                                                (0.5, 0.2, 0.2))
    before = moments.ROI_STATS_KERNEL.launches
    got, _ = hu_tracking._frame_features_fused(intensity.to(cuda), frangi.to(cuda),
                                               distance.to(cuda), coords.to(cuda), 16, 1024,
                                               (0.5, 0.2, 0.2))
    assert moments.ROI_STATS_KERNEL.launches == before + 1
    assert chip_smoke.same_bits(got[:, :4].cpu().numpy(), want[:, :4].numpy()).all()
