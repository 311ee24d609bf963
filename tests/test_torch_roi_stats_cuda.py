"""The hand-written CUDA ROI statistics against their plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_roi_stats_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``moments.masked_mean_variance`` on a CUDA tensor launches
``kernels/csrc/roi_stats.cu`` once (one CUDA kernel, no host read) and
equals ``masked_mean_variance_plain`` bit for bit, on the card and on CPU
copies: the ROI sets of ``chip_smoke.ROI_CASES`` (16^3, 20^2 and 20^3 ROIs,
sums that stay subnormal, subnormal voxels, an empty ROI each), signed
voxels cancelling at a block's end, an odd number of ROIs, float16 ROIs,
and the tracker's features end to end.
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
@pytest.mark.parametrize("images", ["signed", "odd", "float16"])
def test_other_inputs(cuda, images):
    x = {"signed": lambda: chip_smoke.signed_rois(),
         "odd": lambda: chip_smoke.roi_inputs((33, 9, 9, 9), seed=2),
         "float16": lambda: chip_smoke.roi_inputs((40, 20, 20), seed=3).astype(np.float16)}[images]()
    assert chip_smoke.check_roi_stats(images, torch.from_numpy(x).to(cuda),
                                      against_cpu=True) == 0.0


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
