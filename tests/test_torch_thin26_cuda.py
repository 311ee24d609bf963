"""The hand-written CUDA 3D thinning against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_thin26_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``skeleton.skeletonize_3d`` on a CUDA tensor launches
``kernels/csrc/thin26.cu`` once (no plain body, no ``fma_f32``) and equals
``skeletonize_3d_plain`` exactly, on the card and on CPU copies, on
``chip_smoke.thin_masks`` at even, odd and thin shapes and on the 3D main
path's frame (64x256x256, six tubes masked at 300); its rounds, host
reads, sweeps and CUDA kernels are ``chip_smoke.thin26_model``'s (one
persistent launch and one host read a call), and
``THIN26_KERNEL.kernel_launches`` grows by the call's CUDA kernels.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import _fp, skeleton
from nellie_tpu_torch.kernels.simple_point import get_simple26_lut

SHAPES = [(10, 18, 20), (9, 17, 21), (3, 40, 33), (1, 12, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(mask_np, dev, model=True):
    mask = torch.from_numpy(mask_np).to(dev)
    lut = skeleton.simple26_lut(dev)
    kernel = skeleton.THIN26_KERNEL
    before, kernels, fma = kernel.launches, kernel.kernel_launches, _fp.FMA_KERNEL.launches
    got = skeleton.skeletonize_3d(mask, lut)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and _fp.FMA_KERNEL.launches == fma
    assert got.dtype == torch.bool and got.device.type == "cuda" and got.shape == mask.shape
    assert torch.equal(got, skeleton.skeletonize_3d_plain(mask, lut))
    stats = kernel.last_stats
    assert kernel.kernel_launches == kernels + stats[3]
    if model:
        want, want_stats = chip_smoke.thin26_model(mask_np, get_simple26_lut())
        assert np.array_equal(got.cpu().numpy(), want) and stats == want_stats
    return got, stats


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_masks(cuda, shape):
    for name, m in chip_smoke.thin_masks(shape, seed=sum(shape)).items():
        got, _ = _check(m, cuda)
        assert torch.equal(got.cpu(), skeleton.skeletonize_3d_plain(torch.from_numpy(m))), name


@pytest.mark.gpu
def test_main_path_frame(cuda):
    mask = chip_smoke.make_frame((64, 256, 256)) > 300
    got, (rounds, reads, sweeps, kernels) = _check(mask, cuda, model=False)
    assert 0 < int(got.sum()) < int(mask.sum()) and reads == kernels == 1
    assert rounds >= 6 * sweeps


@pytest.mark.gpu
def test_input_stays_and_dtypes(cuda):
    m = chip_smoke.thin_masks((9, 17, 21))["blobs"]
    mask = torch.from_numpy(m).to(cuda)
    got = skeleton.skeletonize_3d(mask.to(torch.uint8))
    assert torch.equal(mask.cpu(), torch.from_numpy(m))
    assert torch.equal(got, skeleton.skeletonize_3d_plain(mask))


@pytest.mark.gpu
def test_refuses_bad_tables(cuda):
    mask = torch.zeros((3, 4, 5), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        skeleton.skeletonize_3d(mask, torch.zeros(16, dtype=torch.uint8, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [47, 48])
def test_one_launch_one_read(cuda, seed):
    """Every call is one persistent launch and one host read, with the
    rounds and sweeps of the model, on the caller's stream."""
    lut = skeleton.simple26_lut(cuda)
    table = get_simple26_lut()
    stream = torch.cuda.Stream()
    for name, m in chip_smoke.thin_masks((9, 17, 21), seed=seed).items():
        with torch.cuda.stream(stream):
            got = skeleton.THIN26_KERNEL(torch.from_numpy(m).to(cuda), lut)
        stream.synchronize()
        want, want_stats = chip_smoke.thin26_model(m, table)
        assert np.array_equal(got.cpu().numpy(), want), name
        assert skeleton.THIN26_KERNEL.last_stats == want_stats, name
        assert want_stats[1] == want_stats[3] == int(m.any())
