"""The hand-written CUDA histogram thresholds against their plain bodies.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_hist_threshold_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``thresholds.otsu_threshold``, ``triangle_threshold``, ``triangle_and_otsu``
and ``min_triangle_otsu`` on a CUDA tensor launch
``kernels/csrc/hist_threshold.cu`` (two CUDA kernels, no host read) and
equal their plain bodies bit for bit, on the card and on CPU copies: the
samples of ``chip_smoke.THRESHOLD_CASES`` (an empty mask, a span of 0, one
masked value, two bins, both triangle flips, no mask, 100, 1,000 and
10,000 bins, a frame's worth of values, more than 2^24 values) and of
``chip_smoke.STRIDE_THRESHOLD_CASES`` (the Filter's stride samples of a 3D
frame and a capacity window, no positive voxel, a full mask past the
kernel's record, a masked NaN, 9,000 bins), float16 values, 2-D values
with a 2-D mask, values and mask off 16 bytes; a call returns before 50
ms of work queued on the card ends; arguments it does not take raise.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import thresholds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(name, dev, seed=0):
    kind, rule, nbins, n = chip_smoke.THRESHOLD_CASES[name]
    v, m = chip_smoke.threshold_inputs(kind, rule, n, seed=seed)
    return (torch.from_numpy(v).to(dev), None if m is None else torch.from_numpy(m).to(dev),
            nbins)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.THRESHOLD_CASES))
def test_cases(cuda, name):
    values, mask, nbins = _inputs(name, cuda)
    assert chip_smoke.check_thresholds(name, values, mask, nbins,
                                       against_cpu=values.numel() < 10 ** 5) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.STRIDE_THRESHOLD_CASES))
def test_stride_cases(cuda, name):
    shape, stride, rule, nbins = chip_smoke.STRIDE_THRESHOLD_CASES[name]
    v, m = chip_smoke.stride_threshold_inputs(shape, stride, rule)
    assert chip_smoke.check_thresholds(name, torch.from_numpy(v).to(cuda),
                                       torch.from_numpy(m).to(cuda), nbins,
                                       against_cpu=v.size < 10 ** 5) == 0.0


@pytest.mark.gpu
def test_off_16_bytes(cuda):
    """Values and mask that start off 16 bytes take the byte-wise walk."""
    values, mask, nbins = _inputs("64x256x256 values", cuda, seed=6)
    assert values[1:].data_ptr() % 16 and mask[1:].data_ptr() % 16
    assert chip_smoke.check_thresholds("off 16 bytes", values[1:], mask[1:], nbins) == 0.0


@pytest.mark.gpu
def test_float16_and_2d(cuda):
    values, mask, nbins = _inputs("bimodal", cuda, seed=5)
    chip_smoke.check_thresholds("float16", values.half(), mask, nbins, against_cpu=True)
    chip_smoke.check_thresholds("2-D", values.reshape(40, 100), mask.reshape(40, 100), nbins,
                                against_cpu=True)


@pytest.mark.gpu
def test_no_host_read(cuda):
    values, mask, _ = _inputs("64x256x256 values", cuda)
    assert chip_smoke.check_host_waits() >= chip_smoke.QUEUED_MS / 2
    for fn in (thresholds.otsu_threshold, thresholds.triangle_threshold,
               thresholds.triangle_and_otsu, thresholds.min_triangle_otsu):
        assert chip_smoke.host_wait_ms(lambda: fn(values, mask)) < chip_smoke.QUEUED_MS / 2


@pytest.mark.gpu
def test_refuses(cuda):
    values, mask, _ = _inputs("bimodal", cuda)
    with pytest.raises(ValueError):
        thresholds.otsu_threshold(values, mask.float())
    with pytest.raises(ValueError):
        thresholds.otsu_threshold(values, mask[:10])
    with pytest.raises(RuntimeError):  # the C entry point's cudaErrorInvalidValue
        thresholds.min_triangle_otsu(values, mask, nbins=1)
