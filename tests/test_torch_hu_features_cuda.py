"""The hand-written CUDA log-Hu features against their plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_hu_features_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``moments.hu_features`` on a CUDA tensor launches ``kernels/csrc/hu_features.cu``
once (one CUDA kernel, no host read) and equals ``hu_features_plain`` bit
for bit on the card and on CPU copies: ``chip_smoke.HU_CASES`` (16^3 and
20^2 ROIs inlined and looped, 13^3, 7^2, 5 x 9 x 6 and 1^3 ROIs, all-zero
ROIs among them, and mirror-symmetric ROIs whose h4 cancels to a
subnormal), both main paths' largest calls (338 ROIs of 16^3, 1,024 of
20^2 looped), a strided view and float16 ROIs.
"""
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import moments


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(cubes, looped):
    kernel = moments.HU_FEATURES_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    got = moments.hu_features(cubes, looped)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and kernel.kernel_launches == kernels + 1
    assert kernel.last_stats == {"cuda_kernels": 1, "host_reads": 0}
    feats = 18 if cubes.dim() == 4 else 6
    assert got.dtype == torch.float32 and got.shape == (cubes.shape[0], feats)
    for want in (moments.hu_features_plain(cubes, looped),
                 moments.hu_features_plain(cubes.cpu(), looped)):
        assert chip_smoke.same_tensor(got.to(want.device), want), (tuple(cubes.shape), looped,
                                                                   want.device)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.HU_CASES))
def test_cases(cuda, name):
    shape, looped = chip_smoke.HU_CASES[name]
    x = chip_smoke.symmetric_hu_rois() if name == "symmetric" else \
        chip_smoke.hu_rois(shape, seed=len(name))
    _check(torch.from_numpy(x).to(cuda), looped)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, looped", [((338, 16, 16, 16), False), ((1024, 20, 20), True)])
def test_main_paths_largest_calls(cuda, shape, looped):
    cubes = torch.from_numpy(chip_smoke.hu_rois(shape, seed=7)).to(cuda)
    _check(cubes, looped)
    _, reads = chip_smoke.host_reads(lambda: moments.hu_features(cubes, looped))
    wait_ms = chip_smoke.host_wait_ms(lambda: moments.hu_features(cubes, looped))
    assert reads == 0 and wait_ms < chip_smoke.QUEUED_MS / 2


@pytest.mark.gpu
def test_views_and_float16(cuda):
    x = torch.from_numpy(chip_smoke.hu_rois((40, 16, 16, 16), seed=3)).to(cuda)
    _check(x[::2], True)
    _check(x.transpose(2, 3), False)
    _check(x[:, 0].half(), False)


@pytest.mark.gpu
def test_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        moments.HU_FEATURES_KERNEL(torch.ones(4, 8, 8, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        moments.HU_FEATURES_KERNEL(torch.ones(4, 8, device=cuda))
    with pytest.raises(TypeError):
        moments.HU_FEATURES_KERNEL(torch.ones(4, 8, 8))
    assert moments.hu_features(torch.ones(0, 8, 8, device=cuda)).shape == (0, 6)
