"""The hand-written CUDA min-plus EDT against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_edt_cuda.py

``edt.distance_transform`` on a CUDA tensor launches
``kernels/csrc/edt_minplus.cu`` (one kernel an axis, no host read) and
equals ``distance_transform_plain`` bit for bit, on the card and on CPU
copies, on ``chip_smoke.EDT_CASES`` (the Markers' clamps, no clamp,
anisotropic sampling, an axis shorter than the clamp, one axis, a frame
with no background, one with no foreground, a clamp of 15, a halo in
chunks) and at the main paths' shapes (64 x 256 x 256 clamped at 11,
1024 x 1024 at 21, and both at 15, a clamp neither path uses: one kernel
body serves every window).
"""
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import edt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(mask, sampling, radius):
    kernel = edt.EDT_MINPLUS_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    got = edt.distance_transform(mask, sampling, radius)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.kernel_launches == kernels + mask.ndim == kernels + \
        kernel.last_stats["cuda_kernels"]
    assert got.dtype == torch.float32 and got.shape == mask.shape
    assert chip_smoke.same_tensor(got, edt.distance_transform_plain(mask, sampling, radius))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.EDT_CASES))
def test_cases(cuda, name):
    _, sampling, radius, _ = chip_smoke.EDT_CASES[name]
    mask = torch.from_numpy(chip_smoke.edt_case_mask(name, seed=len(name)))
    got = _check(mask.to(cuda), sampling, radius)
    assert chip_smoke.same_tensor(got.cpu(), edt.distance_transform_plain(mask, sampling, radius))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,radius", [((64, 256, 256), 11), ((1024, 1024), 21),
                                          ((64, 256, 256), 15), ((1024, 1024), 15)])
def test_main_path_shapes(cuda, shape, radius):
    mask = torch.from_numpy(chip_smoke.edt_mask(shape, seed=1, fill=0.1)).to(cuda)
    got = _check(mask, None, radius)
    _, reads = chip_smoke.host_reads(lambda: edt.distance_transform(mask, None, radius))
    wait_ms = chip_smoke.host_wait_ms(lambda: edt.distance_transform(mask, None, radius))
    assert reads == 0 and wait_ms < chip_smoke.QUEUED_MS / 2
    assert float(got.max()) > 0


@pytest.mark.gpu
def test_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        edt.EDT_MINPLUS_KERNEL(torch.zeros((3, 4), dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError):
        edt.EDT_MINPLUS_KERNEL(torch.zeros((2, 3, 4, 5), dtype=torch.bool, device=cuda))
    empty = torch.zeros((0, 5), dtype=torch.bool, device=cuda)
    assert edt.distance_transform(empty).shape == (0, 5)
