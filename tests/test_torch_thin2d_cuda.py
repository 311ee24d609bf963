"""The hand-written CUDA 2D thinning against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_thin2d_cuda.py

``skeleton.skeletonize_2d`` on a CUDA tensor launches
``kernels/csrc/thin2d.cu`` (a memset and one persistent kernel, no host
read) and equals ``skeletonize_2d_plain`` exactly, on the card and on CPU
copies, on ``chip_smoke.thin2d_masks`` (tubes, blobs, one-pixel lines, a
cross and a block touching the edges, noise, empty, full) at even, odd,
one-row and one-column shapes, and on the 2D main path's 1024 x 1024 frame.
"""
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import skeleton

SHAPES = [(48, 64), (33, 47), (1, 12), (12, 1), (130, 257)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(mask):
    kernel = skeleton.THIN2D_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    got = skeleton.skeletonize_2d(mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.kernel_launches == kernels + kernel.last_stats["cuda_kernels"]
    assert got.dtype == torch.bool and got.device == mask.device and got.shape == mask.shape
    assert torch.equal(got, skeleton.skeletonize_2d_plain(mask))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_masks(cuda, shape):
    for name, m in chip_smoke.thin2d_masks(shape, seed=sum(shape)).items():
        mask = torch.from_numpy(m)
        got = _check(mask.to(cuda))
        assert torch.equal(got.cpu(), skeleton.skeletonize_2d_plain(mask)), name


@pytest.mark.gpu
def test_main_path_frame(cuda):
    mask = torch.from_numpy(chip_smoke.make_frame_2d((1024, 1024)) > 300).to(cuda)
    got = _check(mask)
    assert 0 < int(got.sum()) < int(mask.sum())


@pytest.mark.gpu
def test_no_host_read(cuda):
    mask = torch.from_numpy(chip_smoke.make_frame_2d((1024, 1024), seed=1) > 300).to(cuda)
    _, reads = chip_smoke.host_reads(lambda: skeleton.skeletonize_2d(mask))
    wait_ms = chip_smoke.host_wait_ms(lambda: skeleton.skeletonize_2d(mask))
    assert reads == 0 and skeleton.THIN2D_KERNEL.last_stats["host_reads"] == 0
    assert wait_ms < chip_smoke.QUEUED_MS / 2


@pytest.mark.gpu
def test_input_types_and_stays(cuda):
    m = chip_smoke.thin2d_masks((33, 47))["blobs"]
    mask = torch.from_numpy(m).to(cuda)
    want = skeleton.skeletonize_2d_plain(mask)
    for x in (mask.to(torch.uint8), mask.to(torch.int32) * 3, mask.t().contiguous().t()):
        assert torch.equal(skeleton.skeletonize_2d(x), want)
    assert torch.equal(mask.cpu(), torch.from_numpy(m))
    assert skeleton.skeletonize_2d(mask[:0]).shape == (0, 47)


@pytest.mark.gpu
def test_refuses_other_ranks(cuda):
    with pytest.raises(TypeError):
        skeleton.THIN2D_KERNEL(torch.zeros((2, 3, 4), dtype=torch.bool, device=cuda))
