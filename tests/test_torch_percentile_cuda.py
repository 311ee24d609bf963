"""The hand-written CUDA masked percentile against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_percentile_cuda.py

``frangi.masked_percentile_forms`` on a CUDA tensor launches
``kernels/csrc/masked_percentile.cu`` (a memset and one persistent kernel,
no sort, no host read; both forms of the last step, A and B, as a (2,)
float32 on the card; ``masked_percentile`` takes form B) and equals
``masked_percentile_plain`` bit for bit (NaN where NaN), on the card and on
CPU copies, on ``chip_smoke.PERCENTILE_CASES`` at q in {0, 1, 50, 100}
(masked NaNs past the +inf pads, zeros of both signs in the values'
order among them), on a 10^6-value positive sample, on 10^6 values with
masked NaNs or signed zeros (the zeros' sign found across many blocks),
and on strided views.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import frangi


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(values, mask, q):
    kernel = frangi.MASKED_PERCENTILE_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    got = frangi.masked_percentile_forms(values, mask, q)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.kernel_launches == kernels + kernel.last_stats["cuda_kernels"]
    assert got.dtype == torch.float32 and got.shape == (2,) and got.device == values.device
    want = frangi.masked_percentile_plain(values, mask, q)
    assert chip_smoke.same_tensor(got, want), (q, got.tolist(), want.tolist())
    one = frangi.masked_percentile(values, mask, q)
    assert one.shape == () and chip_smoke.same_tensor(one, want[frangi.B])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", chip_smoke.PERCENTILE_CASES)
def test_cases(cuda, name):
    values, mask = chip_smoke.percentile_inputs(name, seed=len(name))
    for q in chip_smoke.PERCENTILE_QS:
        got = _check(torch.from_numpy(values).to(cuda), torch.from_numpy(mask).to(cuda), q)
        cpu = frangi.masked_percentile_plain(torch.from_numpy(values), torch.from_numpy(mask), q)
        assert chip_smoke.same_tensor(got.cpu(), cpu), (name, q)


@pytest.mark.gpu
@pytest.mark.parametrize("q", chip_smoke.PERCENTILE_QS)
def test_callers_sample(cuda, q):
    values, mask = chip_smoke.percentile_inputs("positive sample", n=10 ** 6, seed=3)
    values, mask = torch.from_numpy(values).to(cuda), torch.from_numpy(mask).to(cuda)
    _check(values, mask, q)
    _, reads = chip_smoke.host_reads(lambda: frangi.masked_percentile_forms(values, mask, q))
    wait_ms = chip_smoke.host_wait_ms(lambda: frangi.masked_percentile_forms(values, mask, q))
    assert reads == 0 and wait_ms < chip_smoke.QUEUED_MS / 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["masked NaN", "masked NaN, all masked", "signed zeros"])
def test_nan_and_signed_zeros_across_blocks(cuda, name):
    values, mask = chip_smoke.percentile_inputs(name, n=10 ** 6, seed=5)
    values, mask = torch.from_numpy(values).to(cuda), torch.from_numpy(mask).to(cuda)
    for q in chip_smoke.PERCENTILE_QS + (37.0, 99.0):
        _check(values, mask, q)


@pytest.mark.gpu
def test_strided_views(cuda):
    frame = torch.from_numpy(chip_smoke.make_frame((24, 96, 96)) - 110.0).to(cuda)
    sample = frame[::2, ::3, ::2]
    _check(sample, sample > 0, 1.0)
    flat = frame.reshape(-1)[::7]
    _check(flat, flat > 0, 1.0)
    _check(flat.half(), flat > 0, 50.0)


@pytest.mark.gpu
def test_refuses_what_it_does_not_take(cuda):
    v = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        frangi.MASKED_PERCENTILE_KERNEL(v, torch.ones(8, dtype=torch.uint8, device=cuda), 1.0)
    with pytest.raises(ValueError):
        frangi.MASKED_PERCENTILE_KERNEL(v, v > 0, 101.0)
    with pytest.raises(TypeError):
        frangi.MASKED_PERCENTILE_KERNEL(v.int(), v > 0, 1.0)
    empty = torch.empty(0, device=cuda)
    assert float(frangi.masked_percentile(empty, empty > 0, 1.0)) == 0.0
    assert np.float32(frangi.masked_percentile(v, v < 0, 1.0).cpu()) == 0.0
    assert frangi.masked_percentile_forms(v, v < 0, 1.0).cpu().tolist() == [0.0, 0.0]


@pytest.mark.gpu
@pytest.mark.parametrize("a_less", [True, False])
def test_finalize_cross_frames(cuda, a_less):
    """The finalize on ``chip_smoke.finalize_cross_frame``'s frames (each
    opening term in its own form): the card equals the CPU bit for bit, and
    each cross is kept or dropped as ``frangi.FINALIZE_FORMS`` says."""
    for ndim in (3, 2):
        frame, _, _, crosses = chip_smoke.finalize_cross_frame(ndim, a_less)
        got = frangi.finalize_frame(torch.from_numpy(frame).to(cuda)).cpu()
        want = frangi.finalize_frame(torch.from_numpy(frame))
        assert chip_smoke.same_tensor(got, want), (ndim, a_less)
        for name, (centre, kept) in crosses.items():
            assert bool(got[centre] != 0) == kept, (ndim, name)
