"""The hand-written CUDA fused multiply-add against its plain version.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_fp_fma_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  ``_fp.fma``
on a CUDA tensor launches ``kernels/csrc/fma_f32.cu`` once and equals
``_fp.fma_plain`` (round to odd in float64 torch) on the card and on CPU
copies bit for bit, NaN where NaN, on ``chip_smoke.fma_operands``, strided
views, numbers, 0-dim tensors and broadcast shapes.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import _fp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert chip_smoke.same_bits(got.cpu().numpy(), want.cpu().numpy()).all()


def _check(args):
    before = _fp.FMA_KERNEL.launches
    got = _fp.fma(*args)
    torch.cuda.synchronize()
    assert _fp.FMA_KERNEL.launches == before + 1 and got.device.type == "cuda"
    _same(got, _fp.fma_plain(*args))
    _same(got, _fp.fma_plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_equals_plain_version(cuda, seed):
    ops = [torch.from_numpy(x).to(cuda) for x in chip_smoke.fma_operands(1 << 20, seed=seed)]
    _check(ops)
    assert not chip_smoke.same_bits(chip_smoke.fma_rounded_twice(*(o.cpu() for o in ops)),
                                    _fp.fma(*ops).cpu().numpy()).all()


@pytest.mark.gpu
def test_the_double_rounding_case(cuda):
    a = torch.tensor(np.float32(1 + 2 ** -12), device=cuda)
    c = torch.tensor(np.float32(2 ** -60), device=cuda)
    assert float(_check([a, a, c])).hex() == "0x1.0020020000000p+0"


@pytest.mark.gpu
def test_views_numbers_and_broadcasting(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((17, 40, 300), generator=gen, device=cuda)
    for axis in range(3):
        _check([x.narrow(axis, 1, 9), 0.25, x.narrow(axis, 0, 9)])
        _check([0.1, x.narrow(axis, 2, 9), x.narrow(axis, 0, 9)])
    _check([x, torch.randn((40, 1), generator=gen, device=cuda), 0.3])
    _check([x.transpose(0, 2), x.transpose(0, 2), torch.tensor(1.5, device=cuda)])
    _check([x, torch.tensor(2.0), x])  # a 0-dim CPU tensor is a number
    _check([x.half(), x, x.half()])
    six = torch.randn((4,) * 6, generator=gen, device=cuda)[::2, ::2, ::2, ::2, ::2, ::2]
    assert len(_fp._merge_axes(six.shape, [six.stride()])[0]) == 6
    _check([six, six, six])  # more than four axes after merging: copied
    assert _fp.fma(x[:0], 1.0, x[:0]).shape == (0, 40, 300)


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices_and_integers(cuda):
    x = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        _fp.fma(x, torch.ones(4), 1.0)
    with pytest.raises(TypeError, match="floating-point"):
        _fp.fma(x, torch.ones(4, dtype=torch.int32, device=cuda), 1.0)


@pytest.mark.gpu
def test_kernel_launches_on_the_current_stream(cuda):
    x = torch.randn(1 << 20, device=cuda)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = _fp.fma(x, x, x)
    stream.synchronize()
    _same(got, _fp.fma_plain(x, x, x))
