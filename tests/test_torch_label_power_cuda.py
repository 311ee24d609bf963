"""Label's threshold power on the card against the CPU, bit for bit.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_label_power_cuda.py

``torch.pow`` on a CUDA tensor is CUDA's ``powf``, not glibc's, so the
port computes ``10 ** t`` with ``_fp.pow`` (glibc's ``powf`` in float64
torch, whose IEEE operations the card rounds as the CPU does); the CPU's
result is the JAX package's (``tests/test_torch_label_power.py``).
"""
import numpy as np
import pytest
import torch

from nellie_tpu_torch.kernels import _fp
from nellie_tpu_torch.stages import labelling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def exponents(n=200_000, seed=0):
    t = np.random.default_rng(seed).uniform(-6.0, 6.0, n).astype(np.float32)
    t[:13] = np.arange(-6, 7)
    return torch.from_numpy(t)


def same_bits(a, b):
    return np.array_equal(a.cpu().numpy().view(np.int32), b.cpu().numpy().view(np.int32))


@pytest.mark.gpu
def test_power_of_ten_card_equals_cpu(cuda):
    t = exponents()
    ten = torch.tensor(10.0)
    got = _fp.pow(ten.to(cuda), t.to(cuda))
    assert got.device.type == "cuda"
    assert same_bits(got, _fp.pow(ten, t))
    # the fault this repairs: CUDA's powf is not glibc's
    cuda_pow = torch.pow(ten.to(cuda), t.to(cuda))
    print(f"torch.pow on the card differs from glibc's powf on "
          f"{int((cuda_pow.cpu() != _fp.pow(ten, t)).sum())} of {t.numel()} exponents")


@pytest.mark.gpu
def test_power_of_ten_0dim_card_equals_cpu(cuda):
    ten = torch.tensor(10.0)
    for v in exponents(500, seed=1):
        assert same_bits(_fp.pow(ten.to(cuda), v.to(cuda)), _fp.pow(ten, v))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frangi_threshold_card_equals_cpu(cuda, seed):
    rng = np.random.default_rng(seed)
    flat = np.where(rng.random(40_000) < 0.3, rng.lognormal(-4.0, 1.5, 40_000), 0.0)
    flat = torch.from_numpy(flat.astype(np.float32))
    got, ok = labelling._frangi_threshold_kernel(flat.to(cuda), None, 0.0, 256, 1)
    want, want_ok = labelling._frangi_threshold_kernel(flat, None, 0.0, 256, 1)
    assert ok == want_ok and same_bits(got, want)
