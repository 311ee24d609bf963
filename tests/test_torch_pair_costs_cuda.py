"""The hand-written CUDA pair costs against their plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_pair_costs_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``matching.pair_costs`` on CUDA tensors launches ``kernels/csrc/pair_costs.cu``
once (a memset and one CUDA kernel) with no host read, and equals
``pair_costs_plain`` on the card bit for bit (the minima with their NaN
bits and zero signs, the indices exactly) and on CPU copies: the main
paths' shapes and the hard cases of ``chip_smoke.PAIR_COST_CASES``, 1-D and
2-D coordinates, no features, one marker a side, features that start off
16 bytes; ``to_host`` copies the four results in one read; arguments it
does not take raise.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import matching


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(dev, name=None, arrays=None, seed=0):
    if name is not None:
        cp, cq, fp, fq, max_d, mean, std, n_stats = chip_smoke.pair_cost_inputs(name, seed)
    else:
        cp, cq, fp, fq = arrays
        max_d, n_stats = 1.0, max(fp.shape[1] // 2, 1)
        mean, std = chip_smoke.pair_moments(cp, cq, fp, fq, max_d)
    return (*(torch.from_numpy(a).to(dev) for a in (cp, cq, fp, fq)), max_d,
            torch.from_numpy(mean), torch.from_numpy(std), n_stats)


@pytest.mark.gpu
@pytest.mark.parametrize("name", chip_smoke.PAIR_COST_CASES)
def test_cases(cuda, name):
    args = _args(cuda, name)
    chip_smoke.check_pair_costs(name, args, against_cpu=True)
    _, reads = chip_smoke.host_reads(lambda: matching.pair_costs(*args))
    assert reads == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(70, 50, 1, 4), (70, 50, 3, 0), (1, 1, 3, 22),
                                   (33, 65, 2, 10), (1, 300, 3, 22), (300, 1, 2, 10)])
def test_small_shapes(cuda, shape):
    n_post, n_pre, ndim, n_feat = shape
    arrays = chip_smoke.pair_tile(n_post, n_pre, ndim, n_feat, seed=5)
    chip_smoke.check_pair_costs(str(shape), _args(cuda, arrays=arrays), against_cpu=True)


@pytest.mark.gpu
def test_features_off_16_bytes(cuda):
    cp, cq, fp, fq, *rest = _args(cuda, "3D 338x332")
    fq = torch.cat([fq.reshape(-1)[:1], fq.reshape(-1)])[1:].view(fq.shape)
    assert fq.data_ptr() % 16
    chip_smoke.check_pair_costs("features off 16 bytes", (cp, cq, fp, fq, *rest))


@pytest.mark.gpu
def test_to_host_is_one_read(cuda):
    args = _args(cuda, "2D 2196x2195")
    got = matching.pair_costs(*args)
    host, reads = chip_smoke.host_reads(lambda: matching.to_host(got))
    assert reads == 1
    for h, g in zip(host, got):
        assert h.device.type == "cpu" and h.dtype == g.dtype
        np.testing.assert_array_equal(h.numpy(), g.cpu().numpy())


@pytest.mark.gpu
def test_refuses(cuda):
    cp, cq, fp, fq, max_d, mean, std, n_stats = _args(cuda, "3D 338x332")
    with pytest.raises(TypeError):  # the moments are launch arguments: on the host
        matching.pair_costs(cp, cq, fp, fq, max_d, mean.to(cuda), std, n_stats)
    with pytest.raises(ValueError):
        matching.pair_costs(cp, cq, fp, fq, max_d, mean[:-1], std[:-1], n_stats)
    with pytest.raises(ValueError):
        matching.pair_costs(cp[:0], cq, fp[:0], fq, max_d, mean, std, n_stats)
    with pytest.raises(TypeError):
        matching.pair_costs(cp.double(), cq, fp, fq, max_d, mean, std, n_stats)
    wide = torch.zeros(cp.shape[0], 64, device=cuda)
    with pytest.raises(ValueError):  # 63 features at most
        matching.pair_costs(cp, cq, wide, wide[:cq.shape[0]], max_d, torch.zeros(65),
                            torch.ones(65), 4)
