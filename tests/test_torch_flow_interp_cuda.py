"""The hand-written CUDA flow interpolation kernel against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_flow_interp_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Inputs are
``chip_smoke.interp_inputs`` (phase 17's).  The kernel equals the plain
body on the card and on CPU copies bit for bit (NaN where NaN); a row may
differ only where the plain body's ``_fp.fma`` rounds twice, and then it
must equal ``chip_smoke.interp_model`` with exact fused multiply-adds
(``chip_smoke.check_interp``).
"""
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.stages import flow_interpolation as fi


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(inputs, dev):
    return tuple(torch.from_numpy(a).to(dev) for a in inputs[:4]) + (inputs[4],)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n_m", [1, 20, 33, 700, 1500, 40000])
def test_kernel_equals_plain_body(cuda, n_m, d):
    args = _args(chip_smoke.interp_inputs(2048, n_m, d, seed=n_m), cuda)
    before = fi.FLOW_INTERP_KERNEL.launches
    fi._interp_all_kernel(*args)
    torch.cuda.synchronize()
    assert fi.FLOW_INTERP_KERNEL.launches == before + 1
    differ, _ = chip_smoke.check_interp(f"M={n_m} d={d}", args, against_cpu=n_m <= 1500)
    assert differ <= chip_smoke.MAX_DOUBLE_ROUNDED_ROWS


@pytest.mark.gpu
def test_many_queries_and_tiles(cuda):
    """More queries than one block's and rows than one shared tile, with a
    larger radius so that many rows lie inside."""
    q, f, v, c, _ = chip_smoke.interp_inputs(20000, 5000, 3, seed=9)
    chip_smoke.check_interp("20000 x 5000, radius 2", _args((q, f, v, c, 2.0), cuda))


@pytest.mark.gpu
def test_kernel_output_and_errors(cuda):
    q, f, v, c, r = _args(chip_smoke.interp_inputs(64, 10, 2), cuda)
    out = fi._interp_all_kernel(q, f, v, c, r)
    assert out.shape == q.shape and out.dtype == torch.float32 and out.device == q.device
    assert fi._interp_all_kernel(q[:0], f, v, c, r).shape == (0, 2)
    assert torch.isnan(fi._interp_all_kernel(q, f[:0], v[:0], c[:0], r)).all()
    with pytest.raises(TypeError):
        fi._interp_all_kernel(q.double(), f, v, c, r)
    with pytest.raises(ValueError):
        fi._interp_all_kernel(q, f, v[:, :1], c, r)
