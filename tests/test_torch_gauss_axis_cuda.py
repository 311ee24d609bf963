"""The hand-written CUDA 1-D correlation against its plain versions.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gauss_axis_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``filters.correlate1d_traced`` and ``filters._correlate1d`` on a CUDA tensor
launch ``kernels/csrc/gauss_axis.cu`` once and equal
``correlate1d_traced_plain`` and ``_correlate1d_plain`` bit for bit on the
card and on CPU copies: the cascade's per-scale taps (zeros kept) along
every axis with the float32 and float16 carries, the LoG's taps (zeros
skipped), one tap, extents shorter than the taps' radius, a last axis of 128 and more
lines than the grid holds, on ``chip_smoke.filter_frame`` frames.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import filters, frangi

SHAPES = [(12, 48, 48), (7, 33, 128), (3, 5, 9), (64, 128), (1, 200)]
PARAMS = {3: frangi.FrangiParams(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2),
                                 z_ratio=2.5),
          2: frangi.FrangiParams(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert chip_smoke.same_bits(got.cpu().numpy(), want.cpu().numpy()).all()


def _check(fn, plain, x, *args):
    before = filters.GAUSS_AXIS_KERNEL.launches
    got = fn(x, *args)
    torch.cuda.synchronize()
    assert filters.GAUSS_AXIS_KERNEL.launches == before + 1 and got.device.type == "cuda"
    _same(got, plain(x, *args))
    _same(got, plain(x.cpu(), *args))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("carry", [torch.float32, torch.float16])
def test_cascade_taps(cuda, shape, carry):
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=len(shape))).to(cuda)
    for axis in range(x.ndim):
        for taps in frangi._delta_kernels(PARAMS[x.ndim], x.ndim)[axis]:
            def plain(v, w, a, c=carry):
                out = filters.correlate1d_traced_plain(v, w, a)
                return out.to(c).float()
            _check(lambda v, w, a: filters.correlate1d_traced(v, w, a, carry), plain, x, taps,
                   axis)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_log_taps(cuda, shape):
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=7)).to(cuda)
    for axis in range(x.ndim):
        for sigma, order in ((1.0, 0), (1.0, 2), (2.5, 2), (0.3, 0)):
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            _check(filters._correlate1d, filters._correlate1d_plain, x, w, axis)
        w = np.zeros(9)
        w[2] = 0.75  # one nonzero tap
        _check(filters._correlate1d, filters._correlate1d_plain, x, w, axis)
        _check(filters._correlate1d, filters._correlate1d_plain, x, np.array([0.3]), axis)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(70000, 4, 2), (2, 3, 1)])
def test_shapes_off_the_tiles(cuda, shape):
    """More than 65,535 lines before the axis (more than the grid holds:
    its blocks step over them), and axes of one voxel."""
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=9)).to(cuda)
    for axis in range(x.ndim):
        for taps in frangi._delta_kernels(PARAMS[3], 3)[axis]:
            _check(filters.correlate1d_traced, filters.correlate1d_traced_plain, x, taps, axis)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(12, 48, 48), (3, 5, 9), (1, 200)])
def test_centre_and_tap_flags(cuda, shape):
    """The LoG program's passes: a tap flagged at every position and the
    centre read from another tensor."""
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=7)).to(cuda)
    other = torch.from_numpy(chip_smoke.filter_frame(shape, seed=8)).to(cuda)
    for axis in range(len(shape)):
        for sigma, order in ((1.0, 0), (1.0, 2), (2.5, 2)):
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            flags = [o == 0 for o, _ in filters.nonzero_taps(w)]
            _check(lambda t, *a: filters._correlate1d(t, *a, centre=other),
                   lambda t, *a: filters._correlate1d_plain(t, *a, centre=other.to(t.device)),
                   x, w, axis, flags)


@pytest.mark.gpu
def test_gaussian_laplace_and_errors(cuda):
    x = torch.from_numpy(chip_smoke.filter_frame((12, 48, 48), seed=3)).to(cuda)
    before = filters.GAUSS_AXIS_KERNEL.launches
    got = filters.gaussian_laplace(x, (0.4, 1.0, 1.0))
    # XLA's program: the axis-0 passes (2) and the last fusion's (2), then
    # a term's axis-1 pass, its last-fusion pass and its axis-2 pass (9)
    assert filters.GAUSS_AXIS_KERNEL.launches == before + 13
    _same(got, filters.gaussian_laplace(x.cpu(), (0.4, 1.0, 1.0)))
    for sunk in (False, True):
        _same(filters.log_program(x, (0.5, 1.25, 1.25), sunk_centre=sunk),
              filters.log_program(x.cpu(), (0.5, 1.25, 1.25), sunk_centre=sunk))
    with pytest.raises(TypeError):
        filters.GAUSS_AXIS_KERNEL(x.double(), [(0, 1.0)], 0)
    with pytest.raises(ValueError):
        filters.GAUSS_AXIS_KERNEL(x, [(0, 1.0)] * 257, 0)
    with pytest.raises(ValueError):  # beyond the tiles' margin
        filters.GAUSS_AXIS_KERNEL(x, [(0, 1.0), (129, 0.5)], 0)
