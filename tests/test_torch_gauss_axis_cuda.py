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
lines than the grid holds, on ``chip_smoke.filter_frame`` frames; every tap
count with its own unrolled instance and the run-time loop's
(``chip_smoke.gauss_instance_weights``) through both wrappers and both
carries, along outer axes with inner extents of 1, 3, 4 and 129 and along
last axes of several lengths, tiles that touch an edge only and tiles with
an interior, a tensor off the 16-byte alignment, the centre tensor, the
edge tensor (reflected reads) and the flag table (``filters.flag_table``,
cached on the card); Markers' LoG program where its sunk axis-0 pass has
three taps, at last axes with and without a remainder of the vector loop.
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
@pytest.mark.parametrize("shape", [(12, 48, 48), (5, 7, 130), (40, 3), (2, 9, 4999)])
def test_edge_tensor(cuda, shape):
    """A tap whose index falls outside the axis reads ``edge`` (reflected):
    along every axis, with tiles that touch an edge and interior ones, and
    with the centre tensor and flags."""
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=5)).to(cuda)
    edge = torch.from_numpy(chip_smoke.filter_frame(shape, seed=6)).to(cuda)
    other = torch.from_numpy(chip_smoke.filter_frame(shape, seed=8)).to(cuda)
    for axis in range(len(shape)):
        for sigma, order in ((0.3, 2), (1.0, 0), (2.5, 2)):
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            _check(lambda t, *a: filters._correlate1d(t, *a, edge=edge),
                   lambda t, *a: filters._correlate1d_plain(t, *a, edge=edge.to(t.device)),
                   x, w, axis)
            flags = [o == 0 for o, _ in filters.nonzero_taps(w)]
            _check(lambda t, *a: filters._correlate1d(t, *a, centre=other, edge=edge),
                   lambda t, *a: filters._correlate1d_plain(t, *a, centre=other.to(t.device),
                                                            edge=edge.to(t.device)),
                   x, w, axis, flags)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5, 48, 48), (3, 24, 122), (3, 24, 130), (5, 64, 256)])
def test_markers_sunk_program(cuda, shape):
    """Markers' LoG at 5 px (sigmas 0.5 to 1.43 over a z ratio of 2.5): the
    second scale's sunk axis-0 order-2 pass of three taps takes the vector
    and scalar loops' passes and the edge tensor; card = CPU."""
    d = torch.from_numpy(np.minimum(np.abs(chip_smoke.filter_frame(shape, seed=2)) / 60, 10))
    for s in (0.5, 0.7333333333333334, 1.2):
        sigma = (s / 2.5, s, s)
        got = filters.log_program(d.to(cuda), sigma, sunk_centre=True, peak=True)
        want = filters.log_program(d, sigma, sunk_centre=True, peak=True)
        for g, w in zip(got, want):
            _same(g, w)


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
    with pytest.raises(ValueError):  # an edge tensor of another shape
        filters.GAUSS_AXIS_KERNEL(x, [(0, 1.0)], 0, edge=x[1:])
    with pytest.raises(ValueError):  # beyond the tiles' margin
        filters.GAUSS_AXIS_KERNEL(x, [(0, 1.0), (129, 0.5)], 0)


# (shape, axis): outer axes with inner extents 1, 3, 4 and 129 (the last
# two: 16-byte and 4-byte tiles with a partial column tile), axes of 40
# (every tile touches an edge) and 300 (interior tiles), last axes of 7, 200,
# 1,024 (one tile a line), 5,000 and 4,999 (interior tiles, 16 and 4 bytes)
INSTANCE_CASES = [((40, 1), 0), ((40, 3), 0), ((40, 4), 0), ((40, 129), 0), ((300, 12), 0),
                  ((2, 70, 8), 1), ((5, 7), 1), ((3, 200), 1), ((9, 1024), 1), ((3, 5000), 1),
                  ((3, 4999), 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", INSTANCE_CASES)
def test_every_instance(cuda, shape, axis):
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=11)).to(cuda)
    for w in chip_smoke.gauss_instance_weights():
        for carry in (torch.float32, torch.float16):
            def plain(v, ww, a, c=carry):
                return filters.correlate1d_traced_plain(v, ww, a).to(c).float()
            _check(lambda v, ww, a, c=carry: filters.correlate1d_traced(v, ww, a, c), plain, x, w,
                   axis)
        _check(filters._correlate1d, filters._correlate1d_plain, x, w, axis)


@pytest.mark.gpu
def test_instance_and_copy_width(cuda):
    """What a launch reports taking (``GAUSS_AXIS_KERNEL.last_used``): the
    unrolled instance of each listed count at -r..r and the run-time loop
    for other lists; 16-byte copies where the inner extent (or the line) is
    a multiple of 4 and the tensors lie on 16-byte boundaries, else 4."""
    kernel = filters.GAUSS_AXIS_KERNEL

    def used(shape, axis, taps, offset=0):
        buf = torch.zeros(int(np.prod(shape)) + offset, dtype=torch.float32, device=cuda)
        kernel(buf[offset:].view(shape), taps, axis)
        return kernel.last_used

    for count in filters.GAUSS_UNROLLED_COUNTS:
        taps = [(k - count // 2, 0.5) for k in range(count)]
        assert used((40, 4), 0, taps) == (count, 16)
        assert used((40, 4), 0, taps, offset=1) == (count, 4)
        assert used((40, 129), 0, taps) == (count, 4)
        assert used((3, 5000), 1, taps) == (count, 16)
        assert used((3, 5000), 1, taps, offset=1) == (count, 4)
        assert used((3, 4999), 1, taps) == (count, 4)
    assert used((40, 4), 0, [(k - 9, 0.5) for k in range(19)]) == (0, 16)
    assert used((40, 4), 0, [(-1, 0.5), (1, 0.5), (2, 0.5)]) == (0, 16)
    assert used((300, 4), 0, [(-65, 0.5), (0, 0.5), (65, 0.5)]) == (0, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", [((40, 36), 0), ((6, 44), 1)])
def test_off_alignment(cuda, shape, axis):
    """A contiguous view 4 bytes past a 16-byte boundary takes 4-byte copies."""
    frame = torch.from_numpy(chip_smoke.filter_frame(shape, seed=12))
    buf = torch.empty(frame.numel() + 1, dtype=torch.float32, device=cuda)
    x = buf[1:].view(shape)
    x.copy_(frame.to(cuda))
    assert x.data_ptr() % 16 == 4
    for w in chip_smoke.gauss_instance_weights()[:3]:
        _check(filters._correlate1d, filters._correlate1d_plain, x, w, axis)
        _check(filters.correlate1d_traced, filters.correlate1d_traced_plain, x, w, axis)


@pytest.mark.gpu
def test_flag_table_stays_on_the_card(cuda):
    """The LoG's flagged passes: the table is made once and then read from
    the cache, and equals the packed ``shared_products`` | tap flags."""
    x = torch.from_numpy(chip_smoke.filter_frame((5, 9, 40), seed=13)).to(cuda)
    w = filters.gaussian_kernel1d(1.5, 4.0, order=2)
    taps = filters.nonzero_taps(w)
    tap_flags = [o == 0 for o, _ in taps]
    first = filters.flag_table(5, taps, False, tap_flags, cuda)
    assert first.device.type == "cuda"
    assert filters.flag_table(5, taps, False, tap_flags, cuda) is first
    shared = filters.shared_products(5, taps, False)
    table = np.broadcast_to(np.asarray(tap_flags), (5, len(taps))) | (
        False if shared is None else shared)
    assert np.array_equal(first.cpu().numpy(), filters.pack_flags(table))
    _check(filters._correlate1d, filters._correlate1d_plain, x, w, 0, tap_flags)
