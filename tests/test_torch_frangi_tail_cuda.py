"""The hand-written CUDA Frangi tail against its plain versions.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_frangi_tail_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  On a CUDA
block ``frangi.hessian_frob`` and ``frangi.frangi_response`` launch
``kernels/csrc/frangi_tail.cu`` once each and equal
``hessian_frob_plain`` and ``frangi_response_plain`` bit for bit (the
Frobenius norm, the largest component, the vesselness in the carry type
and the mask) on the card and on CPU copies: 2D and 3D, the float32 and
float16 carries, a last axis of 128 (XLA's fusion rule), a core box,
``apply_mask`` false (that program's own components, and no pass 1) and
``frob_thresh_division`` 0, a dim frame whose
squares are subnormal, and extents of 1 to 3.  Pass 2 on Frobenius masks
of 0, 1, about 30 and 100 % of the voxels, clustered (a smoothed frame's
brightest) and scattered (random), on blocks whose axes are not multiples
of the kernel's tile (16 x 64 outputs a plane in 3D, 256 in 2D), with axes
shorter than 5 and a first axis shorter than the ring of six planes; both
passes on blocks with NaN and infinite voxels.  ``vesselness_frame`` on the
card equals the CPU's, which is the JAX package's
(``tests/test_torch_frangi_tail.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import frangi, hessian

PARAMS = {3: frangi.FrangiParams(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2),
                                 z_ratio=2.5),
          2: frangi.FrangiParams(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
SHAPES = [(12, 48, 48), (7, 33, 128), (2, 3, 5), (1, 9, 9), (64, 128), (48, 96), (3, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bool:
        assert torch.equal(got, want)
    else:
        assert chip_smoke.same_bits(got.float().numpy(), want.float().numpy()).all()


def _smoothed(shape, seed, scale=1.0):
    return torch.from_numpy(chip_smoke.filter_frame(shape, seed=seed, smooth=True)
                            * np.float32(scale))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1.0, 1e-19])
def test_hessian_frob(cuda, shape, scale):
    g = _smoothed(shape, seed=sum(shape), scale=scale)
    params = PARAMS[len(shape)]
    core = (lambda v: v.narrow(0, 1, v.shape[0] - 2)) if shape[0] > 2 else (lambda v: v)
    # the block's own shape, then a frame 128 wide of which it is a block
    for minor in (None, tuple(shape[:-1]) + (128,)):
        before = frangi.FRANGI_TAIL_KERNEL.launches
        h, frob, largest = frangi.hessian_frob(g.to(cuda), params.spacing, minor, core)
        torch.cuda.synchronize()
        assert h is None and frangi.FRANGI_TAIL_KERNEL.launches == before + 1
        for dev in (cuda, "cpu"):
            _, want_frob, want_largest = frangi.hessian_frob_plain(g.to(dev), params.spacing,
                                                                   minor, core)
            _same(frob, want_frob)
            _same(largest, want_largest)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("carry", [torch.float32, torch.float16])
def test_frangi_response(cuda, shape, carry):
    g = _smoothed(shape, seed=3 + len(shape))
    params = PARAMS[len(shape)]
    rng = np.random.default_rng(1)
    vessel = torch.from_numpy(rng.random(shape).astype(np.float32) * 0.01).to(carry)
    all_mask = torch.from_numpy(rng.random(shape) < 0.9)
    mask = torch.from_numpy(rng.random(shape) < 0.7)
    gamma_sq = torch.tensor(np.float32(2.0 * 3.0 ** 2))
    for m in (mask, None):
        v_k, a_k = vessel.clone().to(cuda), all_mask.clone().to(cuda)
        before = frangi.FRANGI_TAIL_KERNEL.launches
        frangi.frangi_response(g.to(cuda), None, params, None, None if m is None else m.to(cuda),
                               gamma_sq.to(cuda), v_k, a_k)
        torch.cuda.synchronize()
        assert frangi.FRANGI_TAIL_KERNEL.launches == before + 1
        for dev in (cuda, "cpu"):
            # no mask: the components of the program without the Frobenius mask
            h, _ = hessian.hessian_unnormalized(g.to(dev), params.spacing, masked=m is not None)
            v_p, a_p = frangi.frangi_response_plain(
                h, None if m is None else m.to(dev), gamma_sq.to(dev), params,
                vessel.to(dev), all_mask.to(dev))
            _same(v_k, v_p)
            _same(a_k, a_p)


# blocks whose axes are not multiples of the tile, an axis of 4, a first axis
# of 3 (shorter than the ring), a 3D main frame, and 2D
MASK_SHAPES = [(9, 37, 70), (5, 17, 131), (3, 40, 64), (20, 4, 300), (64, 256, 256),
               (48, 96), (1000, 7), (3, 1030)]


def _frob_mask(g, fraction, kind, seed):
    """About ``fraction`` of the voxels: the brightest of the smoothed block
    (tubes, clustered) or at random (scattered)."""
    if fraction in (0.0, 1.0):
        return torch.full(g.shape, fraction == 1.0)
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(seed).random(g.shape) < fraction)
    return g > torch.quantile(g.flatten()[:1 << 24].double(), 1 - fraction).float()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MASK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["tubes", "random"])
def test_frangi_response_masks(cuda, shape, kind):
    g = _smoothed(shape, seed=len(shape) + 5)
    params = PARAMS[len(shape)]
    rng = np.random.default_rng(2)
    gamma_sq = torch.tensor(np.float32(2.0 * 40.0 ** 2))
    all_mask = torch.from_numpy(rng.random(shape) < 0.9)
    for carry in (torch.float32, torch.float16):
        vessel = torch.from_numpy(rng.random(shape).astype(np.float32) * 0.01).to(carry)
        for fraction in (0.0, 0.01, 0.3, 1.0):
            mask = _frob_mask(g, fraction, kind, seed=int(fraction * 100))
            v_k, a_k = vessel.clone().to(cuda), all_mask.clone().to(cuda)
            frangi.frangi_response(g.to(cuda), None, params, None, mask.to(cuda),
                                   gamma_sq.to(cuda), v_k, a_k)
            h, _ = hessian.hessian_unnormalized(g.to(cuda), params.spacing)
            v_p, a_p = frangi.frangi_response_plain(h, mask.to(cuda), gamma_sq.to(cuda), params,
                                                    vessel.to(cuda), all_mask.to(cuda))
            _same(v_k, v_p)
            _same(a_k, a_p)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(12, 48, 48), (5, 17, 131), (64, 128)])
def test_nan_and_infinite_voxels(cuda, shape):
    g = _smoothed(shape, seed=4)
    flat = g.view(-1)
    idx = torch.from_numpy(np.random.default_rng(3).choice(flat.numel(), 60, replace=False))
    flat[idx[0::3]] = float("nan")
    flat[idx[1::3]] = float("inf")
    flat[idx[2::3]] = -float("inf")
    params = PARAMS[len(shape)]
    core = lambda v: v  # noqa: E731
    _, frob, largest = frangi.hessian_frob(g.to(cuda), params.spacing, None, core)
    _, want_frob, want_largest = frangi.hessian_frob_plain(g, params.spacing, None, core)
    _same(frob, want_frob)
    _same(largest, want_largest)
    mask = torch.from_numpy(np.random.default_rng(5).random(shape) < 0.5)
    gamma_sq = torch.tensor(np.float32(2.0 * 3.0 ** 2))
    for carry in (torch.float32, torch.float16):
        vessel = torch.zeros(shape, dtype=carry)
        all_mask = torch.ones(shape, dtype=torch.bool)
        v_k, a_k = vessel.clone().to(cuda), all_mask.clone().to(cuda)
        frangi.frangi_response(g.to(cuda), None, params, None, mask.to(cuda), gamma_sq.to(cuda),
                               v_k, a_k)
        h, _ = hessian.hessian_unnormalized(g, params.spacing)
        v_p, a_p = frangi.frangi_response_plain(h, mask, gamma_sq, params, vessel, all_mask)
        _same(v_k, v_p)
        _same(a_k, a_p)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(12, 48, 48), (7, 33, 128), (64, 128), (40, 128)])
@pytest.mark.parametrize("variant", ["float32", "float16", "no_mask", "division_0", "dim"])
def test_vesselness_frame_card_equals_cpu(cuda, shape, variant):
    frame = torch.from_numpy(chip_smoke.filter_frame(shape, seed=11))
    params = PARAMS[len(shape)]
    if variant == "float16":
        params = dataclasses.replace(params, carry_dtype="float16")
    if variant == "division_0":
        params = dataclasses.replace(params, frob_thresh_division=0.0)
    if variant == "dim":
        frame = frame * np.float32(1e-19)
    apply_mask = variant != "no_mask"
    before = frangi.FRANGI_TAIL_KERNEL.launches
    v_k, m_k = frangi.vesselness_frame(frame.to(cuda), params, apply_mask)
    # without the mask a scale needs no Frobenius norm, so no pass 1
    passes = 2 if apply_mask else 1
    assert frangi.FRANGI_TAIL_KERNEL.launches == before + passes * len(params.sigmas)
    v_p, m_p = frangi.vesselness_frame(frame, params, apply_mask)
    _same(v_k, v_p)
    _same(m_k, m_p)
    assert variant == "dim" or float(v_p.max()) > 0
