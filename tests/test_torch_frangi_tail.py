"""The per-scale Frangi tail: the port's plain versions against the JAX
package's, bit for bit on the CPU.

``frangi.hessian_frob_plain`` and ``frangi.frangi_response_plain`` are what
``csrc/frangi_tail.cu`` computes on the card (held to them there by
``tests/test_torch_frangi_tail_cuda.py``); here they, and the whole
cascade, are held to ``nellie_tpu/kernels/hessian.py::hessian_components``,
``eigen.eigvalsh3`` / ``eigvalsh2`` and ``frangi.vesselness_frame`` under
``jax.jit``: 2D and 3D, the float32 and float16 carries, a last axis of
exactly 128 (where XLA fuses the inner gradient), ``frob_thresh_division``
0, and a frame split into mesh blocks whose largest component is taken
over each block's core box; ``apply_mask`` false is held to the masked
cascade.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_port_data as D  # noqa: F401 — puts the repo on the path
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import eigen as j_eigen
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.kernels import hessian as j_hessian
from nellie_tpu_torch.kernels import eigen, frangi, hessian
from nellie_tpu_torch.mesh import sharded

PARAMS = {3: dict(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2), z_ratio=2.5),
          2: dict(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
HESSIAN_SHAPES = [(12, 48, 48), (7, 33, 128), (64, 128), (48, 96)]
PASS_1_SHAPES = [(12, 48, 48), (7, 33, 128), (16, 20, 128)]
VARIANTS = {"float32": {}, "float16": dict(carry_dtype="float16"),
            "division_0": dict(frob_thresh_division=0.0)}


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
        return
    differ = (got.view(np.int32) != want.view(np.int32)) & ~(np.isnan(got) & np.isnan(want))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


@pytest.fixture(scope="module", params=HESSIAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def smoothed(request):
    return chip_smoke.filter_frame(request.param, seed=sum(request.param), smooth=True)


@pytest.mark.parametrize("shape", PASS_1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pass_1_bitwise(shape):
    """The 3D components and the normalised Frobenius norm (the largest
    component over the whole block) against ``hessian_components`` jitted
    alone, which rounds the 3D Hessian as the cascade's program does.  (In
    2D that standalone program rounds some voxels differently; the 2D
    pass 1 is held through the cascade below.)"""
    smoothed = chip_smoke.filter_frame(shape, seed=sum(shape), smooth=True)
    spacing = PARAMS[3]["spacing"]
    h_j, frob_j = jax.jit(lambda x: j_hessian.hessian_components(x, spacing))(smoothed)
    h, frob, largest = frangi.hessian_frob_plain(torch.from_numpy(smoothed), spacing, None,
                                                 lambda v: v)
    assert sorted(h) == sorted(h_j)
    for name in h:
        assert_bitwise(h[name].numpy(), h_j[name])
    assert_bitwise((frob / hessian.nonzero_or_one(largest)).numpy(), frob_j)


def test_eigenvalues_bitwise(smoothed):
    spacing = PARAMS[smoothed.ndim]["spacing"]
    h_j, _ = jax.jit(lambda x: j_hessian.hessian_components(x, spacing))(smoothed)
    names = ("hxx", "hxy", "hxz", "hyy", "hyz", "hzz") if smoothed.ndim == 3 else \
        ("hxx", "hxy", "hyy")
    args = [np.array(h_j[n]) for n in names]
    fn_j, fn = (j_eigen.eigvalsh3, eigen.eigvalsh3) if smoothed.ndim == 3 else \
        (j_eigen.eigvalsh2, eigen.eigvalsh2)
    want = jax.jit(fn_j)(*args)
    got = fn(*[torch.from_numpy(a) for a in args])
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w)


def cascade_frame(shape):
    """3D: ``chip_smoke.filter_frame``; 2D: the repo's tube movie's first
    frame at that shape (on ``filter_frame``'s 2D frames of width 128 the
    cascade rounds one voxel differently from XLA's; ROADMAP Queue 3)."""
    if len(shape) == 3:
        return chip_smoke.filter_frame(shape, seed=11)
    return D.tube_series_2d((1,) + shape)[0].astype(np.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shape", [(12, 48, 48), (7, 33, 128), (64, 96), (64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_vesselness_bitwise(shape, variant):
    """The cascade, its two passes a scale, against ``vesselness_frame``
    (``apply_mask=False``, another program: ``tests/test_torch_unmasked_filter.py``)."""
    frame = cascade_frame(shape)
    kw = dict(PARAMS[len(shape)], **VARIANTS[variant])
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_frangi.FrangiParams(**kw)))(frame)
    v_p, m_p = frangi.vesselness_frame(torch.from_numpy(frame), frangi.FrangiParams(**kw))
    assert float(v_p.max()) > 0
    assert_bitwise(v_p.numpy(), v_j)
    assert_bitwise(m_p.numpy(), np.asarray(m_j))


def test_vesselness_without_the_mask():
    """``apply_mask=False``: the mask is all true, more voxels respond, and
    the vesselness is the reference's program without the mask bit for
    bit.  That program rounds the diagonal components otherwise
    (``hessian.fused_axes``), so inside the mask its response
    may fall an ulp below the masked one's, in the reference's too."""
    frame = cascade_frame((12, 48, 48))
    params = frangi.FrangiParams(**PARAMS[3])
    v, m = frangi.vesselness_frame(torch.from_numpy(frame), params, apply_mask=False)
    v_masked, m_masked = frangi.vesselness_frame(torch.from_numpy(frame), params)
    assert bool(m.all()) and not bool(m_masked.all())
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(
        x, j_frangi.FrangiParams(**PARAMS[3]), apply_mask=False))(frame)
    assert_bitwise(v.numpy(), v_j)
    assert_bitwise(m.numpy(), np.asarray(m_j))
    assert float((v > 0).sum()) > float((v_masked > 0).sum())


@pytest.mark.parametrize("shape", [(12, 48, 48), (64, 96)], ids=lambda s: "x".join(map(str, s)))
def test_mesh_blocks_with_core_boxes(shape):
    """The frame split into two blocks with halos: every block's largest
    component is taken over its core box (``tail_geometry`` reads that box
    off the shard statistics' crop), and the blocks' vesselness is the
    whole frame's, the JAX package's bit for bit."""
    frame = cascade_frame(shape)
    kw = PARAMS[len(shape)]
    plan = sharded.plan_frame([torch.device("cpu")] * 2, shape)
    assert plan.axis == 0
    ext = sharded.extend(sharded.scatter(frame, plan), plan,
                         sharded.filter_halo(frangi.FrangiParams(**kw), plan, False))
    stats = sharded.ShardStats(plan, [lo for _, lo in ext])
    for k, (block, lo) in enumerate(ext):
        geo = frangi.tail_geometry(block, kw["spacing"], stats.frame_shape,
                                   stats.core(k, block))
        a, b = plan.bounds[k]
        assert (geo.core_lo[0], geo.core_hi[0]) == (lo, lo + b - a)
        assert list(geo.core_lo[1:len(shape)]) == [0] * (len(shape) - 1)
        assert list(geo.core_hi[1:len(shape)]) == list(shape[1:])
        assert list(geo.fuse[:len(shape)]) == [0] * (len(shape) - 1) + [int(shape[-1] == 128)]
    vessel, _ = sharded.vesselness_shards(sharded.scatter(frame, plan), plan,
                                          frangi.FrangiParams(**kw))
    v_j, _ = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_frangi.FrangiParams(**kw)))(frame)
    assert_bitwise(sharded.gather(vessel, plan).numpy(), v_j)


def test_geometry_constants_and_errors():
    g = torch.zeros(4, 5, 128)
    geo = frangi.tail_geometry(g, (0.5, 0.2, 0.3), None, g)
    assert [geo.n[a] for a in range(3)] == [4, 5, 128] and list(geo.fuse) == [0, 0, 1]
    assert geo.half[2] == np.float32(0.5 / 0.3) and geo.inv[1] == np.float32(1 / 0.2)
    geo = frangi.tail_geometry(g[..., :100].contiguous(), (0.5, 0.2, 0.3), (4, 5, 128),
                               g[..., :100].contiguous())
    assert list(geo.fuse) == [0, 0, 1]  # the frame's shape decides, not the block's
    geo = frangi.tail_geometry(g[:, :, :20].contiguous(), (0.5, 0.2, 0.3), (4, 5, 20),
                               g[:, :, :20].contiguous())
    assert list(geo.fuse) == [1, 1, 1]  # a small frame: every axis
    geo = frangi.tail_geometry(g, (0.5, 0.2, 0.3), (4, 5, 129), g, masked=False)
    assert list(geo.fuse) == [1, 1, 0]  # without the mask: every axis but a minor one over 128
    assert frangi._core_box(g, g[1:3, 2:4, 5:9]) == ([1, 2, 5], [3, 4, 9])
    with pytest.raises(ValueError):
        frangi._core_box(g, g.transpose(0, 1))
    with pytest.raises(ValueError):
        frangi.hessian_frob(g.to("meta"), (1.0, 1.0, 1.0), None, lambda v: v)


def test_plain_passes_compose_the_cascade():
    """One scale by the two plain passes equals the old single loop body
    of eigenvalues and response on the same components."""
    params = frangi.FrangiParams(**PARAMS[3])
    g = torch.from_numpy(chip_smoke.filter_frame((12, 48, 48), seed=2, smooth=True))
    h, frob, largest = frangi.hessian_frob_plain(g, params.spacing, None, lambda v: v)
    mask = frob / hessian.nonzero_or_one(largest) > 0.05
    gamma_sq = torch.tensor(np.float32(2.0 * 40.0 ** 2))
    vessel = torch.zeros(g.shape, dtype=torch.float16)
    all_mask = torch.ones(g.shape, dtype=torch.bool)
    v, a = frangi.frangi_response(g, None, params, None, mask, gamma_sq, vessel, all_mask)
    eigs = eigen.eigvalsh3(h["hxx"], h["hxy"], h["hxz"], h["hyy"], h["hyz"], h["hzz"])
    want = torch.where(mask, frangi._frangi_response(eigs, gamma_sq, params), 0.0)
    assert torch.equal(v, want.half()) and torch.equal(a, mask) and float(v.max()) > 0
    v2, _ = frangi.frangi_response(g, h, dataclasses.replace(params), None, mask, gamma_sq,
                                   vessel, all_mask)
    assert torch.equal(v, v2)
