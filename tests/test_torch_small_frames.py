"""The Filter's program on small frames against the JAX package.

With the Frobenius mask, XLA fuses a diagonal Hessian component's whole
inner gradient only along a last axis of exactly 128 -- except in a small
frame, no axis of which is longer than 32: there it fuses every axis's, as
the program without the mask does (``hessian._fuses_inner_gradient``;
``scripts/xla_unmasked_probe.py 9x20x30 9x20x33`` prints both).  The
port's vesselness equals the reference's jitted program bit for bit on
``chip_smoke.filter_frame`` frames below, at and just above that size, in
3D and 2D, with both carries; a block of a frame (the mesh's shards) takes
the frame's rule.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu_torch.kernels import frangi, hessian
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

PARAMS = {3: dict(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2), z_ratio=2.5),
          2: dict(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
# at most 32 along every axis (the rule's), and one axis past it
SHAPES = [(9, 20, 30), (5, 16, 16), (30, 20, 30), (2, 20, 30), (16, 32, 32),
          (9, 20, 33), (9, 33, 30), (33, 20, 20), (20, 30), (32, 32), (33, 20)]


@pytest.mark.parametrize("carry", ["float32", "float16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vesselness_of_small_frames(shape, carry):
    frame = chip_smoke.filter_frame(shape, seed=len(shape))
    kw = dict(PARAMS[len(shape)], carry_dtype=carry)
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_frangi.FrangiParams(**kw)))(
        jnp.asarray(frame))
    v_p, m_p = frangi.vesselness_frame(torch.from_numpy(frame), frangi.FrangiParams(**kw))
    assert float(v_p.max()) > 0
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(v_p.numpy().view(np.int32),
                                  np.asarray(v_j, np.float32).view(np.int32))


@pytest.mark.parametrize("shape,fused", [
    ((9, 20, 30), [True] * 3), ((32, 32, 32), [True] * 3), ((9, 20, 33), [False] * 3),
    ((33, 32, 32), [False] * 3), ((12, 48, 128), [False, False, True]),
    ((20, 30), [True] * 2), ((64, 128), [False, True])])
def test_the_rule(shape, fused):
    """``fused_axes`` with the mask: every axis in a small frame, else only
    a last axis of 128; a block of the frame takes the frame's shape."""
    assert hessian.fused_axes(torch.zeros(shape)) == fused
    block = torch.zeros(tuple(max(2, n // 2) for n in shape))
    assert hessian.fused_axes(block, frame_shape=shape) == fused
