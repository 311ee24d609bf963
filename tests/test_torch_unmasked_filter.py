"""The Filter's program without the Frobenius mask against the JAX package.

``vesselness_frame(..., apply_mask=False)`` is a second XLA program: with
no Frobenius norm reading the Hessian components, XLA fuses each diagonal
component's inner gradient whole (every axis, but a minor axis of more than
128), so their differences round as fused multiply-adds where the masked
program's do not (``hessian.fused_axes``,
``scripts/xla_unmasked_probe.py``).  The port's vesselness without the mask
equals the reference's jitted program bit for bit on
``chip_smoke.filter_frame`` frames, 3D and 2D, at last axes below, at and
above 128, with both carries; and ``Filter.run(mask=False)``, its only
caller, writes the reference's ``im_preprocessed`` exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_port_data as D
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.stages.filtering import Filter
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

PARAMS = {3: dict(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2), z_ratio=2.5),
          2: dict(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
SHAPES = [(12, 48, 48), (7, 33, 128), (3, 16, 130), (64, 128), (40, 129)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("carry", ["float32", "float16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vesselness_without_the_mask(shape, carry):
    frame = chip_smoke.filter_frame(shape, seed=len(shape))
    kw = dict(PARAMS[len(shape)], carry_dtype=carry)
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(
        x, j_frangi.FrangiParams(**kw), apply_mask=False))(jnp.asarray(frame))
    v_p, m_p = frangi.vesselness_frame(torch.from_numpy(frame), frangi.FrangiParams(**kw),
                                       apply_mask=False)
    assert bool(m_p.all()) and np.asarray(m_j).all()
    assert float(v_p.max()) > 0
    np.testing.assert_array_equal(_bits(v_p.numpy()), _bits(v_j))


@pytest.mark.parametrize("series", ["3D", "2D"])
def test_filter_stage_without_the_mask(tmp_path, series):
    data = D.tube_series() if series == "3D" else D.tube_series_2d()
    dim_res = D.DIM_RES if series == "3D" else D.DIM_RES_2D
    infos = []
    for side, stage in (("jax", JFilter), ("port", Filter)):
        im_info = D.open_im_info(D.write_input(tmp_path / side, data, dim_res=dim_res,
                                               axes="TZYX" if series == "3D" else "TYX"))
        stage(im_info, device="cpu").run(mask=False)
        infos.append(im_info)
    D.assert_artifact_equal(*infos, "im_preprocessed", "exact")
