"""The Filter's masked program at the first and last planes of axis 0.

XLA fuses each diagonal Hessian component's edge values into the outer
gradient, ``hxx`` too, so the edge differences along axis 0 take their
left product into a fused multiply-add as those of ``hyy`` and ``hzz`` do
(``hessian._second_gradient``).  Where the spacing along axis 0 makes the
product exact (0.5 µm in the 3D main path) nothing shows; at 0.1 µm (2D)
or 0.3 µm (3D) single voxels on the first or last row differed from the
reference, such as one of ``chip_smoke.filter_frame``'s 64x128 frame.  The
port's vesselness equals the reference's jitted program bit for bit there,
2D and 3D, both carries; so does the Filter stage's ``im_preprocessed`` on
a 2D series of ``filter_frame`` frames.
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

PARAMS = {3: dict(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.3, 0.2, 0.2), z_ratio=2.5),
          2: dict(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
# (shape, seed of filter_frame): each differed from the reference on a row
# of axis 0's edges before the edge rule
FRAMES = [((64, 128), 11), ((48, 56), 2), ((8, 40), 7), ((256, 256), 5), ((12, 48, 48), 1),
          ((12, 48, 128), 2)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("carry", ["float32", "float16"])
@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: "x".join(map(str, f[0])) + f"-{f[1]}")
def test_vesselness_at_axis_0_edges(frame, carry):
    shape, seed = frame
    x = chip_smoke.filter_frame(shape, seed=seed)
    kw = dict(PARAMS[len(shape)], carry_dtype=carry)
    v_j, m_j = jax.jit(lambda v: j_frangi.vesselness_frame(v, j_frangi.FrangiParams(**kw)))(
        jnp.asarray(x))
    v_p, m_p = frangi.vesselness_frame(torch.from_numpy(x), frangi.FrangiParams(**kw))
    assert float(v_p.max()) > 0
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(_bits(v_p.numpy()), _bits(v_j))


def test_filter_stage_on_filter_frames(tmp_path):
    frames = np.stack([chip_smoke.filter_frame((64, 128), seed=s) for s in (11, 2)])
    data = np.clip(frames, 0, 65535).astype(np.uint16)
    infos = []
    for side, stage in (("jax", JFilter), ("port", Filter)):
        im_info = D.open_im_info(D.write_input(tmp_path / side, data, dim_res=D.DIM_RES_2D,
                                               axes="TYX"))
        stage(im_info, device="cpu").run()
        infos.append(im_info)
    D.assert_artifact_equal(*infos, "im_preprocessed", "exact")
