"""The float16 Frangi carry of the PyTorch port against the JAX package.

``carry_dtype="float16"`` (config field ``preprocessing_carry_dtype``)
rounds the frame divided by its largest |value|, every smoothing pass and
the vesselness accumulator to float16, where the reference's optimised HLO
converts them; the arithmetic stays float32.  On the tube series of
``tests/torch_port_data.py``, 3D and 2D, whole frames and the low-memory
Filter's windows, the port is held to the JAX float16 path:

* the aim, bitwise ``im_preprocessed``, holds on every input here (the
  bar, 1e-4 of the frame max, is checked as well);
* ``im_instance_label`` is exact.

A user-set ``frob_thresh`` is not rescaled by the pre-normalisation, as in
the reference: the Frobenius norm is divided by the largest |Hessian
component|, so it does not change with the frame's scale, and the float16
run keeps the float32 run's mask at the tolerances of
``tests/test_frangi_f16.py``; a threshold divided by the scale would not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu_torch.config import SettingsConfig
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.pipeline.run import run
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.labelling import Label
from test_frangi_f16 import SIGMAS, SPACING, _tube_frame

CASES = {
    "3d": (D.tube_series, None, "TZYX", {}),
    "3d_windows": (D.tube_series, None, "TZYX",
                   dict(low_memory=True, max_chunk_voxels=12 * 24 * 24)),
    "2d": (D.tube_series_2d, D.DIM_RES_2D, "TYX", {}),
    "2d_windows": (D.tube_series_2d, D.DIM_RES_2D, "TYX",
                   dict(low_memory=True, max_chunk_voxels=32 * 32)),
}


def _two_copies(tmp_path, case):
    make, dim_res, axes, _ = CASES[case]
    data = make()
    return (D.open_im_info(D.write_input(tmp_path / "jax", data, dim_res, axes)),
            D.open_im_info(D.write_input(tmp_path / "port", data, dim_res, axes)))


def _assert_preprocessed(ref, port):
    """Bitwise, and (the bar) within 1e-4 of the frame max."""
    D.assert_artifact_equal(ref, port, "im_preprocessed", 1e-4)
    D.assert_artifact_equal(ref, port, "im_preprocessed", "exact")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's float16 Filter and Label on each case, once."""
    out = {}
    for case, (_, _, _, kw) in CASES.items():
        ref, _ = _two_copies(tmp_path_factory.mktemp(case), case)
        JFilter(ref, carry_dtype="float16", **kw).run()
        JLabel(ref).run()
        out[case] = ref
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_filter_float16_equals_the_reference(tmp_path, reference, case):
    ref = reference[case]
    _, port = _two_copies(tmp_path, case)
    Filter(port, device="cpu", carry_dtype="float16", **CASES[case][3]).run()
    Label(port, device="cpu").run()
    _assert_preprocessed(ref, port)
    D.assert_artifact_equal(ref, port, "im_instance_label", "exact")


@pytest.mark.parametrize("case", ["3d", "2d_windows"])
def test_run_config_float16(tmp_path, reference, case):
    """``run(config=...)`` takes the carry to the Filter of the whole run
    (the fused chain for whole frames, the per-stage path in low memory)."""
    ref = reference[case]
    _, port = _two_copies(tmp_path, case)
    kw = CASES[case][3]
    cfg = SettingsConfig(preprocessing_carry_dtype="float16",
                         preprocessing_low_memory=kw.get("low_memory", False),
                         preprocessing_max_chunk_voxels=kw.get("max_chunk_voxels", int(1e6)))
    info = run(D.file_info(port.file_info.filepath), device="cpu", config=cfg)
    _assert_preprocessed(ref, info)
    D.assert_artifact_equal(ref, info, "im_instance_label", "exact")
    assert D.read(info, "flow_vector_array").shape[0] > 0


def _vesselness(carry, frob_thresh):
    params = frangi.FrangiParams(sigmas=SIGMAS, spacing=SPACING, z_ratio=2.5,
                                 frob_thresh=frob_thresh, carry_dtype=carry)
    v, m = frangi.vesselness_frame(torch.from_numpy(_tube_frame()), params)
    return v.numpy(), m.numpy()


@pytest.mark.parametrize("frob_thresh", [0.05, 0.3])
def test_float16_with_explicit_frob_thresh_keeps_the_float32_mask(frob_thresh):
    """At ``tests/test_frangi_f16.py``'s tolerances (foreground IoU > 0.98,
    correlation > 0.995), and bitwise to the JAX float16 path."""
    v32, m32 = _vesselness("float32", frob_thresh)
    v16, m16 = _vesselness("float16", frob_thresh)
    fg32, fg16 = v32 > 0, v16 > 0
    assert (fg32 & fg16).sum() / max(1, (fg32 | fg16).sum()) > 0.98
    both = fg32 & fg16
    assert np.corrcoef(v32[both], v16[both])[0, 1] > 0.995
    assert (m32 == m16).mean() > 0.99
    j_params = j_frangi.FrangiParams(sigmas=SIGMAS, spacing=SPACING, z_ratio=2.5,
                                     frob_thresh=frob_thresh, carry_dtype="float16")
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_params))(
        jnp.asarray(_tube_frame()))
    np.testing.assert_array_equal(v16.view(np.int32), np.asarray(v_j).view(np.int32))
    np.testing.assert_array_equal(m16, np.asarray(m_j))
    # a threshold divided by the pre-normalisation scale would lose the mask
    scale = float(np.abs(_tube_frame()).max())
    _, m_rescaled = _vesselness("float16", frob_thresh / scale)
    assert (m_rescaled == m32).mean() < 0.9
