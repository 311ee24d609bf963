"""The port's Filter against the JAX package's, bit for bit on the CPU, with
XLA's CPU roundings mirrored: the 3D vesselness in one window and in the
low-memory Filter's windows, the Filter stage, a whole 3D frame at the
main 3D shape's width (256; the width 128, at which XLA fuses the Hessian's
inner gradient whole, is in ``tests/test_torch_parity_repairs.py``), XLA's
rule for that fusion, and the 2D vesselness.
"""
import numpy as np
import pytest
import torch

import jax

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu_torch.kernels import frangi, hessian
from nellie_tpu_torch.stages.filtering import Filter

N = 1_000_000
T = torch.from_numpy


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    differ = (got.view(np.int32) != want.view(np.int32)) & ~(np.isnan(got) & np.isnan(want))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


@pytest.mark.parametrize("t", range(3))
def test_vesselness_3d_bitwise(t):
    frame = D.tube_series()[t].astype(np.float32)
    sigmas, spacing = (0.625, 0.8333, 1.0417, 1.25), (0.5, 0.2, 0.2)
    params = frangi.FrangiParams(sigmas=sigmas, spacing=spacing, z_ratio=2.5)
    j_params = j_frangi.FrangiParams(sigmas=sigmas, spacing=spacing, z_ratio=2.5)
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_params))(frame)
    v_p, m_p = frangi.vesselness_frame(T(frame), params)
    assert_bitwise(v_p, v_j)
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("kw", [{}, dict(low_memory=True, max_chunk_voxels=12 * 24 * 24)])
def test_filter_3d_equals_the_reference(tmp_path, kw):
    """``im_preprocessed`` of the 3D tube series, whole frames and the
    low-memory windows: the reference's bit for bit."""
    ref, port = D.two_copies(tmp_path)
    JFilter(ref, **kw).run()
    Filter(port, device="cpu", **kw).run()
    D.assert_artifact_equal(ref, port, "im_preprocessed", "exact")


@pytest.mark.parametrize("width", [256])
def test_filter_3d_whole_frames_at_fused_widths(tmp_path, width):
    """Whole 3D frames whose last axis is 128, the one width at which XLA
    fuses the inner gradient of ``hzz`` whole (``hessian._fuses_inner_gradient``),
    and the main 3D shape's width, 256: ``im_preprocessed`` bit for bit."""
    ref, port = D.two_copies(tmp_path, D.tube_series((3, 12, 48, width)))
    JFilter(ref).run()
    Filter(port, device="cpu").run()
    D.assert_artifact_equal(ref, port, "im_preprocessed", "exact")


def test_inner_gradient_fusion_rule():
    """XLA leaves a minor-axis concatenation of 128 elements or more
    unfused, so only a last axis of exactly 128 fuses the inner gradient;
    the other axes never do -- but in a frame no axis of which is longer
    than 32, where every axis fuses it."""
    fused = [w for w in range(2, 600)
             if hessian._fuses_inner_gradient(torch.zeros(1, 48, w), 2)]
    assert fused == [128]
    assert not hessian._fuses_inner_gradient(torch.zeros(1, 128, 128), 1)
    assert hessian._fuses_inner_gradient(torch.zeros(64, 128), 1)
    assert all(hessian._fuses_inner_gradient(torch.zeros(1, 1, w), 2) for w in range(2, 33))
    assert not hessian._fuses_inner_gradient(torch.zeros(1, 1, 33), 2)


@pytest.mark.parametrize("shape", [(64, 64), (64, 128), (128, 256)])
def test_vesselness_2d_bitwise(shape):
    """The 2D ``hyy`` rounds as the 3D ``hyy`` and ``hzz`` do: its edges,
    and at a width of 128 its interior, take a fused multiply-add."""
    frame = D.tube_series_2d((1,) + shape)[0].astype(np.float32)
    sigmas, spacing = (0.5, 0.75, 1.0), (0.1, 0.1)
    params = frangi.FrangiParams(sigmas=sigmas, spacing=spacing)
    j_params = j_frangi.FrangiParams(sigmas=sigmas, spacing=spacing)
    v_j, m_j = jax.jit(lambda x: j_frangi.vesselness_frame(x, j_params))(frame)
    v_p, m_p = frangi.vesselness_frame(T(frame), params)
    assert_bitwise(v_p, v_j)
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
