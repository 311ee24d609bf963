"""The Filter's thresholds where a scale has no positive sampled voxel.

``WholeFrame.triangle_otsu`` and the mesh's ``triangle_otsu`` hand the
threshold kernel's result on as it is, with no host read: 0 when no sampled
voxel is positive, which ``_gammas`` clamps to the reference's EPS32 and
``_frob_masks`` turns into the reference's ``frob > 0``.  On a series of
two bright voxels sampled at ``max_threshold_samples=20`` the first scales
of each frame have no positive sample, for the gamma and for the Frobenius
threshold alike; the port's Filter writes the reference's
``im_preprocessed`` there bit for bit, and the same Filter over a mesh of
two logical CPU shards writes one device's file byte for byte.
"""
import numpy as np
import pytest
import torch

import torch_port_data as D
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu_torch.kernels import frangi, thresholds
from nellie_tpu_torch.mesh import make_mesh
from nellie_tpu_torch.stages.filtering import Filter
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

MAX_SAMPLES = 20


def two_voxels():
    """(T, Z, Y, X) uint16: zero but for a bright voxel a frame and a
    dimmer one in the second frame, off the sampling grid's points."""
    data = np.zeros((2, 8, 36, 36), np.uint16)
    data[:, 2, 15, 15] = 1000
    data[1, 5, 20, 27] = 500
    return data


def run_filter(directory, stage, **kw):
    im_info = D.open_im_info(D.write_input(directory, two_voxels(), dim_res=D.DIM_RES,
                                           axes="TZYX"))
    stage(im_info, max_threshold_samples=MAX_SAMPLES, **kw).run()
    return im_info


@pytest.fixture(scope="module")
def filtered(tmp_path_factory, one_torch_thread):  # noqa: F811
    """{side: ImInfo} of the reference, the port and the port over a mesh,
    and the masked counts of the port's threshold calls."""
    seen = {"port": [], "mesh": []}
    original = thresholds.min_triangle_otsu
    out = {"jax": run_filter(tmp_path_factory.mktemp("jax"), JFilter, device="cpu")}
    for side, kw in (("port", dict(device="cpu")),
                     ("mesh", dict(mesh=make_mesh(devices=["cpu"] * 2, t_axis=1)))):
        def spy(values, mask=None, nbins=256, side=side):
            seen[side].append(int(mask.sum()))
            return original(values, mask, nbins)

        thresholds.min_triangle_otsu = spy
        try:
            out[side] = run_filter(tmp_path_factory.mktemp(side), Filter, **kw)
        finally:
            thresholds.min_triangle_otsu = original
    return out, seen


def test_some_scales_sample_no_positive_voxel(filtered):
    """The gamma and Frobenius thresholds of the first scale see no
    positive sample, the later scales of the first frame some, on one
    device and over the mesh alike."""
    _, seen = filtered
    assert seen["mesh"] == seen["port"]
    assert len(seen["port"]) == 20 and seen["port"][:2] == [0, 0] and min(seen["port"][2:10]) > 0


def test_filter_equals_the_reference(filtered):
    out, _ = filtered
    D.assert_artifact_equal(out["jax"], out["port"], "im_preprocessed", "exact")


def test_mesh_equals_one_device(filtered):
    out, _ = filtered
    a, b = (D.read(out[k], "im_preprocessed") for k in ("port", "mesh"))
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert a.max() > 0


def test_zero_threshold_is_the_empty_samples_choice():
    """A threshold of 0 gives gamma EPS32 and the mask frob > 0, the
    constants the reference takes with no positive sample."""
    class Zero:
        @staticmethod
        def triangle_otsu(blocks, max_samples):
            return [torch.zeros((), device=b.device) for b in blocks]

    gamma = frangi._gammas([torch.zeros(4, 4)], MAX_SAMPLES, Zero)[0]
    eps = torch.tensor(frangi.EPS32)
    assert gamma.dtype == eps.dtype and torch.equal(gamma.view(torch.int32), eps.view(torch.int32))
    frob = torch.tensor([[-1.0, 0.0], [1e-30, 2.0]])
    params = frangi.FrangiParams(sigmas=(1.0,), spacing=(1.0, 1.0))
    assert torch.equal(frangi._frob_masks([frob], params, Zero)[0], frob > 0)
    empty = torch.zeros(3, 5)
    assert float(frangi.WholeFrame.triangle_otsu([empty], MAX_SAMPLES)[0]) == 0.0
