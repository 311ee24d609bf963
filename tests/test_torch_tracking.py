"""HuMomentTracking, FlowInterpolator, voting and VoxelReassigner of the
PyTorch port against the JAX package.

Each stage gets the JAX package's artifacts from the stage before it, on
its own copy of the input.  Bars: ``flow_vector_array`` has the same rows
(t, coordinates, vector) in the same order; reassigned labels and
``voxel_matches`` are exactly equal.

The flow cost column is held to 1e-4 absolute.  It averages z-scored
differences of features whose float32 sums cancel (third-order moments,
the ROI variance), so the port sums them in the reference's order; what
is left are last-bit differences of the natural log (largest cost
difference on this input: 1.0e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D
from nellie_tpu.kernels import matching as j_matching
from nellie_tpu.kernels import moments as j_moments
from nellie_tpu.kernels import voting as j_voting
from nellie_tpu.stages import flow_interpolation as j_fi
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.kernels import matching, moments, voting
from nellie_tpu_torch.stages.flow_interpolation import FlowInterpolator
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

SEGMENTATION = ["im_preprocessed", "im_instance_label", "im_skel", "im_pixel_class",
                "im_skel_relabelled", "im_marker", "im_distance", "im_border"]
COST_ATOL = 1e-4


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's artifacts of all six stages."""
    im_info = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), D.tube_series()))
    for stage in (JFilter, JLabel, JNetwork, JMarkers, JTracking, JReassigner):
        stage(im_info, device="cpu").run()
    return im_info


@pytest.fixture
def port(tmp_path):
    return D.open_im_info(D.write_input(tmp_path, D.tube_series()))


def assert_flow_equal(ref, got):
    assert ref.shape == got.shape and ref.shape[0] > 0, (ref.shape, got.shape)
    np.testing.assert_array_equal(got[:, :7], ref[:, :7])
    np.testing.assert_allclose(got[:, 7], ref[:, 7], rtol=0, atol=COST_ATOL)


def test_tracking_stage(reference, port):
    D.copy_artifacts(reference, port, SEGMENTATION)
    HuMomentTracking(port, device="cpu").run()
    assert_flow_equal(D.read(reference, "flow_vector_array"), D.read(port, "flow_vector_array"))


def test_reassigner_stage(reference, port):
    D.copy_artifacts(reference, port, SEGMENTATION + ["flow_vector_array"])
    VoxelReassigner(port, device="cpu").run()
    for name in ("im_branch_label_reassigned", "im_obj_label_reassigned"):
        D.assert_artifact_equal(reference, port, name, "exact")
    ref, got = D.read(reference, "voxel_matches"), D.read(port, "voxel_matches")
    assert len(ref) == len(got) > 0
    for pair_ref, pair_got in zip(ref, got):
        for a, b in zip(pair_ref, pair_got):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("forward", [True, False])
def test_flow_interpolator(reference, port, forward):
    D.copy_artifacts(reference, port, ["flow_vector_array"])
    rng = np.random.default_rng(int(forward))
    coords = np.argwhere(D.read(reference, "im_instance_label")[1] > 0).astype(float)
    coords = coords[rng.permutation(len(coords))[:400]] + rng.normal(0, 0.7, (400, 3))
    coords[:5] = np.nan
    ref = j_fi.FlowInterpolator(reference, forward=forward).interpolate_coord(coords, 1)
    got = FlowInterpolator(port, forward=forward, device="cpu").interpolate_coord(coords, 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert (~np.isnan(ref)).any()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_interpolate_coord_dev(reference, port):
    """The device variant gives the host variant's vectors as a float32
    tensor, and None for a frame without flow rows."""
    D.copy_artifacts(reference, port, ["flow_vector_array"])
    interp = FlowInterpolator(port, forward=True, device="cpu")
    coords = np.argwhere(D.read(reference, "im_instance_label")[1] > 0).astype(float)[:300]
    coords[:3] = np.nan
    vec = interp.interpolate_coord_dev(coords, 1)
    assert vec.dtype == torch.float32 and tuple(vec.shape) == coords.shape
    np.testing.assert_array_equal(vec.numpy(), interp.interpolate_coord(coords, 1))
    assert np.isnan(vec.numpy()[:3]).all() and not np.isnan(vec.numpy()).all()
    last = D.tube_series().shape[0] - 1  # forward flow rows end one frame early
    assert interp.interpolate_coord_dev(coords, last) is None
    assert np.isnan(interp.interpolate_coord(coords, last)).all()


@pytest.mark.parametrize("seed", range(3))
def test_vote_kernel(seed):
    """Many candidates per (target, label), exact weight ties included."""
    rng = np.random.default_rng(seed)
    n = 4096
    target = rng.integers(0, 300, n).astype(np.int32)
    labels = rng.integers(1, 6, n).astype(np.int32)
    dist = rng.choice(np.float32([0.2, 0.4, 0.5, 0.7]), n) + rng.integers(0, 2, n) * rng.random(n)
    weights = (1.0 / (dist.astype(np.float32) + np.float32(1e-6))).astype(np.float32)
    valid = rng.random(n) < 0.9
    ref = [np.asarray(a) for a in j_voting._vote_kernel(
        jnp.asarray(target), jnp.asarray(labels), jnp.asarray(weights), jnp.asarray(valid))]
    got = voting._vote_kernel(torch.from_numpy(target), torch.from_numpy(labels),
                              torch.from_numpy(weights), torch.from_numpy(valid))
    win_r, win_g = ref[0], got[0].numpy()
    np.testing.assert_array_equal(win_g, win_r)
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy()[win_g], r[win_r])


def test_match_frames_device():
    """Same features in, same matches and costs out."""
    rng = np.random.default_rng(4)
    n_post, n_pre, n_feat = 70, 60, 22
    coords_pre = (rng.integers(0, 20, (n_pre, 3)) * np.float32([0.5, 0.2, 0.2])).astype(np.float32)
    coords_post = (coords_pre[rng.integers(0, n_pre, n_post)]
                   + rng.normal(0, 0.2, (n_post, 3))).astype(np.float32)
    feats_pre = rng.normal(0, 1, (n_pre, n_feat)).astype(np.float32)
    feats_post = rng.normal(0, 1, (n_post, n_feat)).astype(np.float32)
    pad = 128

    def padded(a, fill=0):
        out = np.full((pad,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return jnp.asarray(out)

    ref = j_matching.match_frames_device(
        padded(coords_post), padded(feats_post), padded(np.ones(n_post, bool), False), n_post,
        padded(coords_pre), padded(feats_pre), padded(np.ones(n_pre, bool), False), n_pre,
        1.0, 4)
    got = matching.match_frames_device(
        torch.from_numpy(coords_post), torch.from_numpy(feats_post),
        torch.from_numpy(coords_pre), torch.from_numpy(feats_pre), 1.0, 4)
    assert len(ref[0]) > 0
    assert got[0] == ref[0] and got[1] == ref[1]
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)


def test_moment_helpers():
    """Raw, central and normalised moments and the masked statistics are
    summed in the reference's order, so they agree bit for bit."""
    rng = np.random.default_rng(5)
    cubes = (rng.random((40, 12, 12, 12)) * 500 * (rng.random((40, 12, 12, 12)) > 0.6)).astype(np.float32)
    ref = np.asarray(jax.jit(j_moments.masked_mean_variance)(jnp.asarray(cubes)))
    got = moments.masked_mean_variance(torch.from_numpy(cubes)).numpy()
    np.testing.assert_array_equal(got, ref)
    proj = cubes.max(axis=1)
    for name in ("raw_moments", "normalized_moments"):
        ref = np.asarray(jax.jit(getattr(j_moments, name))(jnp.asarray(proj)))
        got = getattr(moments, name)(torch.from_numpy(proj)).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=name)
    eta = np.array(jax.jit(j_moments.normalized_moments)(jnp.asarray(proj)))
    ref_hu = np.asarray(jax.jit(j_moments.hu_moments)(jnp.asarray(eta)))
    got_hu = moments.hu_moments(torch.from_numpy(eta)).numpy()
    np.testing.assert_allclose(got_hu, ref_hu, rtol=1e-4, atol=1e-12)


def test_log_hu_flushes_subnormals():
    """A Hu value below float32's smallest normal is 0 to the reference (XLA
    flushes subnormal results), so its log feature is 0, not ±37.9."""
    tiny = np.finfo(np.float32).tiny
    hu = np.array([[0.0, tiny / 4, -tiny / 3, tiny, -2.5e-30, 0.7, -1e-3]], np.float32)
    want = np.asarray(jax.jit(j_moments.log_hu)(jnp.asarray(hu)))
    np.testing.assert_array_equal(moments.log_hu(torch.from_numpy(hu)).numpy(), want)
