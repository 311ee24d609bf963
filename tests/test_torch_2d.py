"""The 2D branch of the PyTorch port against the JAX package.

Kernel cases give the same numpy inputs, made from seeds, to the jitted
JAX functions and to their ports on the CPU.  Stage cases run the JAX
package's seven stages once on a 3 x 64 x 64 ``TYX`` series
(``torch_port_data.tube_series_2d``), give each port stage the JAX
package's artifacts from the stages before it, and compare its outputs.

Bars: ``im_preprocessed`` and ``im_distance`` within 1e-4 of the frame
max, their masks exact; every integer artifact exact; the flow rows exact
and their costs within 1e-4; the feature CSVs at the features bar (rtol
and atol 1e-4, NaN where the reference has NaN) and the adjacency edges
exact.  ``eigvalsh2``, ``log_blobness_2d``, XLA's ``exp`` and the thinning
are bitwise.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D
from nellie_tpu.kernels import eigen as j_eigen
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.kernels import skeleton as j_skeleton
from nellie_tpu.stages import hierarchical as j_hier
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.hierarchical import Hierarchy as JHierarchy
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.kernels import _fp, eigen, frangi, skeleton
from nellie_tpu_torch.stages import hierarchical as hier
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.hierarchical import Hierarchy
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner
from oracle.e2e_cpu import _skeletonize_2d_np

T = torch.from_numpy
SIGMAS = (1.25, 1.6667, 2.0833, 2.5, 2.9167)  # the Filter's ladder at X = 0.1 µm
SPACING_2D = (0.1, 0.1)
COST_ATOL = 1e-4


def _frames():
    return D.tube_series_2d().astype(np.float32)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "off_diagonal_zero", "equal_diagonal"])
def test_eigvalsh2_bitwise(case):
    rng = np.random.default_rng(0)
    hxx, hxy, hyy = (rng.normal(0, 3, 50_000).astype(np.float32) for _ in range(3))
    if case == "off_diagonal_zero":
        hxy[:] = 0.0
    elif case == "equal_diagonal":
        hyy = hxx.copy()
    want = jax.jit(j_eigen.eigvalsh2)(hxx, hxy, hyy)
    got = eigen.eigvalsh2(T(hxx), T(hxy), T(hyy))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lo, hi", [(-1.0, 1.0), (-30.0, 0.0), (-100.0, 100.0), (-1e-6, 1e-6)])
def test_exp_bitwise_to_xla(lo, hi):
    """The Frangi response's exp, subnormal flush and clamping included."""
    x = np.random.default_rng(1).uniform(lo, hi, 200_000).astype(np.float32)
    np.testing.assert_array_equal(_fp.exp(T(x)).numpy(), np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("t", range(3))
def test_vesselness_and_blobness_2d(t):
    frame = _frames()[t]
    params = frangi.FrangiParams(sigmas=SIGMAS, spacing=SPACING_2D)
    j_params = j_frangi.FrangiParams(sigmas=SIGMAS, spacing=SPACING_2D)
    v_j, m_j = (np.asarray(a) for a in j_frangi.vesselness_frame(jnp.asarray(frame), j_params))
    v_p, m_p = frangi.vesselness_frame(T(frame), params)
    assert np.abs(v_j - v_p.numpy()).max() <= 1e-4 * np.abs(v_j).max()
    np.testing.assert_array_equal(m_p.numpy(), m_j)
    b_j = np.asarray(j_frangi.log_blobness_2d(jnp.asarray(frame), jnp.asarray(m_j), j_params))
    b_p = frangi.log_blobness_2d(T(frame), T(m_j.copy()), params).numpy()
    np.testing.assert_array_equal(b_p, b_j)
    assert b_p.max() == np.float32(0.1)


def test_remove_edges_2d():
    frame = _frames()[0]
    frame[frame < 200] = 0
    frame[:, :5] = 0  # rows without signal above and below the margins
    want = np.asarray(j_frangi.remove_edges_frame(jnp.asarray(frame)))
    got = frangi.remove_edges_frame(T(frame)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > (frame == 0).sum()


@pytest.mark.parametrize("seed", range(3))
def test_skeletonize_2d(seed):
    rng = np.random.default_rng(seed)
    mask = ndi.binary_opening(ndi.gaussian_filter(rng.random((64, 64)), 2.0) > 0.5)
    mask |= _frames()[seed] > 400
    got = skeleton.skeletonize_2d(T(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_skeleton.skeletonize_2d(jnp.asarray(mask))))
    np.testing.assert_array_equal(got, _skeletonize_2d_np(mask))
    np.testing.assert_array_equal(skeleton.skeletonize(T(mask)).numpy(), got)
    assert 0 < got.sum() < mask.sum()


def _motility_inputs_2d(seed, n=3000):
    rng = np.random.default_rng(seed)
    coords = rng.permutation(np.argwhere(np.ones((60, 60))))[:n].astype(np.float32)
    vec = np.zeros((n, 2), np.float32)
    vec[:, 0] = np.float32(1.0) + rng.integers(-2, 3, n).astype(np.float32) * np.float32(6e-8)
    vec[:, 1] = rng.normal(0, 0.4, n).astype(np.float32) * (rng.random(n) < 0.5)
    turn = rng.random(n) < 0.05
    vec[turn] = -vec[turn]  # turns across ±π
    vec[rng.random(n) < 0.1] = np.nan
    labels = rng.integers(-1, 30, n).astype(np.int32)
    return coords, vec, labels


@pytest.mark.parametrize("has01", [True, False])
def test_motility_kernel_2d(has01):
    """Angular velocity and acceleration by the wrapped polar angle; the
    reference voxels agree bit for bit, the values at the features bar
    (XLA's CPU atan2 is not PyTorch's in the last bit)."""
    coords, vec12, labels = _motility_inputs_2d(4)
    _, vec01, _ = _motility_inputs_2d(5)
    if not has01:
        vec01 = np.full_like(vec01, np.nan)
    spacing = np.array(SPACING_2D, np.float32)
    dt = np.float32(2.0)
    want = np.asarray(j_hier._motility_kernel(coords, vec01, vec12, labels, spacing, dt,
                                              no_z=True, has01=has01, num_labels=30))
    got = hier._motility_kernel(T(coords), T(vec01), T(vec12), T(labels), T(spacing),
                                float(dt), has01=has01, num_labels=30).numpy()
    assert got.shape == want.shape == (9, len(coords))
    for i, key in enumerate(hier._MOTILITY_KEYS):
        np.testing.assert_array_equal(np.isnan(got[i]), np.isnan(want[i]), err_msg=key)
        ok = ~np.isnan(want[i])
        np.testing.assert_allclose(got[i][ok], want[i][ok], rtol=D.FEATURE_RTOL,
                                   atol=D.FEATURE_ATOL, err_msg=key)
    assert np.nanmax(got[hier._MOTILITY_KEYS.index("angular_vel")]) <= np.pi / dt


def test_angle_wrap_is_floor_mod():
    x = np.random.default_rng(7).uniform(-20, 20, 100_000).astype(np.float32)
    x[:4] = [np.pi, -np.pi, 3 * np.pi, 0.0]
    want = np.asarray(jax.jit(lambda v: (v + jnp.pi) % (2 * jnp.pi) - jnp.pi)(x))
    np.testing.assert_array_equal(hier._angle_wrap(T(x)).numpy(), want)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's artifacts of all seven stages on the 2D series."""
    im_info = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), D.tube_series_2d(),
                                           D.DIM_RES_2D, "TYX"))
    for stage in (JFilter, JLabel, JNetwork, JMarkers, JTracking, JReassigner):
        stage(im_info, device="cpu").run()
    JHierarchy(im_info, skip_nodes=False, device="cpu").run()
    return im_info


@pytest.fixture
def port(tmp_path):
    return D.open_im_info(D.write_input(tmp_path, D.tube_series_2d(), D.DIM_RES_2D, "TYX"))


def test_filter_stage_2d(reference, port):
    Filter(port, device="cpu").run()
    D.assert_artifact_equal(reference, port, "im_preprocessed", 1e-4)
    a, b = D.read(reference, "im_preprocessed"), D.read(port, "im_preprocessed")
    np.testing.assert_array_equal(a > 0, b > 0)
    assert a.shape == (3, 64, 64)


def test_label_stage_2d(reference, port):
    D.copy_artifacts(reference, port, ["im_preprocessed"])
    Label(port, device="cpu").run()
    D.assert_artifact_equal(reference, port, "im_instance_label", "exact")
    assert Label(port, device="cpu").min_area_pixels == 20  # ceil(π 0.25² / 0.1²)
    assert all(D.read(port, "im_instance_label")[t].max() >= 1 for t in range(3))


def test_network_stage_2d(reference, port):
    D.copy_artifacts(reference, port, ["im_preprocessed", "im_instance_label"])
    Network(port, device="cpu").run()
    for name in ("im_skel", "im_pixel_class", "im_skel_relabelled"):
        D.assert_artifact_equal(reference, port, name, "exact")


def test_markers_stage_2d(reference, port):
    D.copy_artifacts(reference, port, ["im_preprocessed", "im_instance_label"])
    Markers(port, device="cpu").run()
    D.assert_artifact_equal(reference, port, "im_distance", 1e-4)
    for name in ("im_marker", "im_border"):
        D.assert_artifact_equal(reference, port, name, "exact")
    assert D.read(port, "im_marker").sum() > 0


def test_tracking_stage_2d(reference, port):
    D.copy_artifacts(reference, port, list(D.SEGMENTATION_ARTIFACTS))
    HuMomentTracking(port, device="cpu").run()
    want, got = D.read(reference, "flow_vector_array"), D.read(port, "flow_vector_array")
    assert want.shape == got.shape and want.shape[1] == 6 and want.shape[0] > 0
    np.testing.assert_array_equal(got[:, :5], want[:, :5])
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=COST_ATOL)


def test_reassigner_stage_2d(reference, port):
    D.copy_artifacts(reference, port, list(D.SEGMENTATION_ARTIFACTS) + ["flow_vector_array"])
    VoxelReassigner(port, device="cpu").run()
    for name in ("im_branch_label_reassigned", "im_obj_label_reassigned"):
        D.assert_artifact_equal(reference, port, name, "exact")
    want, got = D.read(reference, "voxel_matches"), D.read(port, "voxel_matches")
    assert len(want) == len(got) == 2
    for pair_want, pair_got in zip(want, got):
        for a, b in zip(pair_want, pair_got):
            assert np.asarray(b).shape[1] == 2
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_hierarchy_stage_2d(reference, port):
    D.copy_artifacts(reference, port, D.HIERARCHY_INPUTS)
    Hierarchy(port, skip_nodes=False, device="cpu").run()
    for table in D.FEATURE_TABLES:
        want = D.read_features(reference.pipeline_paths[f"features_{table}"])
        got = D.read_features(port.pipeline_paths[f"features_{table}"])
        assert len(want) > 0
        D.assert_features_equal(want, got, table)
        if table != "image":
            assert got["z_raw"].isna().all(), table
    D.assert_adjacency_equal(D.read_adjacency(reference.pipeline_paths["adjacency_maps"]),
                             D.read_adjacency(port.pipeline_paths["adjacency_maps"]))


def test_empty_flow_array_has_six_columns(reference, port):
    """A pair without a match writes an empty (0, 6) flow array in 2D."""
    D.copy_artifacts(reference, port, list(D.SEGMENTATION_ARTIFACTS))
    marker_path = port.pipeline_paths["im_marker"]
    port._invalidate_memmap(marker_path)
    markers = port.get_memmap(marker_path)
    markers[1:] = 0
    markers.flush()
    HuMomentTracking(port, device="cpu").run()
    assert D.read(port, "flow_vector_array").shape == (0, 6)
