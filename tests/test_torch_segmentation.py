"""Filter, Label, Network and Markers of the PyTorch port against the JAX package.

Each stage of the port gets the JAX package's artifacts from the stage
before it, on its own copy of the input.  Bars: ``im_preprocessed`` and
``im_distance`` within 1e-4 of the frame max (the reference's own bar);
the integer artifacts exactly equal.  Module cases hold the kernels to the
same bars on seeded random inputs.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D
from nellie_tpu.kernels import ccl as j_ccl
from nellie_tpu.kernels import edt as j_edt
from nellie_tpu.kernels import eigen as j_eigen
from nellie_tpu.kernels import filters as j_filters
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.kernels import skeleton as j_skeleton
from nellie_tpu.kernels import thresholds as j_thr
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu_torch.kernels import ccl, edt, eigen, filters, frangi, skeleton, thresholds
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's Filter -> Label -> Network -> Markers artifacts."""
    im_info = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), D.tube_series()))
    for stage in (JFilter, JLabel, JNetwork, JMarkers):
        stage(im_info, device="cpu").run()
    return im_info


@pytest.fixture
def port(tmp_path):
    return D.open_im_info(D.write_input(tmp_path, D.tube_series()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def test_filter_stage(reference, port):
    Filter(port, device="cpu").run()
    D.assert_artifact_equal(reference, port, "im_preprocessed", 1e-4)
    a, b = D.read(reference, "im_preprocessed"), D.read(port, "im_preprocessed")
    np.testing.assert_array_equal(a > 0, b > 0)


def test_label_stage(reference, port):
    D.copy_artifacts(reference, port, ["im_preprocessed"])
    Label(port, device="cpu").run()
    D.assert_artifact_equal(reference, port, "im_instance_label", "exact")
    assert D.read(port, "im_instance_label").max() >= 1


def test_network_stage(reference, port):
    D.copy_artifacts(reference, port, ["im_preprocessed", "im_instance_label"])
    Network(port, device="cpu").run()
    for name in ("im_skel", "im_pixel_class", "im_skel_relabelled"):
        D.assert_artifact_equal(reference, port, name, "exact")


def test_markers_stage(reference, port):
    D.copy_artifacts(reference, port, ["im_preprocessed", "im_instance_label"])
    Markers(port, device="cpu").run()
    D.assert_artifact_equal(reference, port, "im_distance", 1e-4)
    for name in ("im_marker", "im_border"):
        D.assert_artifact_equal(reference, port, name, "exact")
    assert D.read(port, "im_marker").sum() > 0


def test_artifact_metadata_matches(reference, port):
    Filter(port, device="cpu").run()
    a = reference.get_memmap(reference.pipeline_paths["im_preprocessed"])
    b = port.get_memmap(port.pipeline_paths["im_preprocessed"])
    assert a.dtype == b.dtype and a.shape == b.shape


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_thresholds_choose_the_same_bin(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.normal(1.0, 0.3, 3000), rng.gamma(2.0, 2.0, 1500)]).astype(np.float32)
    mask = rng.random(values.shape) < 0.8
    jv, jm = jnp.asarray(values), jnp.asarray(mask)
    pv, pm = _t(values), _t(mask)
    # the JAX package always runs these inside jit, where XLA fuses them
    otsu = jax.jit(lambda v, m: j_thr.otsu_threshold(v, m)[0])
    assert float(thresholds.otsu_threshold(pv, pm)[0]) == float(otsu(jv, jm))
    assert float(thresholds.triangle_threshold(pv, pm)) == float(jax.jit(j_thr.triangle_threshold)(jv, jm))
    assert float(thresholds.min_triangle_otsu(pv, pm)) == float(jax.jit(j_thr.min_triangle_otsu)(jv, jm))


def test_thresholds_empty_mask():
    v = torch.rand(100)
    m = torch.zeros(100, dtype=torch.bool)
    assert float(thresholds.otsu_threshold(v, m)[0]) == 0.0
    assert float(thresholds.triangle_threshold(v, m)) == 0.0


def test_sampling_helpers():
    for shape, budget in (((12, 48, 48), 1000), ((64, 256, 256), int(1e6)), ((5, 5, 5), 10)):
        assert thresholds.sample_strides(shape, budget) == j_thr.sample_strides(shape, budget)
        strides = thresholds.sample_strides(shape, budget)
        np.testing.assert_array_equal(thresholds.stride_mask(shape, strides, "cpu").numpy(),
                                      np.asarray(j_thr.stride_mask(shape, strides)))


@pytest.mark.parametrize("seed", range(3))
def test_label_scipy_numbering(seed):
    rng = np.random.default_rng(seed)
    mask = ndi.binary_opening(rng.random((10, 24, 24)) < 0.45)
    labels, n = ccl.label(_t(mask))
    ref, n_ref = ndi.label(mask, structure=np.ones((3, 3, 3)))
    assert n == n_ref
    np.testing.assert_array_equal(labels.numpy(), ref)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_ccl.label(jnp.asarray(mask))[0]))


@pytest.mark.parametrize("seed", range(3))
def test_fill_holes_and_small_components(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((8, 20, 20)) < 0.55
    np.testing.assert_array_equal(ccl.fill_holes(_t(mask)).numpy(), ndi.binary_fill_holes(mask))
    for min_size in (1, 4, 8):
        np.testing.assert_array_equal(
            ccl.remove_small_components(_t(mask), min_size).numpy(),
            np.asarray(j_ccl.remove_small_components(jnp.asarray(mask), min_size)))


def test_eigvalsh3_matches():
    rng = np.random.default_rng(0)
    comps = [rng.normal(0, 3, (6, 10, 10)).astype(np.float32) for _ in range(6)]
    comps[1][0] = 0.0  # some diagonal-only matrices
    comps[2][0] = 0.0
    comps[4][0] = 0.0
    ref = [np.asarray(x) for x in jax.jit(j_eigen.eigvalsh3)(*[jnp.asarray(c) for c in comps])]
    got = [x.numpy() for x in eigen.eigvalsh3(*[_t(c) for c in comps])]
    scale = max(np.abs(r).max() for r in ref)
    for r, g in zip(ref, got):
        assert np.abs(r - g).max() <= 1e-4 * scale


def test_vesselness_frame_matches():
    frame = D.tube_series()[0].astype(np.float32)
    params = frangi.FrangiParams(sigmas=(0.625, 0.825, 1.025), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
    j_params = j_frangi.FrangiParams(sigmas=(0.625, 0.825, 1.025), spacing=(0.5, 0.2, 0.2),
                                     z_ratio=2.5)
    v_j, m_j = (np.asarray(a) for a in j_frangi.vesselness_frame(jnp.asarray(frame), j_params))
    v_p, m_p = frangi.vesselness_frame(_t(frame), params)
    assert np.abs(v_j - v_p.numpy()).max() <= 1e-4 * np.abs(v_j).max()
    np.testing.assert_array_equal(m_j, m_p.numpy())


def test_frangi_params_refuse_float16_carry():
    with pytest.raises(NotImplementedError):
        frangi.FrangiParams(sigmas=(1.0,), spacing=(1.0, 1.0, 1.0), carry_dtype="float16")


def test_filters_bitwise():
    """Bitwise equal to the jitted JAX filters (the stages always jit them)."""
    rng = np.random.default_rng(1)
    x = (rng.random((9, 20, 22)) * 100).astype(np.float32)
    jx, px = jnp.asarray(x), _t(x)
    sig = (0.7, 1.6, 1.3)
    pairs = [
        (lambda v: j_filters.gaussian_laplace(v, sig), filters.gaussian_laplace(px, sig)),
        (lambda v: j_filters.maximum_filter(v, 3), filters.maximum_filter(px, 3)),
        (lambda v: j_filters.minimum_filter(v, 5, mode="constant", cval=7.0),
         filters.minimum_filter(px, 5, mode="constant", cval=7.0)),
        (lambda v: j_filters.uniform_filter(v > 50, 3), filters.uniform_filter(px > 50, 3)),
        (lambda v: j_filters.binary_opening(v > 40), filters.binary_opening(px > 40)),
    ]
    for ref, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(ref)(jx)))


def test_skeletonize_3d_matches():
    labels = D.tube_series()[0] > 400
    labels = ndi.binary_closing(labels, iterations=1)
    got = skeleton.skeletonize_3d(_t(labels)).numpy()
    ref = np.asarray(j_skeleton.skeletonize_3d(jnp.asarray(labels), backend="lut"))
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_distance_transform_and_nearest_seed():
    rng = np.random.default_rng(2)
    mask = ndi.binary_dilation(rng.random((10, 30, 30)) < 0.02, iterations=3)
    got = edt.distance_transform(_t(mask)).numpy()
    np.testing.assert_allclose(got, ndi.distance_transform_edt(mask), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        edt.distance_transform(_t(mask), max_radius_px=3).numpy(),
        np.asarray(j_edt.distance_transform(jnp.asarray(mask), max_radius_px=3)))
    objects, _ = ndi.label(mask)
    seeds = np.where((rng.random(mask.shape) < 0.05) & mask, rng.integers(1, 9, mask.shape), 0)
    samp = (0.5, 0.2, 0.2)
    lab_p, dist_p = edt.nearest_seed(_t(seeds.astype(np.int32)), _t(objects.astype(np.int32)), samp)
    lab_j, dist_j = j_edt.nearest_seed(jnp.asarray(seeds, jnp.int32),
                                       jnp.asarray(objects, jnp.int32), samp)
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(dist_p.numpy(), np.asarray(dist_j))
