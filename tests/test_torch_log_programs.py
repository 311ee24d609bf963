"""The LoG as the reference's jitted programs round it, against the JAX package.

``_correlate1d`` with constant weights is one fused loop in XLA's CPU code.
Where its reflected taps reach past the far end of a short axis (a radius
of the axis's length or more: Z of 1 to 5 under the Markers' and the 2D
blobness's taps), two taps of one output read the same element with the
same weight; LLVM computes that product once and does not contract it into
a fused multiply-add (``filters.shared_products``, ``_tap_chain``).  The
2D Filter's ``log_blobness_2d`` masks each scale with a select, never
``-0``.  Held bit for bit against the jitted reference: ``_correlate1d``
and ``gaussian_laplace`` at axes shorter than their taps; the 2D Filter's
blobness program on ``chip_smoke.filter_frame`` frames, the sign of zero
included; and the 2D Filter stage's ``im_preprocessed`` byte for byte.

Markers' own program (``markers_frame_distance``, the stage's default) on
``filter_frame`` masks at Z of 3 to 9, radii 5 and 10 px: its LoG as the
program's maximum filters read it (``filters.log_program(sunk_centre=True)``,
held to the reference's filters read out of its program), and its markers,
held where they agree and marked as strict expected failures where the
port still marks 1-2 voxels otherwise (ROADMAP Queue 3, open #1: the last
fusion decides a peak from its own recomputed LoG at the voxel).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_port_data as D
from nellie_tpu.kernels import filters as j_filters
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.stages import mocap_marking as j_markers
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu_torch.kernels import filters, frangi
from nellie_tpu_torch.kernels._fp import f32
from nellie_tpu_torch.stages import mocap_marking as markers
from nellie_tpu_torch.stages.filtering import Filter
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

PARAMS_2D = dict(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))
# (sigma, derivative order): radii 8, 8, 4 and 3 under truncate 4
SHORT_TAPS = [(2.0, 0), (2.0, 2), (1.0, 0), (0.7, 2)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_correlate1d_past_the_extent(n, axis):
    shape = [20, 24, 28]
    shape[axis] = n
    frame = chip_smoke.filter_frame(tuple(shape), seed=n + axis)
    for sigma, order in SHORT_TAPS:
        w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
        want = jax.jit(lambda x: j_filters._correlate1d(x, w, axis))(frame)
        got = filters._correlate1d(torch.from_numpy(frame), w, axis)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"sigma {sigma} order {order}")


@pytest.mark.parametrize("z", [1, 3, 5])
def test_gaussian_laplace_at_short_z(z):
    frame = chip_smoke.filter_frame((z, 32, 40), seed=z)
    for sigma in [(2.0, 2.0, 2.0), (1.2, 2.2, 2.2), (0.88, 2.2, 2.2)]:
        want = jax.jit(lambda x: j_filters.gaussian_laplace(x, sigma))(frame)
        got = filters.gaussian_laplace(torch.from_numpy(frame), sigma)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want), err_msg=str(sigma))


def test_shared_products_table():
    taps = filters.nonzero_taps(filters.gaussian_kernel1d(0.7, 4.0, order=2))
    assert len(taps) == 7 and filters.shared_products(4, taps) is None
    shared = filters.shared_products(3, taps)
    # on 3 points the outermost taps, -3 and +3, reflect onto one element
    # at every output (at the middle one both read x[1])
    assert shared.shape == (3, 7) and shared.sum() == 6
    assert shared[:, 0].all() and shared[:, 6].all()
    assert filters.shared_products(40, taps) is None


@pytest.mark.parametrize("frame", [((64, 128), 2), ((64, 128), 11), ((48, 56), 2),
                                   ((256, 256), 5)],
                         ids=lambda f: "x".join(map(str, f[0])) + f"-{f[1]}")
def test_log_blobness_2d_program(frame):
    """The blobness program as the 2D Filter calls it: the raw uint16 frame
    and the vesselness mask; outside the mask +0, as XLA's select gives."""
    shape, seed = frame
    raw = np.clip(chip_smoke.filter_frame(shape, seed=seed), 0, 65535).astype(np.uint16)
    params = j_frangi.FrangiParams(**PARAMS_2D)
    _, mask = j_frangi.vesselness_frame(jnp.asarray(raw), params)
    want = j_frangi.log_blobness_2d(jnp.asarray(raw), mask, params)
    got = frangi.log_blobness_2d(torch.from_numpy(raw.astype(np.int32)),
                                 torch.from_numpy(np.asarray(mask)),
                                 frangi.FrangiParams(**PARAMS_2D))
    assert not np.asarray(mask).all()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_filter_stage_2d_bytes(tmp_path):
    frames = np.stack([chip_smoke.filter_frame((64, 128), seed=s) for s in (2, 11)])
    data = np.clip(frames, 0, 65535).astype(np.uint16)
    out = []
    for side, stage in (("jax", JFilter), ("port", Filter)):
        im_info = D.open_im_info(D.write_input(tmp_path / side, data, dim_res=D.DIM_RES_2D,
                                               axes="TYX"))
        stage(im_info, device="cpu").run()
        out.append(D.read(im_info, "im_preprocessed"))
    np.testing.assert_array_equal(out[0].view(np.uint32), out[1].view(np.uint32))


def _marker_params(module, max_radius_px):
    """The Markers stage's parameters at 0.2 um in X and 0.5 um in Z, a
    minimum radius of 1 px and five sigmas (``Markers._set_default_sigmas``)."""
    sigma_min, sigma_max = 0.5, max_radius_px / 3.0
    step = max(0.2, (sigma_max - sigma_min) / 5)
    sigmas = tuple(float(s) for s in np.arange(sigma_min, sigma_max, step))
    return module.MarkerParams(sigmas=sigmas, z_ratio=2.5, max_radius_px=float(max_radius_px),
                               peak_min_distance=2, truncate=4.0, no_z=False)


MARKERS_OPEN = pytest.mark.xfail(
    strict=True, reason="ROADMAP Queue 3 open #1: Markers' last fusion decides a peak from "
                        "its own LoG at the voxel, which the port does not model yet")
# a scan of Z 3, 5, 9, seeds 3, 5, 9 and radii 5 and 10 px, and the
# frames found before it; those still marking 1-2 voxels otherwise are
# strict expected failures, so that a repair shows as an unexpected pass
OPEN_FRAMES = {(3, 5, 10.0), (5, 3, 10.0), (5, 9, 5.0), (5, 9, 10.0), (9, 3, 5.0),
               (9, 3, 10.0), (9, 9, 10.0), (5, 105, 5.0), (9, 109, 10.0)}
SCAN = [(z, seed, r) for z in (3, 5, 9) for seed in (3, 5, 9) for r in (5.0, 10.0)] + [
    (5, 105, 5.0), (9, 109, 10.0)]


def _markers_inputs(z, seed):
    frame = chip_smoke.filter_frame((z, 48, 48), seed=seed)
    return np.clip(frame, 0, 65535).astype(np.uint16), frame > 300


@pytest.mark.parametrize("z,seed,max_radius_px", [
    pytest.param(*frame, marks=MARKERS_OPEN) if frame in OPEN_FRAMES else frame
    for frame in SCAN])
def test_markers_program_at_short_z(z, seed, max_radius_px):
    raw, mask = _markers_inputs(z, seed)
    want = j_markers.markers_frame_distance(jnp.asarray(raw), jnp.asarray(mask),
                                            _marker_params(j_markers, max_radius_px))
    got = markers.markers_frame_distance(torch.from_numpy(raw.astype(np.int32)),
                                         torch.from_numpy(mask),
                                         _marker_params(markers, max_radius_px))
    assert np.asarray(want[0]).sum() > 0
    for name, w, g in zip(("marker", "distance", "border"), want, got):
        np.testing.assert_array_equal(np.asarray(w).view(np.uint8), g.numpy().view(np.uint8),
                                      err_msg=name)


def _reference_max_filters(raw, mask, params):
    """The reference's ``markers_frame_distance`` with each scale's maximum
    filter of the clamped LoG read out by ``jax.debug.callback`` (the
    program's outputs stay the reference's, which the caller checks)."""
    from nellie_tpu.kernels.filters import binary_dilation
    from nellie_tpu.kernels.filters import maximum_filter as j_maximum_filter

    seen = {}

    def program(intensity, mask):
        mask = mask.astype(bool)
        distance = j_markers._clamped_distance(mask, params)
        border = binary_dilation(mask, connectivity=1) ^ mask
        valid = mask & (distance > 0)
        best = jnp.zeros(mask.shape, jnp.float32)
        peak = jnp.zeros(mask.shape, bool)
        for i, s in enumerate(params.sigmas):
            log_resp = -j_filters.gaussian_laplace(distance.astype(jnp.float32),
                                                   params.sigma_vec(float(s))) * (float(s) ** 2)
            log_resp = jnp.maximum(log_resp, 0.0)
            mf = j_maximum_filter(log_resp, 3)
            jax.debug.callback(lambda v, i=i: seen.__setitem__(i, np.asarray(v)), mf)
            local_max = (log_resp == mf) & valid
            better = local_max & (log_resp > best)
            peak = peak | better
            best = jnp.where(better, log_resp, best)
        score = jnp.where(peak, intensity.astype(jnp.float32), 0.0)
        size = 2 * int(params.peak_min_distance) + 1
        keep = (score == j_maximum_filter(score, size)) & (score > 0)
        return keep.astype(jnp.uint8), distance, border.astype(jnp.uint8)

    out = jax.jit(program)(jnp.asarray(raw), jnp.asarray(mask))
    return out, seen


@pytest.mark.parametrize("z,seed", [(3, 5), (5, 3), (9, 109)])
def test_markers_log_as_its_max_filters_read_it(z, seed):
    """In Markers' program the clamped distance is a select computed
    inline; where a pad fusion reads it once, LLVM multiplies inside the
    select and the axis-0 centre is rounded, not contracted
    (``filters.log_program(sunk_centre=True)``).  Each scale's maximum
    filter of the port's LoG equals the one the reference's program
    computes, bit for bit, at a radius of 10 px (five scales)."""
    raw, mask = _markers_inputs(z, seed)
    want = j_markers.markers_frame_distance(jnp.asarray(raw), jnp.asarray(mask),
                                            _marker_params(j_markers, 10.0))
    out, seen = _reference_max_filters(raw, mask, _marker_params(j_markers, 10.0))
    for w, o in zip(want, out):  # the read-out leaves the program's outputs as they were
        np.testing.assert_array_equal(np.asarray(w), np.asarray(o))
    params = _marker_params(markers, 10.0)
    distance = markers._clamped_distance(torch.from_numpy(mask), params)
    for i, s in enumerate(params.sigmas):
        log_resp = torch.clamp(-filters.log_program(distance, params.sigma_vec(s),
                                                    sunk_centre=True) * f32(s ** 2), min=0.0)
        got = filters.maximum_filter(log_resp, 3).numpy()
        # compared as values: the clamp at 0 keeps -0 where XLA's max gives +0
        np.testing.assert_array_equal(got, seen[i], err_msg=f"scale {i}")
