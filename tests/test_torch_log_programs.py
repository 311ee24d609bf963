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

Markers' own program (``markers_frame_distance``, the stage's default, and
``markers_frame`` on a float base) on ``filter_frame`` masks at Z of 3 to 9,
radii 5 and 10 px: its LoG as the program's maximum filters read it
(``filters.log_program(sunk_centre=True)``, held to the reference's filters
read out of its program; at the second scale at 5 px, whose axis-0
order-2 pass has three taps and a negative centre, the vector loop folds
the select into the first add and contracts neither product, the scalar
loops contract tap 0: ``scripts/xla_markers_machine_code.py``; XLA's
AVX-512 code, so those cases skip where XLA generates other code,
``torch_port_data.needs_avx512``), and its
markers, which the peak fusion decides from each
scale's LoG recomputed at the voxel, where an axis-0 order-0 pass of three
taps contracts its centre and rounds tap 0 (``log_program(peak=True)``,
``scripts/xla_markers_probe.py``).
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


# a scan of Z 3, 5, 9, seeds 3, 5, 9 and radii 5 and 10 px, and two frames
# found before it; before the peak fusion's rule (filters.log_program's
# ``peak``) nine of them marked 1-2 voxels otherwise than the reference
SCAN = [(z, seed, r) for z in (3, 5, 9) for seed in (3, 5, 9) for r in (5.0, 10.0)] + [
    (5, 105, 5.0), (9, 109, 10.0)]


def _markers_inputs(z, seed):
    frame = chip_smoke.filter_frame((z, 48, 48), seed=seed)
    return np.clip(frame, 0, 65535).astype(np.uint16), frame > 300


@pytest.mark.parametrize("z,seed,max_radius_px", SCAN)
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


@pytest.fixture(scope="module")
def reference_max_filters():
    """{(z, seed, radius): each scale's maximum filter read out of the
    reference's program}, the program's outputs held to the reference's."""
    out = {}
    for z, seed in ((3, 5), (5, 3), (9, 109)):
        raw, mask = _markers_inputs(z, seed)
        for radius in (10.0, 5.0):
            params = _marker_params(j_markers, radius)
            want = j_markers.markers_frame_distance(jnp.asarray(raw), jnp.asarray(mask), params)
            got, seen = _reference_max_filters(raw, mask, params)
            for w, o in zip(want, got):  # the read-out leaves the outputs as they were
                np.testing.assert_array_equal(np.asarray(w), np.asarray(o))
            out[(z, seed, radius)] = seen
    return out


@pytest.mark.parametrize("z,seed,radius,scale", [
    pytest.param(z, seed, radius, scale, marks=D.needs_avx512) if (radius, scale) == (5.0, 1)
    else (z, seed, radius, scale)
    for z, seed in ((3, 5), (5, 3), (9, 109)) for radius in (10.0, 5.0) for scale in range(5)])
def test_markers_log_as_its_max_filters_read_it(reference_max_filters, z, seed, radius, scale):
    """In Markers' program the clamped distance is a select computed
    inline; where a pad fusion reads it once, LLVM multiplies inside the
    select and the axis-0 centre is rounded, not contracted
    (``filters.log_program(sunk_centre=True)``).  Each scale's maximum
    filter of the port's LoG equals the one the reference's program
    computes, bit for bit, at radii of 10 and 5 px (five scales each)."""
    _, mask = _markers_inputs(z, seed)
    params = _marker_params(markers, radius)
    distance = markers._clamped_distance(torch.from_numpy(mask), params)
    s = params.sigmas[scale]
    log_resp = torch.clamp(-filters.log_program(distance, params.sigma_vec(s),
                                                sunk_centre=True) * f32(s ** 2), min=0.0)
    got = filters.maximum_filter(log_resp, 3).numpy()
    # compared as values: the clamp at 0 keeps -0 where XLA's max gives +0
    np.testing.assert_array_equal(got, reference_max_filters[(z, seed, radius)][scale])


@pytest.fixture(scope="module")
def wide_max_filters():
    """{shape: each scale's maximum filter read out of the reference's
    program} at 5 px on frames whose last axis plus a scale's radius
    crosses 128 (122: the largest scale only; 130: every scale)."""
    out = {}
    for shape in ((3, 24, 122), (3, 24, 130)):
        frame = chip_smoke.filter_frame(shape, seed=3)
        raw, mask = np.clip(frame, 0, 65535).astype(np.uint16), frame > 300
        out[shape] = (mask, _reference_max_filters(raw, mask, _marker_params(j_markers, 5.0))[1])
    return out


@pytest.mark.parametrize("shape,scale", [
    pytest.param(shape, scale, marks=D.needs_avx512) if scale == 1 else (shape, scale)
    for shape in ((3, 24, 122), (3, 24, 130)) for scale in range(5)])
def test_markers_log_past_the_fused_padding(wide_max_filters, shape, scale):
    """Where the last axis and a scale's radius reach 128, XLA does not fuse
    the last axis's padding into the last fusion and the LoG is the plain
    sequence of passes (``filters.log_program``); each scale's maximum
    filter equals the reference's (at 122, the second scale's last two
    columns are the scalar loop's)."""
    mask, seen = wide_max_filters[shape]
    params = _marker_params(markers, 5.0)
    distance = markers._clamped_distance(torch.from_numpy(mask), params)
    s = params.sigmas[scale]
    log_resp = torch.clamp(-filters.log_program(distance, params.sigma_vec(s),
                                                sunk_centre=True) * f32(s ** 2), min=0.0)
    np.testing.assert_array_equal(filters.maximum_filter(log_resp, 3).numpy(), seen[scale])


# one frame for each Z and radius of the scan, on a float base
FLOAT_BASE = [(3, 3, 5.0), (3, 5, 10.0), (5, 9, 5.0), (5, 3, 10.0), (9, 3, 5.0), (9, 9, 10.0)]


@pytest.mark.parametrize("z,seed,max_radius_px", FLOAT_BASE)
def test_markers_program_on_a_float_base(z, seed, max_radius_px):
    """``markers_frame`` with a float base (the stage's ``use_im="frangi"``):
    its peak fusion swaps the three-tap axis-0 pass's first add as the
    distance program's does; the markers, distance and border equal the
    reference's (3, 3, 5 px differed in 2 voxels before the rule)."""
    raw, mask = _markers_inputs(z, seed)
    base = chip_smoke.filter_frame((z, 48, 48), seed=seed + 1, smooth=True).astype(np.float32)
    want = j_markers.markers_frame(jnp.asarray(raw), jnp.asarray(mask), jnp.asarray(base),
                                   _marker_params(j_markers, max_radius_px))
    got = markers.markers_frame(torch.from_numpy(raw.astype(np.int32)), torch.from_numpy(mask),
                                torch.from_numpy(base), _marker_params(markers, max_radius_px))
    assert np.asarray(want[0]).sum() > 0
    for name, w, g in zip(("marker", "distance", "border"), want, got):
        np.testing.assert_array_equal(np.asarray(w).view(np.uint8), g.numpy().view(np.uint8),
                                      err_msg=name)


def test_peak_value_differs_only_for_three_axis0_taps():
    """``log_program(peak=True)``: the peak fusion's value is the program's
    own tensor unless the axis-0 order-0 kernel has three nonzero taps (and
    the last fusion exists), and then differs from it only by the rounding
    of that pass."""
    d = torch.from_numpy(np.abs(chip_smoke.filter_frame((5, 24, 24), seed=2)) / 100)
    program, inline = filters.log_program(d, (0.5 / 2.5, 0.5, 0.5), peak=True)
    assert inline is not program and torch.equal(
        program, filters.log_program(d, (0.5 / 2.5, 0.5, 0.5)))
    assert 0 < int((inline != program).sum()) and torch.allclose(inline, program, rtol=1e-5,
                                                                 atol=1e-5)
    program, inline = filters.log_program(d, (1.2 / 2.5, 1.2, 1.2), peak=True)
    assert inline is program
    program, inline = filters.log_program(d[0], (0.5, 0.5), peak=True)
    assert inline is program
    wide = torch.from_numpy(np.abs(chip_smoke.filter_frame((3, 8, 130), seed=2)) / 100)
    program, inline = filters.log_program(wide, (0.5 / 2.5, 0.5, 0.5), peak=True)
    assert inline is program
