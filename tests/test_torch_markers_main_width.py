"""Markers' LoG at the main width, against the reference's jitted program.

At a last axis of 256 (the 3D main frames) XLA computes each scale's LoG as
the plain sequence of its axis-0, axis-1 and axis-2 passes.  At 5 px the
second scale's axis-0 order-2 pass has three taps and a negative centre
weight; where the clamped distance is computed inline its centre is a select
whose other arm is -0, and on AVX-512 LLVM folds that select into the
pass's first add in the vector loop, so neither product of the first add is
contracted there, while the scalar loops (the reflected rows of the padded
copies, and the last axis's remainder columns) contract tap 0
(``filters.log_program``, ``scripts/xla_markers_machine_code.py``).  Each
scale's maximum filter and the markers equal the reference's, bit for bit,
on a frame of 16 x 128 x 256 and on a short Z at that width, where XLA
generates AVX-512 code (skipped elsewhere: ``torch_port_data.needs_avx512``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from nellie_tpu.stages import mocap_marking as j_markers
from nellie_tpu_torch.kernels import filters
from nellie_tpu_torch.kernels._fp import f32
from nellie_tpu_torch.stages import mocap_marking as markers
from test_torch_log_programs import _marker_params, _reference_max_filters
from torch_port_data import needs_avx512
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = needs_avx512

SHAPES = [(16, 128, 256), (5, 64, 256)]


@pytest.fixture(scope="module")
def runs():
    """{shape: (raw, mask, the reference's outputs, each scale's maximum
    filter read out of its program)} at 5 px."""
    out = {}
    for shape in SHAPES:
        frame = chip_smoke.filter_frame(shape, seed=0)
        raw, mask = np.clip(frame, 0, 65535).astype(np.uint16), frame > 300
        params = _marker_params(j_markers, 5.0)
        want = j_markers.markers_frame_distance(jnp.asarray(raw), jnp.asarray(mask), params)
        got, seen = _reference_max_filters(raw, mask, params)
        for w, o in zip(want, got):  # the read-out leaves the outputs as they were
            np.testing.assert_array_equal(np.asarray(w), np.asarray(o))
        out[shape] = (raw, mask, [np.asarray(w) for w in want], seen)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scale", range(5))
def test_max_filter_at_main_width(runs, shape, scale):
    _, mask, _, seen = runs[shape]
    params = _marker_params(markers, 5.0)
    distance = markers._clamped_distance(torch.from_numpy(mask), params)
    s = params.sigmas[scale]
    log_resp = torch.clamp(-filters.log_program(distance, params.sigma_vec(s),
                                                sunk_centre=True) * f32(s ** 2), min=0.0)
    np.testing.assert_array_equal(filters.maximum_filter(log_resp, 3).numpy(), seen[scale])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_markers_at_main_width(runs, shape):
    raw, mask, want, _ = runs[shape]
    got = markers.markers_frame_distance(torch.from_numpy(raw.astype(np.int32)),
                                         torch.from_numpy(mask), _marker_params(markers, 5.0))
    assert want[0].sum() > 0
    for name, w, g in zip(("marker", "distance", "border"), want, got):
        np.testing.assert_array_equal(w.view(np.uint8), g.numpy().view(np.uint8), err_msg=name)
