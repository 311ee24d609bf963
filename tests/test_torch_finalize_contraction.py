"""The Filter finalize's threshold in the form each opening term takes.

The 1st percentile's last step, s[lo] (1 - frac) + s[hi] frac, rounds once
as A = fma(s[lo], 1 - frac, s[hi] frac) or B = fma(s[hi], frac,
s[lo] (1 - frac)), and XLA contracts a different product in different
fusions of one program (``scripts/xla_finalize_contractions.py`` reads each
fusion's form off its machine code; ``frangi.FINALIZE_FORMS`` holds the
table).  The frames here are built as that script builds them: a strided
sample (every second voxel on each axis, the finalize's at these shapes)
of values in [5, 6), some of them 0, whose percentile gives A != B (one
frame with A < B, one with A > B), and crosses of 7 (5 in 2D) voxels
centred on voxels the sample never reads.  The opening keeps a cross
exactly when its centre's erosion does, so a cross whose voxels all lie
above both forms is kept, one at min(A, B) dropped, and one whose single
voxel at max(A, B) is read by one term of that erosion (its centre, or one
arm) shows that term's form alone.  Each frame holds every such cross.

The port's ``finalize_frame`` and ``mask_volume`` equal the reference's
jitted ones bit for bit at 64 x 128 x 128 and 1024 x 1024 (the fusion
plan of the main 3D frames and the main 2D frame itself), and every cross
is kept or dropped as the table says.  The port's mesh Filter
(``batched_filter_kernel`` over two logical shards) equals the reference's
vmapped ``batched_filter_kernel`` on the same frames, both with the
vesselness replaced by the frame itself (the script reads that program's
forms too).  Capacity's monolithic ``_segment_from_vessel`` (its flat
sample every second voxel, at 16 x 64 x 64 and 128 x 128, where the script
reads the main shapes' forms) equals the reference's on a block whose
opening the side terms' form decides: its even columns far above every
threshold, its odd ones, which the flat sample never reads, at
max(A, B).  Every voxel of the block has an odd neighbour, so the erosion
is empty when the side terms compare with max(A, B) and the block is gone;
otherwise it is kept.  Capacity's chunked opening (``binary_opening`` of
the frame above ``frangi.masked_percentile``, form B) equals the
reference's ``_m1o_window`` with the value of ``_pct_from_sample``.  A port
that compared every term with A fails wherever the table gives B.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.mesh import sharded as j_sharded
from nellie_tpu.pipeline import capacity as j_capacity
from nellie_tpu_torch.kernels import filters, frangi
from nellie_tpu_torch.mesh import sharded as msh
from nellie_tpu_torch.pipeline import capacity
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def frames():
    return {(ndim, a_less): chip_smoke.finalize_cross_frame(ndim, a_less)
            for ndim in (3, 2) for a_less in (True, False)}


CASES = [(ndim, a_less) for ndim in (3, 2) for a_less in (True, False)]


def _ids(case):
    return f"{case[0]}D, A {'<' if case[1] else '>'} B"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_percentile_forms(case, frames):
    """The frame's sample gives the two forms the cross values are set to."""
    frame, a, b, _ = frames[case]
    sample = torch.from_numpy(frame)[tuple(slice(None, None, 2) for _ in frame.shape)]
    got = frangi.masked_percentile_forms(sample, sample > 0, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.array([a, b], np.float32).view(np.int32))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_finalize_against_reference(case, frames):
    """finalize_frame and mask_volume equal the reference's bit for bit,
    and each cross is kept or dropped as the table says."""
    frame, a, b, crosses = frames[case]
    want = np.asarray(j_frangi.finalize_frame(jnp.asarray(frame)))
    got = frangi.finalize_frame(torch.from_numpy(frame)).numpy()
    for name, (centre, kept) in crosses.items():
        assert (want[centre] != 0) == kept, (name, "reference")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want_mv = np.asarray(j_frangi.mask_volume(jnp.asarray(frame)))
    got_mv = frangi.mask_volume(torch.from_numpy(frame)).numpy()
    np.testing.assert_array_equal(got_mv.view(np.int32), want_mv.view(np.int32))


def _mesh_params(ndim, module):
    return module.FrangiParams(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2)[-ndim:],
                               z_ratio=2.5 if ndim == 3 else 1.0)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mesh_finalize(case, frames, monkeypatch):
    """The port's mesh Filter over two logical shards equals the reference's
    vmapped ``batched_filter_kernel`` bit for bit, both with the vesselness
    the frame itself (and the 2D blobness 0), and the port's one-device
    finalize."""
    frame, _, _, crosses = frames[case]
    monkeypatch.setattr(j_frangi, "vesselness_frame", lambda f, params, apply_mask=True: (f, None))
    monkeypatch.setattr(j_frangi, "log_blobness_2d",
                        lambda f, m, params: jnp.zeros(f.shape, jnp.float32))
    reference = jax.jit(j_sharded.batched_filter_kernel.__wrapped__,
                        static_argnames=("params", "apply_mask", "max_samples", "remove_edges"))
    want = np.asarray(reference(jnp.asarray(frame)[None], _mesh_params(frame.ndim, j_frangi),
                                True, int(1e6), False))[0]
    monkeypatch.setattr(msh, "vesselness_shards",
                        lambda raw, plan, params, apply_mask=True, blob=False: (raw, None))
    mesh = msh.make_mesh(devices=[torch.device("cpu")] * 2)
    got = msh.batched_filter_kernel([frame], _mesh_params(frame.ndim, frangi), True, int(1e6),
                                    False, mesh)[0].numpy()
    for name, (centre, kept) in crosses.items():
        assert (want[centre] != 0) == kept, (name, "reference")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    one = frangi.finalize_frame(torch.from_numpy(frame)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), one.view(np.int32))


CAPACITY_SHAPES = {3: (16, 64, 64), 2: (128, 128)}
CAPACITY_STEP = 2  # the flat sample: the even columns (the last axis is even)


def capacity_block_frame(ndim: int, a_less: bool):
    """A volume for capacity's ``_segment_from_vessel`` with the flat sample
    every second voxel: values in [5, 6), a fifth of them 0, on the even
    columns (the sample) outside two blocks, whose 1st percentile's forms
    differ (A < B when ``a_less``; seeds searched in order); a solid anchor
    block of values log-uniform in [10, 1000], which gives the Label
    threshold whatever happens to the other; and a test block whose even
    columns hold 10^4 and whose odd ones max(A, B).  Returns (volume, the
    test block's inner box, whether the table keeps the test block: its
    side terms compare with min(A, B))."""
    shape = CAPACITY_SHAPES[ndim]
    lead = (slice(2, shape[0] - 2),) if ndim == 3 else ()
    rows = shape[-2]
    test = lead + (slice(4, rows // 2 - 4), slice(4, shape[-1] - 4))
    anchor = lead + (slice(rows // 2 + 4, rows - 4), slice(4, shape[-1] - 4))
    seed = 0
    while True:
        rng = np.random.default_rng(seed)
        volume = np.zeros(shape, np.float32)
        volume[..., ::2] = rng.uniform(5, 6, volume[..., ::2].shape)
        volume[..., ::2][rng.random(volume[..., ::2].shape) < 0.2] = 0
        volume[test] = 0
        volume[test][..., ::2] = 1e4
        volume[anchor] = 10 ** rng.uniform(1, 3, volume[anchor].shape)
        a, b = chip_smoke.percentile_forms_of(volume.reshape(-1)[::CAPACITY_STEP])
        if a != b and (a < b) == a_less:
            break
        seed += 1
    volume[test][..., 1::2] = max(a, b)
    side = {frangi.A: a, frangi.B: b}[frangi.FINALIZE_FORMS[ndim][1]]
    inner = tuple(slice(s.start + 2, s.stop - 2) for s in test)
    return volume, inner, bool(side < max(a, b))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_capacity_monolith(case):
    """Capacity's ``_segment_from_vessel`` (emit "mask": the packed Label
    mask and its count) equals the reference's bit for bit, and the test
    block is kept or dropped as the table says."""
    ndim, a_less = case
    volume, inner, kept = capacity_block_frame(ndim, a_less)
    packed, count = j_capacity._segment_from_vessel(jnp.asarray(volume), 10, True, CAPACITY_STEP,
                                                    256, int(1e6), "mask")
    want = np.unpackbits(np.asarray(packed), axis=-1).astype(bool)
    assert bool(want[inner].any()) == kept and int(count) == int(want.sum())
    got_packed, got_count = capacity._segment_from_vessel(torch.from_numpy(volume), 10, True,
                                                          CAPACITY_STEP, 256, "mask")
    np.testing.assert_array_equal(got_packed.numpy(), np.asarray(packed))
    assert got_count == int(count)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_capacity_chunked_opening(case, frames):
    """Capacity's chunked strategy: the opening of ``vessel > pct`` with the
    value of the reference's ``_pct_from_sample`` (form B) in every term,
    against its ``_m1o_window`` over the whole volume."""
    frame, _, _, crosses = frames[case]
    sample = frame[tuple(slice(None, None, 2) for _ in frame.shape)].reshape(-1)
    pct = j_capacity._pct_from_sample(jnp.asarray(sample))
    zeros = (0,) * frame.ndim
    want = np.asarray(j_capacity._m1o_window(
        jnp.zeros(frame.shape, bool), jnp.asarray(frame), pct, jnp.asarray(zeros, jnp.int32),
        jnp.asarray(zeros, jnp.int32), jnp.asarray(zeros, jnp.int32), ext_shape=frame.shape,
        core_shape=frame.shape))
    ts = torch.from_numpy(sample)
    b = frangi.masked_percentile(ts, ts > 0, 1.0)
    assert np.float32(pct).view(np.int32) == b.numpy().view(np.int32)
    got = filters.binary_opening(torch.from_numpy(frame) > b).numpy()
    np.testing.assert_array_equal(got, want)
    for name, (centre, _) in crosses.items():
        if name.startswith("all"):
            assert got[centre] == (frame[centre] > b.numpy()), name
