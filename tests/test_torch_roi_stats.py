"""The tracker's ROI statistics: the port's plain body against the JAX
package, and the ROI-statistics kernel's schedule in torch against the
plain body.

``moments.masked_mean_variance_plain`` (the CPU path of
``masked_mean_variance``) on the ROIs that the port's
``hu_tracking._roi_features_kernel`` cuts equals the statistics of the
reference's jitted ``_roi_features_kernel`` on the same frames, bit for bit
(the reference program sums each ROI in raster order; a standalone
``jax.jit(masked_mean_variance)`` of ROIs of 4,096 voxels reduces in
another order, so it is not the yardstick).  ``roi_stats_model``
(``kernels/csrc/roi_stats.cu``'s schedule in torch: a lane an ROI, its
voxels staged in chunks of at most 1,024, each chunk's 16-byte aligned
middle by a bulk copy placed 16-byte aligned and the up to 3 voxels around
it by the lane; over the voxels in raster order the sum of x as float32
adds and the sum of squares as a float64 term added to the float32 sum and
rounded once, terms dropped until the first normal one unless the sum is
nonzero at the start of a block of 4,096 voxels, then the flushed mean and
variance) equals the plain body: the 3D main path's 16^3 ROIs, the 2D
path's 20^2, 20^3 ROIs (past one block of voxels), dim frames whose sums
stay subnormal, frames of voxels about the smallest normal float32 (the
reference reads a subnormal voxel as zero: it neither counts nor adds),
empty ROIs, and (against the plain body only) signed voxels whose sum
cancels to zero at a block's end, 17^3 and 9^3 ROIs (every other ROI
starts off 16 bytes), ROIs from a base off 16 bytes, 40^3 ROIs (past
shared memory: 63 chunks, the last short) and ROI counts below and above
the SMs.  A ``hypothesis`` test holds the float32 add
chain to the plain body's widened sum of x (a float64 term added to the
float32 sum) bit for bit on adversarial ROIs: signed voxels cancelling to
0 at a block's end, subnormal and near-``FLT_MIN`` voxels, exponent gaps
past 2^29 and more than one block of 4,096 voxels.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from nellie_tpu.stages import hu_tracking as j_tracking
from nellie_tpu_torch.kernels import moments
from nellie_tpu_torch.stages import hu_tracking
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

TINY = float(np.finfo(np.float32).tiny)
VOXEL_BLOCK = 4096


def flush(x):
    return torch.where(x.abs() < TINY, x * 0.0, x)


SMS = 132  # the H100's SMs
MAX_ROIS = 12  # roi_stats.cu: lanes of a block that take an ROI
CHUNK = 1024  # roi_stats.cu: voxels of an ROI in one stage, at most


def roi_plan(n_roi, voxels, sms=SMS):
    """(ROIs a block, voxels a chunk, floats of a lane's buffer) of a
    launch, as ``roi_stats`` chooses them."""
    per_block = min(MAX_ROIS, -(-n_roi // sms))
    chunk = max(1, min(CHUNK, voxels))
    return per_block, chunk, -(-chunk // 4) * 4 + 4


def stage_chunk(flat, start, length, base, lane_floats):
    """A lane's buffer after ``stage_chunk``: voxels [start, start +
    length) of ``flat`` at byte address ``base + 4 * start``; the 16-byte
    aligned middle by one bulk copy that must land 16-byte aligned, the
    voxels around it by the lane.  Returns (buffer, shift)."""
    buf = np.full(lane_floats, np.nan, np.float32)
    lead = (16 - (base + 4 * start) % 16) % 16 // 4
    shift = (4 - lead) % 4
    head = min(lead, length)
    body = (length - head) // 4 * 4
    if body:
        assert (base + 4 * (start + head)) % 16 == 0 and (shift + head) % 4 == 0
        buf[shift + head:shift + head + body] = flat[start + head:start + head + body]
    buf[shift:shift + head] = flat[start:start + head]
    buf[shift + head + body:shift + length] = flat[start + head + body:start + length]
    assert shift + length <= lane_floats
    return buf, shift


def roi_stats_model(images, base=0, sms=SMS):
    """``roi_stats.cu`` in torch on the CPU, the ROIs' array at byte
    address ``base`` (a multiple of 4): each ROI's chunks staged as its
    lane stages them, then the two chains of every ROI side by side, one
    voxel a step."""
    n = images.shape[0]
    flat = images.reshape(-1).float().numpy()
    voxels = flat.size // max(n, 1)
    _, chunk, lane_floats = roi_plan(n, voxels, sms)
    acc = torch.zeros(n, dtype=torch.float32)
    acc_sq = torch.zeros(n, dtype=torch.float32)
    keep = torch.zeros(n, dtype=torch.bool)
    keep_sq = torch.zeros(n, dtype=torch.bool)
    count = torch.zeros(n, dtype=torch.int64)
    for c0 in range(0, voxels, chunk):
        length = min(chunk, voxels - c0)
        staged = []
        for roi in range(n):
            buf, shift = stage_chunk(flat, roi * voxels + c0, length, base, lane_floats)
            staged.append(buf[shift:shift + length])
        x = torch.from_numpy(np.stack(staged))
        x = torch.where(x.abs() < TINY, 0.0, x)  # subnormal voxels read as zero
        if c0 % VOXEL_BLOCK == 0:  # a chunk divides 4,096 or is the whole ROI
            keep, keep_sq = acc != 0, acc_sq != 0
        for j in range(length):
            v = x[:, j]
            keep = keep | (v >= TINY)
            acc = acc + torch.where(keep, v, 0.0)  # float32 adds
            w = v.double()
            keep_sq = keep_sq | ((w * w).float() >= TINY)
            acc_sq = (acc_sq.double() + torch.where(keep_sq, w * w, 0.0)).float()
            count += v != 0
    safe = torch.where(count == 0, 1, count).float()
    mean = flush(acc / safe)
    var = flush(flush(acc_sq - flush(flush(acc * acc) / safe)) / safe)
    zero = count == 0
    return torch.stack([torch.where(zero, 0.0, mean), torch.where(zero, 0.0, var)], dim=1)


def widened_sum(x):
    """The plain body's sum of x: a float64 term added to the float32 sum
    and rounded once, voxel by voxel, terms dropped until the first normal
    one unless the sum is nonzero at the start of a block of 4,096."""
    x = torch.where(x.abs() < TINY, 0.0, x.float())
    acc = torch.zeros(x.shape[0], dtype=torch.float32)
    for start in range(0, x.shape[1], VOXEL_BLOCK):
        wide = x[:, start:start + VOXEL_BLOCK].T.double()
        normal = torch.cummax((wide.float() >= TINY).int(), dim=0).values.bool()
        wide = torch.where(normal | (acc != 0), wide, 0.0)
        for k in range(wide.shape[0]):
            acc.add_(wide[k])
    return acc


def float32_chain(x):
    """``roi_stats.cu``'s sum of x: float32 adds under the same rule."""
    x = torch.where(x.abs() < TINY, 0.0, x.float())
    acc = torch.zeros(x.shape[0], dtype=torch.float32)
    keep = torch.zeros(x.shape[0], dtype=torch.bool)
    for k in range(x.shape[1]):
        if k % VOXEL_BLOCK == 0:
            keep = acc != 0
        keep = keep | (x[:, k] >= TINY)
        acc = acc + torch.where(keep, x[:, k], 0.0)
    return acc


def frames(ndim, seed, scale=500.0):
    """(intensity, frangi) frames of floats with a zero corner."""
    rng = np.random.default_rng(seed)
    shape = (24, 40, 40) if ndim == 3 else (64, 64)
    out = []
    for _ in range(2):
        x = (rng.random(shape) * scale * (rng.random(shape) < 0.6)).astype(np.float32)
        x[(slice(0, 4),) * ndim] = 0
        out.append(x)
    return out


def markers(ndim, n, r, seed):
    """(coords, radii): ``n`` markers with radii up to about r / 2, the
    first in the zero corner with radius 0 (an empty ROI)."""
    rng = np.random.default_rng(seed)
    shape = (24, 40, 40) if ndim == 3 else (64, 64)
    coords = np.stack([rng.integers(0, s, n) for s in shape], 1).astype(np.int32)
    coords[0] = 1
    radii = (rng.random(n) * (r / 2 - 1)).astype(np.float32)
    radii[0] = 0
    return coords, radii


def reference_and_cubes(ndim, r, seed, scale=500.0, n=12):
    """The reference's ROI statistics (n, 4) from its jitted
    ``_roi_features_kernel``, and the (2 n, r^d) ROIs the port's
    ``_roi_features_kernel`` hands ``masked_mean_variance`` on the same
    frames and markers."""
    intensity, frangi_im = frames(ndim, seed, scale)
    coords, radii = markers(ndim, n, r, seed)
    pad = [(r, r)] * ndim
    ipad, fpad = (np.pad(x, pad) for x in (intensity, frangi_im))
    fn = jax.jit(j_tracking._roi_features_kernel, static_argnames=("r", "no_z"))
    want, _ = fn(jnp.asarray(ipad), jnp.asarray(fpad), jnp.asarray(coords), jnp.asarray(radii),
                 jnp.ones(n, bool), r=r, no_z=ndim == 2)
    seen = []
    original = moments.masked_mean_variance
    moments.masked_mean_variance = lambda x: seen.append(x) or original(x)
    try:
        hu_tracking._roi_features_kernel(torch.from_numpy(ipad), torch.from_numpy(fpad),
                                         torch.from_numpy(coords).long(),
                                         torch.from_numpy(radii), r)
    finally:
        moments.masked_mean_variance = original
    return np.asarray(want), seen[0]


# (ndim, r, scale): the 3D main path's 16^3 ROIs and the 2D path's 20^2,
# 20^3 (past one block of 4,096 voxels), dim frames whose squares are
# subnormal, and frames of voxels about the smallest normal float32
CASES = {
    "3d_16": (3, 16, 500.0),
    "2d_20": (2, 20, 500.0),
    "3d_20": (3, 20, 500.0),
    "dim": (3, 12, 1e-20),
    "dimmer": (2, 12, 3e-38),
}


def signed_rois():
    """ROIs of 17^3 whose first 4,096 voxels cancel exactly to 0 (a normal
    voxel and its negation), then dim ones: the second block starts from a
    zero sum after normal terms."""
    rng = np.random.default_rng(6)
    x = np.zeros((6, 17 ** 3), np.float32)
    x[:, 10] = 3.0
    x[:, 20] = -3.0
    x[:, VOXEL_BLOCK:] = (rng.random((6, 17 ** 3 - VOXEL_BLOCK)) * 1e-39).astype(np.float32)
    x[:, VOXEL_BLOCK + 50] = 1.0
    return x.reshape(6, 17, 17, 17)


def uniform_rois(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * 500 * (rng.random(shape) < 0.4)).astype(np.float32)
    x[0] = 0
    return x


# (ROIs, byte address of the first mod 16, SMs) against the plain body only:
# odd ROIs of 17^3 and 9^3 start off 16 bytes, a base off 16 bytes, ROIs
# past shared memory (63 chunks a lane), and ROIs below and above the SM
# count (one ROI a block, twelve a block)
STAGING = {
    "17^3 misaligned": (lambda: uniform_rois((5, 17, 17, 17), 7), 0, SMS),
    "9^3 from base + 4": (lambda: uniform_rois((7, 9, 9, 9), 8), 4, SMS),
    "20^2 from base + 12": (lambda: uniform_rois((9, 20, 20), 9), 12, SMS),
    "40^3 past shared memory": (lambda: uniform_rois((2, 40, 40, 40), 10), 8, SMS),
    "below the SMs": (lambda: uniform_rois((5, 5, 5, 5), 11), 0, 8),
    "above the SMs": (lambda: uniform_rois((40, 5, 5), 12), 0, 2),
}


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    """{case: (ROIs, plain, model, the reference's statistics or None)}."""
    out = {}
    for k, (name, (ndim, r, scale)) in enumerate(CASES.items()):
        want, cubes = reference_and_cubes(ndim, r, seed=k, scale=scale)
        out[name] = (cubes, moments.masked_mean_variance_plain(cubes), roi_stats_model(cubes),
                     want)
    t = torch.from_numpy(signed_rois())
    out["signed"] = (t, moments.masked_mean_variance_plain(t), roi_stats_model(t), None)
    for name, (make, base, sms) in STAGING.items():
        t = torch.from_numpy(make())
        out[name] = (t, moments.masked_mean_variance_plain(t), roi_stats_model(t, base, sms),
                     None)
    return out


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(CASES) + ["signed"] + list(STAGING))
def test_model_equals_plain(runs, name):
    _, plain, model, _ = runs[name]
    np.testing.assert_array_equal(bits(model), bits(plain))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_reference(runs, name):
    cubes, plain, _, want = runs[name]
    n = cubes.shape[0] // 2
    np.testing.assert_array_equal(bits(torch.cat([plain[:n], plain[n:]], dim=1)), bits(want))
    assert cubes.shape[1:] == (CASES[name][1],) * CASES[name][0]
    assert (plain[0] == 0).all() and (plain[n] == 0).all()  # the empty ROIs


def test_dim_sums_stay_subnormal(runs):
    """The dim cases reach the flush rule: squares below the smallest
    normal float32, so sums of squares dropped whole, and (``dimmer``)
    subnormal voxels beside normal ones."""
    for name in ("dim", "dimmer"):
        cubes = runs[name][0].reshape(runs[name][0].shape[0], -1).double()
        assert ((cubes * cubes).float() < TINY).all()
    assert (runs["dimmer"][1][:, 1] == 0).all()
    x = runs["dimmer"][0].reshape(runs["dimmer"][0].shape[0], -1)
    assert ((x > 0) & (x < TINY)).any() and (x >= TINY).any()
    assert (runs["dimmer"][1][1:, 0] != 0).any()


def test_cpu_tensor_takes_the_plain_body(runs):
    t, plain, _, _ = runs["2d_20"]
    before = moments.ROI_STATS_KERNEL.launches
    np.testing.assert_array_equal(bits(moments.masked_mean_variance(t)), bits(plain))
    assert moments.ROI_STATS_KERNEL.launches == before


def test_kernel_refuses_cpu_tensors(runs):
    with pytest.raises(TypeError):
        moments.ROI_STATS_KERNEL(runs["2d_20"][0])


def test_staging_plans():
    """The cases reach what the staging must handle: ROIs that start off
    16 bytes, chunks shorter than the lead to 16 bytes, ROIs of several
    chunks with a short last one, one ROI a block and twelve."""
    assert roi_plan(5, 17 ** 3) == (1, CHUNK, CHUNK + 4)
    assert (17 ** 3 * 4) % 16 and (9 ** 3 * 4) % 16
    assert roi_plan(2, 40 ** 3)[1] == CHUNK and 40 ** 3 * 4 > 232448 and 40 ** 3 % CHUNK
    assert roi_plan(40, 25, sms=2) == (12, 25, 32)
    assert roi_plan(676, 4096) == (6, CHUNK, CHUNK + 4) and roi_plan(2048, 400)[0] == 12
    buf, shift = stage_chunk(np.arange(8, dtype=np.float32), 1, 2, 0, 8)
    assert shift == 1 and buf[1:3].tolist() == [1.0, 2.0]


@st.composite
def adversarial_rois(draw):
    """(8, voxels) float32 ROIs from a drawn seed and recipe: normal,
    signed, near-``FLT_MIN`` and subnormal voxels, magnitudes 2^30 and
    more apart, zeros, and (``cancel``) a first block of 4,096 made of
    pairs a, -a, whose sum is 0 after every pair."""
    seed = draw(st.integers(0, 2 ** 32 - 1))
    voxels = draw(st.sampled_from([64, 4096, 4097, 6000, 8192, 9000]))
    kinds = draw(st.lists(st.sampled_from(["normal", "signed", "near_min", "subnormal", "gap",
                                           "zero"]), min_size=1, max_size=4))
    cancel = draw(st.booleans())
    rng = np.random.default_rng(seed)
    x = np.zeros((8, voxels), np.float32)
    for kind in kinds:
        at = rng.random((8, voxels)) < rng.uniform(0.05, 0.9)
        sign = np.where(rng.random((8, voxels)) < 0.5, -1.0, 1.0)
        v = {"normal": rng.random((8, voxels)) * 10.0 ** rng.uniform(-3, 3),
             "signed": sign * rng.random((8, voxels)) * 10.0 ** rng.uniform(-3, 3),
             "near_min": sign * rng.uniform(0.25, 4.0, (8, voxels)) * TINY,
             "subnormal": sign * rng.random((8, voxels)) * TINY,
             "gap": np.where(rng.random((8, voxels)) < 0.5, 2.0 ** rng.integers(20, 40),
                             2.0 ** -rng.integers(0, 20)),
             "zero": np.zeros((8, voxels))}[kind]
        x = np.where(at, v, x).astype(np.float32)
    if cancel and voxels >= VOXEL_BLOCK:
        a = (rng.random((8, VOXEL_BLOCK // 2)) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
        x[:, 0:VOXEL_BLOCK:2], x[:, 1:VOXEL_BLOCK:2] = a, -a
    return x


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(adversarial_rois())
def test_float32_chain_is_the_widened_sum(x):
    """Figueroa: with float32 acc and x, fl32(fl64(acc + x)) = fl32(acc +
    x), since 53 >= 2 * 24 + 2; the kernel's float32 add chain equals the
    plain body's widened sum of x bit for bit."""
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(bits(float32_chain(t)), bits(widened_sum(t)))


def test_widened_sum_is_the_plain_bodys():
    """``widened_sum`` is the plain body's sum: its mean times the count,
    where that division is exact, on ROIs of whole numbers."""
    x = np.arange(2 * 5000, dtype=np.float32).reshape(2, 5000) % 7
    t = torch.from_numpy(x)
    count = (t != 0).sum(dim=1).float()
    assert torch.equal(widened_sum(t) / count, moments.masked_mean_variance_plain(t)[:, 0])
