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
(``kernels/csrc/roi_stats.cu``'s schedule in torch: one chain an (ROI, sum)
over the voxels in raster order, a float64 term added to the float32 sum
and rounded once, terms dropped until the first normal one unless the sum
is nonzero at the start of a block of 4,096 voxels, then the flushed mean
and variance) equals the plain body: the 3D main path's 16^3 ROIs, the 2D
path's 20^2, 20^3 ROIs (past one block of voxels), dim frames whose sums
stay subnormal, frames of voxels about the smallest normal float32 (the
reference reads a subnormal voxel as zero: it neither counts nor adds),
empty ROIs, and (against the plain body only) signed voxels whose sum
cancels to zero at a block's end.
"""
import numpy as np
import pytest
import torch

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


def roi_stats_model(images):
    """``roi_stats.cu`` in torch on the CPU: the two chains of every ROI
    side by side, one voxel a step."""
    n = images.shape[0]
    x = images.reshape(n, -1).float()
    x = torch.where(x.abs() < TINY, 0.0, x)  # subnormal voxels read as zero
    acc = torch.zeros(n, 2, dtype=torch.float32)
    keep = torch.zeros(n, 2, dtype=torch.bool)
    count = torch.zeros(n, dtype=torch.int64)
    for k in range(x.shape[1]):
        if k % VOXEL_BLOCK == 0:
            keep = acc != 0
        w = x[:, k].double()
        term = torch.stack([w, w * w], dim=1)
        keep = keep | (term.float() >= TINY)
        acc = (acc.double() + torch.where(keep, term, 0.0)).float()
        count += x[:, k] != 0
    total, total_sq = acc[:, 0], acc[:, 1]
    safe = torch.where(count == 0, 1, count).float()
    mean = flush(total / safe)
    var = flush(flush(total_sq - flush(flush(total * total) / safe)) / safe)
    zero = count == 0
    return torch.stack([torch.where(zero, 0.0, mean), torch.where(zero, 0.0, var)], dim=1)


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
    return out


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(CASES) + ["signed"])
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
