"""The port's windowed exact EDT against the JAX package.

``edt.distance_transform_plain`` (the CPU path of ``distance_transform``,
and the body that ``csrc/edt_minplus.cu`` is held to on the card) equals
the reference's jitted ``distance_transform`` bit for bit on
``chip_smoke.EDT_CASES``: the Markers' clamps (11 px in 3D, 21 px in 2D),
no clamp, anisotropic sampling, an axis shorter than the clamp, one axis,
a frame with no background and one with no foreground, a clamp of 15 and
one whose halo takes several chunks of the kernel's tile.  ``window_costs``
is the table the kernel takes: the plain body's costs, bit for bit, and
past 128 offsets the reference loop's.  And
``edt_minplus_model``, the kernel's schedule in numpy (its tiles, chunks,
8 outputs a thread and ring of costs), equals the plain body bit for bit,
so that the schedule is checked here before the card runs it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from nellie_tpu.kernels import edt as j_edt
from nellie_tpu_torch.kernels import edt
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.mark.parametrize("name", list(chip_smoke.EDT_CASES))
def test_cases_against_reference(name):
    shape, sampling, radius, _ = chip_smoke.EDT_CASES[name]
    m = chip_smoke.edt_case_mask(name, seed=len(name))
    want = np.asarray(j_edt.distance_transform(jnp.asarray(m), sampling=sampling,
                                               max_radius_px=radius))
    got = edt.distance_transform_plain(torch.from_numpy(m), sampling, radius)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        edt.distance_transform(torch.from_numpy(m), sampling, radius).numpy(), got.numpy())


def test_unclamped_is_scipy():
    from scipy import ndimage as ndi

    m = chip_smoke.edt_case_mask("3D no clamp, anisotropic")
    samp = chip_smoke.EDT_CASES["3D no clamp, anisotropic"][1]
    got = edt.distance_transform_plain(torch.from_numpy(m), samp).numpy()
    np.testing.assert_allclose(got, ndi.distance_transform_edt(m, sampling=samp), rtol=1e-6)


@pytest.mark.parametrize("radius,s", [(0, 1.0), (11, 1.0), (21, 1.0), (29, 0.2), (13, 0.3)])
def test_window_costs_are_the_plain_costs(radius, s):
    table = edt.window_costs(radius, s)
    assert len(table) == radius + 1
    for k in range(2 * radius + 1):
        plain = np.float32(((k - radius) * s) ** 2)
        assert np.float32(table[abs(k - radius)]).view(np.int32) == plain.view(np.int32)
    assert edt.window_radii((5, 30, 40), 11) == [4, 11, 11]
    assert edt.window_radii((5, 30), None) == [4, 29]


@pytest.mark.parametrize("radius,s", [(63, 0.3), (64, 0.7), (70, 0.3), (90, 0.1), (80, 0.123)])
def test_window_costs_are_the_references(radius, s):
    """A window of more than 128 offsets takes the reference's loop, whose
    costs XLA computes as f32(d^2) * f32(s^2): read them off a delta."""
    x = np.full(2 * radius + 1, np.inf, np.float32)
    x[radius] = 0.0
    want = np.asarray(j_edt._minplus_axis(jnp.asarray(x), 0, radius, s))
    table = edt.window_costs(radius, s)
    got = np.array([table[abs(radius - i)] for i in range(2 * radius + 1)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# csrc/edt_minplus.cu's shape of a block
W, THREADS, OPT, CH = 32, 256, 8, 128
TY = THREADS // W
TN = TY * OPT


def minplus_pass(f, mask, cost, shape, axis, first, final, max_dim):
    """One launch of ``minplus_axis`` along ``axis`` in numpy, block by
    block: the lanes of a warp are the rows of an array, each thread's 8
    outputs and 8 ring costs its columns."""
    inf = np.float32(np.inf)
    n = shape[axis]
    outer, inner = int(np.prod(shape[:axis])), int(np.prod(shape[axis + 1:]))
    line = inner == 1
    lines = outer if line else inner
    src, mk = (None if f is None else f.reshape(-1)), mask.reshape(-1)
    out = np.zeros(mk.size, np.float32)
    r = len(cost) - 1
    steps = (2 * r + 2 * OPT - 1) // OPT * OPT
    span = TN - OPT + steps
    line_tiles, row_tiles = -(-lines // W), -(-n // TN)
    ps, ls = (1, n) if line else (inner, 1)
    for block in range((1 if line else outer) * row_tiles * line_tiles):
        lt, b = block % line_tiles, block // line_tiles
        a0 = (b % row_tiles) * TN
        base = 0 if line else (b // row_tiles) * n * inner
        l0 = lt * W
        best = np.full((TY, W, OPT), inf, np.float32)
        ring = np.full((TY, W, OPT), inf, np.float32)
        for c0 in range(0, span, CH):
            rows = min(CH, span - c0)
            tile = np.full((CH, W), np.nan, np.float32)
            j, lane = np.divmod(np.arange(rows * W), W)
            if line:
                lane, j = np.divmod(np.arange(rows * W), rows)
            p, ln = a0 - r + c0 + j, l0 + lane
            inside = (p >= 0) & (p < n) & (ln < lines)
            at = base + np.where(inside, p, 0) * ps + np.where(inside, ln, 0) * ls
            values = np.where(mk[at], inf, np.float32(0.0)) if first else src[at]
            tile[j, lane] = np.where(inside, values, inf)
            for ty in range(TY):
                m0, m1 = max(0, c0 - ty * OPT), min(steps, c0 + rows - ty * OPT)
                assert m0 % OPT == 0 and (m1 <= m0 or m1 % OPT == 0)
                for m in range(m0, m1):
                    u = m % OPT
                    ring[ty, :, u] = cost[abs(m - r)] if m <= 2 * r else inf
                    v = tile[ty * OPT - c0 + m]
                    assert not np.isnan(v).any()  # every row read was loaded
                    for k in range(OPT):
                        best[ty, :, k] = np.fmin(best[ty, :, k], v + ring[ty, :, (u - k) % OPT])
        ty, lane, k = np.meshgrid(np.arange(TY), np.arange(W), np.arange(OPT), indexing="ij")
        i, ln = a0 + ty * OPT + k, l0 + lane
        keep = (i < n) & (ln < lines)
        at = base + i[keep] * ps + ln[keep] * ls
        v = best[keep]
        if final:
            v = np.where(mk[at], np.where(np.isinf(v), max_dim, np.sqrt(v)), np.float32(0.0))
        out[at] = v
    return out.reshape(shape)


def edt_minplus_model(mask, sampling, max_radius_px):
    """``csrc/edt_minplus.cu``'s passes in numpy: one an axis, the first
    reading the mask, the last fusing the root, +inf and the mask."""
    shape = mask.shape
    sampling = (1.0,) * len(shape) if sampling is None else sampling
    f = None
    for axis, r in enumerate(edt.window_radii(shape, max_radius_px)):
        cost = np.array(edt.window_costs(r, float(sampling[axis])), np.float32)
        f = minplus_pass(f, mask, cost, shape, axis, axis == 0, axis == len(shape) - 1,
                         np.float32(max(shape)))
    return f


@pytest.mark.parametrize("name", ["2D clamp 21", "2D clamp 15", "3D clamp 15",
                                  "2D clamp 70, halo in chunks", "2D no clamp, anisotropic",
                                  "1-D clamp 5", "3D full"])
def test_kernel_schedule_equals_plain(name):
    shape, sampling, radius, _ = chip_smoke.EDT_CASES[name]
    m = chip_smoke.edt_case_mask(name, seed=len(name))
    want = edt.distance_transform_plain(torch.from_numpy(m), sampling, radius).numpy()
    got = edt_minplus_model(m, sampling, radius)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
