"""The tracker's pair sums: the port's plain body against the JAX package,
and the pair-sums kernel's schedule in torch against the plain body.

``matching.pair_stats_plain`` (the CPU path of ``pair_stats``) equals the
reference's jitted ``pair_stats`` on its padded tile, count exact and sums
bit for bit.  ``pair_sums_model`` (``kernels/csrc/pair_sums.cu``'s schedule
in torch: the gate of every pair of every 32 x 32 window of real pairs,
each (window, feature) chain of sums and of squares from +0 over the
window's gated pairs only, in row-major order; then the later levels over
the real windows' part of the padded window grid, each output window one
chain from +0 over its nonzero elements, the 4- and 8-column lanes each
from +0 and added in halves, and the final row-major sum from +0 over the
nonzero elements) equals the plain body on the same inputs: 3D and 2D
coordinates, a tile of one window level (the 3D main path's 1,024 x
1,024), a second general level (the 2D main path's 4,096 x 4,096), the
lanes of a padded 2,048 x 128 and 2,048 x 256 tile, no gated pair, NaN and
subnormal features, a window row whose gated terms are all +0, and a third
level.
"""
import numpy as np
import pytest
import torch

import jax

from nellie_tpu.kernels import matching as j_matching
import chip_smoke
from nellie_tpu_torch.kernels import _fp, matching
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

W = 32


def pair_sums_model(cp, cq, fp, fq, max_d, padded):
    """``pair_sums.cu``'s schedule in torch on the CPU; returns (count,
    sums, sumsqs) and the level-1 window sums (2 (F+1), rows, cols), zero
    outside the windows of real pairs."""
    n_post, ndim = cp.shape
    n_pre, n_feat = cq.shape[0], fp.shape[1]
    s = n_feat + 1
    rows, cols = padded[0] // W, padded[1] // W
    wr, wc = -(-n_post // W), -(-n_pre // W)
    max_d = torch.tensor(_fp.f32(max_d))

    def blocks(x, n, wins):  # (wins, 32, width): each window's rows, 0 past the real ones
        return torch.nn.functional.pad(x, (0, 0, 0, wins * W - n)).reshape(wins, W, -1)

    rc, cc, rf, cf = blocks(cp, n_post, wr), blocks(cq, n_pre, wc), \
        blocks(fp, n_post, wr), blocks(fq, n_pre, wc)
    real_r = (torch.arange(wr * W) < n_post).reshape(wr, W)
    real_c = (torch.arange(wc * W) < n_pre).reshape(wc, W)
    # the gate of every pair of every window: (wr, wc, 32, 32), a ballot a row
    diff = [rc[:, None, :, None, a] - cc[None, :, None, :, a] for a in range(ndim)]
    sq = diff[0] * diff[0]
    for a in range(1, ndim):
        sq = _fp.fma_plain(diff[a], diff[a], sq)
    dist = _fp.sqrt(sq)
    gate = (dist < max_d) & real_r[:, None, :, None] & real_c[None, :, None, :]
    count = int(gate.sum())
    # each (window, feature) chain from +0 over its gated pairs in row-major
    # order; the normalised distance of gated pairs only
    acc = torch.zeros(wr, wc, s)
    acc2 = torch.zeros(wr, wc, s)
    for i in range(W):
        for j in range(W):
            m = gate[:, :, i, j, None]
            if not bool(m.any()):
                continue
            d = torch.cat([(dist[:, :, i, j] / max_d)[..., None],
                           (rf[:, None, i, :] - cf[None, :, j, :]).abs()], dim=2)
            acc = torch.where(m, acc + d, acc)
            acc2 = torch.where(m, acc2 + d * d, acc2)
    level = torch.zeros(2 * s, rows, cols)
    level[:s, :wr, :wc] = acc.permute(2, 0, 1)
    level[s:, :wr, :wc] = acc2.permute(2, 0, 1)
    sums = later_levels_model(level, wr, wc)
    return count, sums[:s], sums[s:], level


def add_nonzero(acc, v):
    """A chain's step: the element added where it is not zero."""
    return torch.where(v != 0, acc + v, acc)


def later_levels_model(x, vr, vc):
    """The later levels as ``pair_sums.cu`` runs them: each output window of
    the real (vr, vc) part one chain from +0 over its nonzero elements in
    the reference's order (the lanes' windows across rows, each lane from
    +0, then the lanes added in halves); then the final row-major sum from
    +0 over the nonzero elements left."""
    planes, rows, cols = x.shape

    def at(r, c):
        ok = (r < vr) & (c < vc)
        return torch.where(ok, x[:, r.clamp(max=rows - 1), c.clamp(max=cols - 1)], 0.0)

    while rows > W or cols > W:
        lanes = {4: 8, 8: 4}.get(cols) if rows > W else None
        out_r = -(-rows // W)
        orow = torch.arange(out_r)
        if lanes:
            lane = torch.zeros(planes, out_r, lanes)
            for step in range(W // lanes):
                for c in range(cols):
                    for ln in range(lanes):
                        r = orow * W + step * lanes + ln
                        lane[..., ln] = add_nonzero(lane[..., ln], at(r, torch.full_like(r, c)))
            while lanes > 1:
                lanes //= 2
                lane = lane[..., :lanes] + lane[..., lanes:]
            out = lane
            ovr, ovc = -(-vr // W), 1
        else:
            out_c = -(-cols // W)
            ocol = torch.arange(out_c)
            out = torch.zeros(planes, out_r, out_c)
            for i in range(W):
                for j in range(W):
                    out = add_nonzero(out, at((orow * W + i)[:, None], (ocol * W + j)[None, :]))
            ovr, ovc = -(-vr // W), -(-vc // W)
        x = out
        planes, rows, cols = x.shape
        vr, vc = ovr, ovc
    acc = torch.zeros(planes)
    for r in range(vr):
        for c in range(vc):
            acc = add_nonzero(acc, x[:, r, c])
    return acc


def reference(cp, cq, fp, fq, max_d, padded):
    """The reference's jitted pair_stats on its padded tile with validity
    masks."""
    pads = [j_matching._pad_to(a, n) for a, n in ((cp, padded[0]), (cq, padded[1]),
                                                  (fp, padded[0]), (fq, padded[1]))]
    valid = [j_matching._pad_to(np.ones(n, bool), b, False)
             for n, b in ((len(cp), padded[0]), (len(cq), padded[1]))]
    count, sums, sumsqs = jax.jit(j_matching.pair_stats)(*pads, *valid, np.float32(max_d))
    return int(count), np.asarray(sums), np.asarray(sumsqs)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# (n_post, n_pre, ndim, F, padded, max_d): the 3D main path's one window
# level and F = 22; a 2D second level over a 4,096 x 4,096 tile (F = 10);
# the lanes of 2,048 x 128 (8 lanes of 4 columns) and 2,048 x 256 (4 of 8);
# and no gated pair
CASES = {
    "3d_1024": (338, 332, 3, 22, (1024, 1024), 1.0),
    "2d_4096": (300, 280, 2, 10, (4096, 4096), 1.0),
    "lanes_8x4": (1100, 70, 3, 22, (2048, 128), 1.0),
    "lanes_4x8": (1100, 200, 2, 10, (2048, 256), 1.0),
    "no_gated_pair": (90, 70, 3, 22, (128, 128), 1e-6),
}
# the model against the plain body only (XLA's CPU code flushes subnormals
# and keeps other NaN bits): NaN features through a second level, subnormal
# features (differences subnormal, their squares +0), a window row whose
# gated terms are all +0, and a third level (a padded 64 x 131,072 tile)
MODEL_CASES = {
    "nan_features": (300, 280, 2, 10, (4096, 4096), 1.0, "nan"),
    "nan_lanes": (1100, 70, 3, 22, (2048, 128), 1.0, "nan"),
    "subnormal_features": (338, 332, 3, 22, (1024, 1024), 1.0, "subnormal"),
    "zero_terms": (90, 70, 3, 22, (128, 128), 1.0, "zero terms"),
    "third_level": (40, 3000, 2, 10, (64, 131072), 4.0, "normal"),
}


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    """{case: (inputs, plain, model, reference)}, each computed once."""
    out = {}
    cases = {**{k: (*v, "normal") for k, v in CASES.items()}, **MODEL_CASES}
    for name, (n_post, n_pre, ndim, n_feat, padded, max_d, kind) in cases.items():
        arrays = chip_smoke.pair_tile(n_post, n_pre, ndim, n_feat, seed=len(out),
                                      shift=50.0 if name == "no_gated_pair" else 0.0, kind=kind)
        t = [torch.from_numpy(a) for a in arrays]
        plain = matching.pair_stats_plain(*t, _fp.f32(max_d), padded)
        model = pair_sums_model(*t, max_d, padded)
        ref = reference(*arrays, max_d, padded) if name in CASES else None
        out[name] = (t, plain, model, ref)
    return out


@pytest.mark.parametrize("name", [*CASES, *MODEL_CASES])
def test_model_equals_plain(runs, name):
    _, plain, model, _ = runs[name]
    assert model[0] == plain[0]
    for got, want in zip(model[1:3], plain[1:]):
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_cases_are_hard(runs, name):
    """The NaN cases reach NaN sums, the subnormal one subnormal sums and
    +0 sums of squares, the +0 terms a gated window row of +0 sums."""
    t, plain, model, _ = runs[name]
    count, sums, sumsqs = plain
    assert count > 0
    if name.startswith("nan"):
        assert torch.isnan(sums[1:]).any() and not torch.isnan(sums[0])
    elif name == "subnormal_features":
        tiny = sums[1:].abs()
        assert ((tiny > 0) & (tiny < torch.finfo(torch.float32).tiny)).any()
        assert (sumsqs[1:] == 0).all()
    elif name == "zero_terms":
        level = model[3]
        first_row = level[:, 0, :]
        assert (first_row == 0).all() and (level[:, 1:] != 0).any()
        cp, cq = t[0][:32], t[1]
        assert bool((torch.cdist(cp.double(), cq.double()) == 0).any())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_reference(runs, name):
    _, plain, _, ref = runs[name]
    assert plain[0] == ref[0]
    assert (plain[0] == 0) == (name == "no_gated_pair")
    for got, want in zip(plain[1:], ref[1:]):
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("name, levels", [("3d_1024", 0), ("2d_4096", 1), ("lanes_8x4", 1)])
def test_window_levels(runs, name, levels):
    """The cases reach the levels they are meant to: the level-1 grid and
    the number of window levels after it."""
    padded = CASES[name][4]
    rows, cols = padded[0] // W, padded[1] // W
    n = 0
    while rows > W or cols > W:
        lanes = {4: 8, 8: 4}.get(cols) if rows > W else None
        rows, cols = -(-rows // W), 1 if lanes else -(-cols // W)
        n += 1
    assert n == levels
    assert runs[name][2][3].shape[1:] == (padded[0] // W, padded[1] // W)


def test_cpu_tensor_takes_the_plain_body(runs):
    t, plain, _, _ = runs["3d_1024"]
    before = matching.PAIR_SUMS_KERNEL.launches
    got = matching.pair_stats(*t, 1.0, CASES["3d_1024"][4])
    assert matching.PAIR_SUMS_KERNEL.launches == before
    assert got[0] == plain[0]
    for g, w in zip(got[1:], plain[1:]):
        np.testing.assert_array_equal(bits(g), bits(w))


def test_kernel_refuses_cpu_tensors(runs):
    t = runs["3d_1024"][0]
    with pytest.raises(TypeError):
        matching.PAIR_SUMS_KERNEL(*t, 1.0, (1024, 1024))
