"""The tracker's pair sums: the port's plain body against the JAX package,
and the pair-sums kernel's schedule in torch against the plain body.

``matching.pair_stats_plain`` (the CPU path of ``pair_stats``) equals the
reference's jitted ``pair_stats`` on its padded tile, count exact and sums
bit for bit.  ``pair_sums_model`` (``kernels/csrc/pair_sums.cu``'s schedule
in torch: a block a 32 x 32 window of real pairs, its gate, one chain of
sums and one of squares a feature from -0; then the later levels as the
last block runs them, over the padded window grid, zero windows and
padding read as +0, the 4- and 8-column lanes, and the final row-major
sum) equals the plain body on the same inputs: 3D and 2D coordinates, a
tile of one window level (the 3D main path's 1,024 x 1,024), a second
general level (the 2D main path's 4,096 x 4,096), the lanes of a padded
2,048 x 128 and 2,048 x 256 tile, and no gated pair.
"""
import numpy as np
import pytest
import torch

import jax

from nellie_tpu.kernels import matching as j_matching
from nellie_tpu_torch.kernels import _fp, matching
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

W = 32


def pair_sums_model(cp, cq, fp, fq, max_d, padded):
    """``pair_sums.cu``'s schedule in torch on the CPU; returns (count,
    sums, sumsqs) and the level-1 window sums (2 (F+1), rows, cols)."""
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
    # the gate of every pair of every window: (wr, wc, 32, 32)
    diff = [rc[:, None, :, None, a] - cc[None, :, None, :, a] for a in range(ndim)]
    sq = diff[0] * diff[0]
    for a in range(1, ndim):
        sq = _fp.fma_plain(diff[a], diff[a], sq)
    dist = _fp.sqrt(sq)
    gate = (dist < max_d) & real_r[:, None, :, None] & real_c[None, :, None, :]
    dn = dist / max_d
    count = int(gate.sum())
    acc = torch.full((wr, wc, s), -0.0)
    acc2 = torch.full((wr, wc, s), -0.0)
    for i in range(W):
        for j in range(W):
            d = torch.cat([dn[:, :, i, j, None],
                           (rf[:, None, i, :] - cf[None, :, j, :]).abs()], dim=2)
            m = gate[:, :, i, j, None]
            acc = acc + torch.where(m, d, 0.0)
            acc2 = acc2 + torch.where(m, d * d, 0.0)
    level = torch.zeros(2 * s, rows, cols)
    level[:s, :wr, :wc] = acc.permute(2, 0, 1)
    level[s:, :wr, :wc] = acc2.permute(2, 0, 1)
    sums = later_levels_model(level, wr, wc)
    return count, sums[:s], sums[s:], level


def later_levels_model(x, vr, vc):
    """The last block's levels: each output window one chain (the lanes'
    windows vectorised across rows), elements outside (vr, vc) read as
    +0; then the row-major sum of what is left."""
    planes, rows, cols = x.shape

    def at(r, c):
        ok = (r < vr) & (c < vc)
        return torch.where(ok, x[:, r.clamp(max=rows - 1), c.clamp(max=cols - 1)], 0.0)

    while rows > W or cols > W:
        lanes = {4: 8, 8: 4}.get(cols) if rows > W else None
        out_r = -(-rows // W)
        orow = torch.arange(out_r)
        if lanes:
            lane = torch.full((planes, out_r, lanes), -0.0)
            lane[..., 0] = 0.0
            for step in range(W // lanes):
                for c in range(cols):
                    for ln in range(lanes):
                        r = orow * W + step * lanes + ln
                        lane[..., ln] = lane[..., ln] + at(r, torch.full_like(r, c))
            while lanes > 1:
                lanes //= 2
                lane = lane[..., :lanes] + lane[..., lanes:]
            out = lane
        else:
            out_c = -(-cols // W)
            ocol = torch.arange(out_c)
            out = torch.full((planes, out_r, out_c), -0.0)
            for i in range(W):
                for j in range(W):
                    out = out + at((orow * W + i)[:, None], (ocol * W + j)[None, :])
        x = out
        planes, rows, cols = x.shape
        vr, vc = rows, cols
    acc = torch.full((planes,), -0.0)
    for r in range(rows):
        for c in range(cols):
            acc = acc + (x[:, r, c] if r < vr and c < vc else 0.0)
    return acc


def tile(n_post, n_pre, ndim, n_feat, seed=0, spread=0.2):
    rng = np.random.default_rng(seed)
    spacing = np.array([0.5, 0.2, 0.2][-ndim:])
    coords_pre = (rng.integers(0, 24, (n_pre, ndim)) * spacing).astype(np.float32)
    coords_post = (coords_pre[rng.integers(0, n_pre, n_post)]
                   + rng.normal(0, spread, (n_post, ndim))).astype(np.float32)
    feats = [rng.normal(0, 1, (n, n_feat)).astype(np.float32) for n in (n_post, n_pre)]
    return coords_post, coords_pre, feats[0], feats[1]


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


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    """{case: (inputs, plain, model, reference)}, each computed once."""
    out = {}
    for name, (n_post, n_pre, ndim, n_feat, padded, max_d) in CASES.items():
        arrays = tile(n_post, n_pre, ndim, n_feat, seed=len(out))
        if name == "no_gated_pair":
            arrays = (arrays[0] + np.float32(50.0),) + arrays[1:]
        t = [torch.from_numpy(a) for a in arrays]
        plain = matching.pair_stats_plain(*t, _fp.f32(max_d), padded)
        model = pair_sums_model(*t, max_d, padded)
        out[name] = (t, plain, model, reference(*arrays, max_d, padded))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_model_equals_plain(runs, name):
    _, plain, model, _ = runs[name]
    assert model[0] == plain[0]
    for got, want in zip(model[1:3], plain[1:]):
        np.testing.assert_array_equal(bits(got), bits(want))


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
