"""The tracker's pair costs: the port's plain body against the JAX package,
and the pair-costs kernel's key reduction in numpy against the plain body.

``matching.pair_costs_plain`` (the CPU path of ``pair_costs``) equals the
reference's jitted ``pair_costs`` on its padded tile at the 3D (338 x 332
markers, F = 22) and 2D (2,196 x 2,195, F = 10) main paths' shapes: the
minima bit for bit and their indices exactly.  ``pair_costs_model``
(``kernels/csrc/pair_costs.cu``'s reduction: an ordered 64-bit key a gated
pair, NaN first and -0 as +0, the smaller index winning a tie; the minima
of the blocks (32 rows by 1, 4 or 8 windows of 32 columns), then of the
blocks; each key decoded
to the cost at its index, (+inf, 0) where the minimum is +inf or no pair
is gated) equals ``torch.min`` over the plain body's cost matrix on the
main shapes and on ``chip_smoke.PAIR_COST_CASES``' hard cases: ties across
rows and across columns, a row and a column with no gated pair, gated
costs that overflow to +inf (and -inf and NaN), NaN features, costs of -0
and +0 that tie, and a tile with no gated pair.
"""
import numpy as np
import pytest
import torch

import jax

import chip_smoke
from nellie_tpu.kernels import matching as j_matching
from nellie_tpu_torch.kernels import _fp, matching
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

W = 32  # a window's rows and columns; a block of pair_costs.cu takes a row of k windows
NO_KEY = np.uint64(2 ** 64 - 1)
ORD_ZERO, ORD_INF = 0x80000000, 0xFF800000


def order_of(cost):
    """torch.min's order of float32 costs as uint64 keys' high words."""
    u = cost.view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    o = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(cost), 0, o).astype(np.uint64)


def from_order(o):
    o = np.asarray(o, np.uint64)
    u = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o & 0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def windows_a_block(windows):
    """``pair_gate.cuh``'s windows a block: 1 for at most 264 windows, 4 for
    at most 4,224, else 8."""
    return 1 if windows <= 2 * 132 else (4 if windows <= 4 * 8 * 132 else 8)


def block_min(keys, axis):
    """The minima along ``axis`` of the blocks' keys (32 rows by k windows
    of 32 columns), then of the blocks: the shared-memory reduction, then
    the device atomics."""
    n_r, n_c = keys.shape
    rows, cols = W, W * windows_a_block(-(-n_r // W) * -(-n_c // W))
    padded = np.full((-(-n_r // rows) * rows, -(-n_c // cols) * cols), NO_KEY, np.uint64)
    padded[:n_r, :n_c] = keys
    blocks = padded.reshape(padded.shape[0] // rows, rows, padded.shape[1] // cols, cols)
    if axis == 1:  # rows: each block's minimum over its 128 columns, then over the blocks
        return blocks.min(axis=3).min(axis=2).reshape(-1)[:n_r]
    return blocks.min(axis=1).min(axis=0).reshape(-1)[:n_c]


def decode(stored, cost, rows):
    """(values, int64 indices) of the stored (inverted) keys: (+inf, 0) for
    no key or a minimum of +inf, the cost at the index for a NaN or a zero,
    else the value the key's order encodes."""
    key = ~stored
    o, index = key >> np.uint64(32), (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
    none = (stored == 0) | (o == ORD_INF)
    k = np.arange(len(stored))
    at = cost[k, np.where(none, 0, index)] if rows else cost[np.where(none, 0, index), k]
    vals = np.where((o == 0) | (o == ORD_ZERO), at, from_order(o))
    return (np.where(none, np.float32(np.inf), vals).astype(np.float32),
            np.where(none, 0, index))


def pair_costs_model(cost, gated):
    """``pair_costs.cu``'s minima of the cost matrix (float32 numpy, gated
    pairs only read): (row values, row indices, column values, column
    indices)."""
    o = order_of(cost) << np.uint64(32)
    n_post, n_pre = cost.shape
    row_keys = np.where(gated, o | np.arange(n_pre, dtype=np.uint64)[None, :], NO_KEY)
    col_keys = np.where(gated, o | np.arange(n_post, dtype=np.uint64)[:, None], NO_KEY)
    # stored inverted and taken by atomicMax, so that the memset's 0 is "no key"
    rows, cols = block_min(row_keys, 1), block_min(col_keys, 0)
    stored = [np.where(k == NO_KEY, np.uint64(0), ~k) for k in (rows, cols)]
    return (*decode(stored[0], cost, True), *decode(stored[1], cost, False))


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def inputs(name):
    cp, cq, fp, fq, max_d, mean, std, n_stats = chip_smoke.pair_cost_inputs(name)
    tensors = [torch.from_numpy(a) for a in (cp, cq, fp, fq)]
    return tensors, (cp, cq, fp, fq), max_d, torch.from_numpy(mean), torch.from_numpy(std), \
        n_stats


def reference(arrays, max_d, mean, std, n_stats):
    """The reference's jitted pair_costs on its padded tile (the tracker's
    chunk of 1,024 doubled until it holds the markers), sliced to the real
    rows and columns."""
    cp, cq, fp, fq = arrays
    padded = [matching.bucket(n, 1024) for n in (len(cp), len(cq))]
    pads = [j_matching._pad_to(a, n) for a, n in ((cp, padded[0]), (cq, padded[1]),
                                                  (fp, padded[0]), (fq, padded[1]))]
    valid = [j_matching._pad_to(np.ones(n, bool), b, False)
             for n, b in ((len(cp), padded[0]), (len(cq), padded[1]))]
    rmv, rmi, cmv, cmi = j_matching.pair_costs(*pads, *valid, np.float32(max_d), mean.numpy(),
                                               std.numpy(), n_stats)
    n_post, n_pre = len(cp), len(cq)
    return (np.asarray(rmv)[:n_post], np.asarray(rmi)[:n_post], np.asarray(cmv)[:n_pre],
            np.asarray(cmi)[:n_pre])


MAIN = ("3D 338x332", "2D 2196x2195")


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    """{case: (inputs, plain, model, reference or None)}, each computed once."""
    out = {}
    for name in chip_smoke.PAIR_COST_CASES:
        tensors, arrays, max_d, mean, std, n_stats = inputs(name)
        args = (*tensors, max_d, mean, std, n_stats)
        plain = [t.numpy() for t in matching.pair_costs_plain(*args)]
        cost = matching.pair_cost_matrix(*args).numpy()
        _, gated = matching._pair_mask_and_dist(tensors[0], tensors[1], _fp.f32(max_d))
        model = pair_costs_model(cost, gated.numpy())
        ref = reference(arrays, max_d, mean, std, n_stats) if name in MAIN else None
        out[name] = (args, plain, model, ref, gated.numpy())
    return out


@pytest.mark.parametrize("name", MAIN)
def test_plain_equals_reference(runs, name):
    _, plain, _, ref, _ = runs[name]
    for got, want in zip(plain, ref):
        if got.dtype == np.float32:
            np.testing.assert_array_equal(bits(got), bits(want))
        else:
            np.testing.assert_array_equal(got, np.asarray(want, np.int64))
    assert np.isfinite(plain[0]).any() and np.isfinite(plain[2]).any()


@pytest.mark.parametrize("name", chip_smoke.PAIR_COST_CASES)
def test_model_equals_plain(runs, name):
    _, plain, model, _, _ = runs[name]
    for got, want in zip(model, plain):
        if want.dtype == np.float32:
            np.testing.assert_array_equal(bits(got), bits(want))
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name, what", [
    ("ties", "a tie across columns and one across rows"),
    ("lonely row and column", "a row and a column with no gated pair"),
    ("overflow", "gated minima of +inf, -inf and NaN"),
    ("NaN features", "NaN minima"),
    ("zero signs", "minima of -0 and of +0, each at a tie"),
    ("no gated pair", "no gated pair"),
])
def test_hard_cases_are_hard(runs, name, what):
    """Each hard case holds what it is meant to."""
    _, plain, _, _, gated = runs[name]
    rmv, rmi, cmv, cmi = plain
    row_n, col_n = gated.sum(axis=1), gated.sum(axis=0)
    if name == "ties":
        cost = matching.pair_cost_matrix(*runs[name][0]).numpy()
        assert ((cost[:, 1::2] == cost[:, 0:-1:2]) & gated[:, 1::2]).any()
        assert ((cost[1::2] == cost[0:-1:2]) & gated[1::2]).any()
    elif name == "lonely row and column":
        assert row_n[5] == 0 and col_n[7] == 0 and rmv[5] == np.inf and rmi[5] == 0 \
            and cmv[7] == np.inf and cmi[7] == 0 and row_n.sum() > 0
    elif name == "overflow":
        gated_rows = row_n > 0
        assert (np.isposinf(rmv) & gated_rows).any() and np.isneginf(rmv).any() \
            and np.isnan(rmv).any()
        assert (rmi[np.isposinf(rmv)] == 0).all()
    elif name == "NaN features":
        assert np.isnan(rmv).any() and np.isnan(cmv).any()
    elif name == "zero signs":
        zero = (row_n > 1) & (rmv == 0)
        assert (zero & np.signbit(rmv)).any() and (zero & ~np.signbit(rmv)).any()
    else:
        assert row_n.sum() == 0 and (rmi == 0).all() and (cmi == 0).all() \
            and np.isposinf(rmv).all()


def test_cpu_tensor_takes_the_plain_body(runs):
    args, plain, _, _, _ = runs["3D 338x332"]
    before = matching.PAIR_COSTS_KERNEL.launches
    got = matching.to_host(matching.pair_costs(*args))
    assert matching.PAIR_COSTS_KERNEL.launches == before
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g.numpy().view(np.uint8), w.view(np.uint8))


def test_kernel_refuses_cpu_tensors(runs):
    args = runs["3D 338x332"][0]
    with pytest.raises(TypeError):
        matching.PAIR_COSTS_KERNEL(*args)


def test_both_matcher_kernels_share_the_gate_header():
    """Both kernels include ``csrc/pair_gate.cuh``, so a change to the gate
    rebuilds both."""
    for kernel in (matching.PAIR_SUMS_KERNEL, matching.PAIR_COSTS_KERNEL):
        assert [p.split("/")[-1] for p in kernel.headers()] == ["pair_gate.cuh"]


def test_cost_weights_are_the_plain_bodys():
    """The kernel's weights, float32(1 / n) as the plain body rounds them."""
    w = matching.cost_weights(22, 4)
    assert w[:4] == [_fp.f32(0.25)] * 4 and w[4:] == [_fp.f32(1.0 / 18)] * 18
