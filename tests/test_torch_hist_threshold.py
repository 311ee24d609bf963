"""The histogram thresholds: the port's plain bodies against the JAX
package, and the threshold kernel's schedule in torch against them.

``thresholds.otsu_threshold_plain``, ``triangle_threshold_plain`` and
``min_triangle_otsu_plain`` (the CPU paths of the three thresholds) equal
the reference's jitted functions bit for bit (NaN where NaN).
``hist_threshold_model`` (``kernels/csrc/hist_threshold.cu``'s schedule in
torch: the masked values as the mask-led passes visit them, 16 mask bytes a
thread and a float4 only where its mask word is set, pass 2 binning pass
1's record of them (or, past the record's 2^21 values, the mask and the
values again, or with no mask the values); the masked minimum and
maximum as ordered integer keys, integer counts of the float32 bin index,
then the last block's tail: the exact total as an integer sum and, past
2^24, the windows of XLA's order one thread each and the last rows in
order; p and the centres one bin a thread; the four blocked prefix sums
level by level, the inner runs of all four one thread each; Otsu's
argmax, the peak and the nonempty bins as block reductions of 256 threads
over one unsigned key a value (NaN first, -0 as +0) that keep the first
index on ties; the triangle's
argmax the same way, the minimum of the two) equals the plain bodies:
skewed and bimodal samples, the triangle's peak near either end (both
flips), no mask, an empty mask, every value equal (a span of 0), one
masked value, all values in two bins, 100, 1,000 and 10,000 bins (two and
three levels of block totals, the total over single counts and over rows
of 16), and the Filter's stride geometries of the 3D frame (2, 2, 2) and
the capacity window (4, 4, 4) with non-positive voxels, an empty and a
full mask, NaN among the masked values and 9,000 bins.
``triangle_and_otsu_plain`` equals the reference's two thresholds.
``thresholds.counts_total`` is XLA's sum of the reference's counts at bin
counts from 2 to 70,000, and past 2^24 masked values the thresholds still
equal the reference's, where an exact total would not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nellie_tpu.kernels import thresholds as j_thr
from nellie_tpu_torch.kernels import _fp, thresholds
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

SCAN_BLOCK = 16


def order_key(x):
    """float32 -> uint32 in the floats' order (-0 below +0)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def key_value(k):
    k = np.uint64(k)
    b = k & np.uint64(0x7FFFFFFF) if k & np.uint64(0x80000000) else ~k & np.uint64(0xFFFFFFFF)
    return np.array([b], np.uint32).view(np.float32)[0]


THREADS = 256  # hist_threshold.cu's block
EXACT_TOTAL = 2 ** 24
RECORD = 2 ** 21  # hist_threshold.cu: masked values pass 1 records, at most


def first_argmax(x):
    """torch.argmax's choice: the first maximum, the first NaN before all."""
    idx = 0
    for b in range(1, len(x)):
        v, best = float(x[b]), float(x[idx])
        if (np.isnan(v) and not np.isnan(best)) or (not np.isnan(best) and v > best):
            idx = b
    return idx


def arg_key(v):
    """hist_threshold.cu's ``arg_key``: torch.argmax's order as an unsigned
    key, NaN above every number, -0 as +0; 0 is no value."""
    v = np.float32(v)
    if np.isnan(v):
        return 0xFFFFFFFF
    return int(order_key(np.float32(0.0) if v == 0 else v))


def block_argmax(x, threads=THREADS):
    """(value, index) of ``block_best`` over x: each thread's strided
    elements (the larger key, then the lower index), in each warp the
    largest key and the least index holding it, then the warps in turn."""
    parts = []
    for t in range(threads):
        key, index = 0, 0
        for b in range(t, len(x), threads):
            k = arg_key(x[b])
            if k > key or (k == key and b < index):
                key, index = k, b
        parts.append((key, index))
    warps = []
    for w in range(0, threads, 32):
        key = max(k for k, _ in parts[w:w + 32])
        warps.append((key, min(i if k == key else 0xFFFFFFFF for k, i in parts[w:w + 32])))
    key, index = warps[0]
    for k, i in warps[1:]:
        if k > key or (k == key and i < index):
            key, index = k, i
    return float(x[index]), index


def scan_plan(n):
    """[(elements, buffer offset)] of ``scan_plan``'s levels; the last has
    at most 16 elements."""
    levels, off = [], 0
    while n > SCAN_BLOCK:
        nb = -(-n // SCAN_BLOCK)
        levels.append((n, off))
        off += nb * SCAN_BLOCK
        n = nb
    return levels + [(n, off)], off + n


def level_scans(inputs):
    """The four scans of ``thresholds_tail`` level by level: each level's
    inner runs of 16 (one thread each, the padding 0), their totals into
    the next level, the top level's running sum, then the adds down."""
    n = len(inputs[0])
    levels, size = scan_plan(n)
    bufs = [np.zeros(size, np.float32) for _ in inputs]
    for s, x in enumerate(inputs):
        for lv, (length, off) in enumerate(levels):
            top = lv == len(levels) - 1
            src = x.numpy() if lv == 0 else bufs[s][off:off + length].copy()
            runs = 1 if top else levels[lv + 1][0]
            for k in range(runs):
                start, end = k * SCAN_BLOCK, (length if top else k * SCAN_BLOCK + SCAN_BLOCK)
                acc = np.float32(0)
                for i in range(start, end):
                    v = src[i] if i < length else np.float32(0)
                    acc = v if i == start else np.float32(acc + v)
                    bufs[s][off + i] = acc
                if not top:
                    bufs[s][levels[lv + 1][1] + k] = acc
        for lv in range(len(levels) - 2, -1, -1):
            length, off = levels[lv]
            nxt = levels[lv + 1][1]
            for i in range(length):
                k = i // SCAN_BLOCK
                bufs[s][off + i] = np.float32(bufs[s][off + i]
                                              + (np.float32(0) if k == 0 else bufs[s][nxt + k - 1]))
    return [torch.from_numpy(b[:n].copy()) for b in bufs]


def xla_total(counts):
    """The counts' total as the kernel's tail sums it: the exact integer
    total where it is at most 2^24 (every partial sum is then exact), else
    over rows of 16 counts where nbins is a multiple of 16, else single
    counts; windows of 32 rows, half the padding (rounded down) before the
    first, one window a thread, while more than 32 rows remain; then the
    rest in order by one thread."""
    exact = int(counts.sum())
    if exact <= EXACT_TOTAL:
        return torch.tensor(np.float32(exact))
    x = [np.float32(c) for c in counts.tolist()]
    n = len(x)
    unit = 16 if n % 16 == 0 else 1
    rows = n // unit
    while rows > 32:
        pad = -rows % 32
        first, width, length = -(pad // 2) * unit, 32 * unit, rows * unit
        windows = (rows + pad) // 32
        nxt = []
        for w in range(windows):
            acc = np.float32(0)
            for k in range(w * width + first, w * width + first + width):
                if 0 <= k < length:
                    acc = np.float32(acc + x[k])
            nxt.append(acc)
        x, unit, rows = nxt, 1, windows
    acc = x[0]
    for k in range(1, rows * unit):
        acc = np.float32(acc + x[k])
    return torch.tensor(acc)


def masked_visits(mask, vec=True):
    """The indices whose values ``for_each_masked`` hands on, in the order
    of one thread's walk: with ``vec`` 16 mask bytes at a time, the four
    values of a mask word only where the word is not 0, then the rest one
    at a time."""
    m = mask
    done = m.size // 16 * 16 if vec else 0
    words = m[:done].reshape(-1, 4)  # a thread's uint4 is four of these words
    loaded = np.repeat(words.any(axis=1), 4)  # the float4s a thread loads
    return np.concatenate([np.flatnonzero(loaded & m[:done]),
                           done + np.flatnonzero(m[done:])]).astype(np.int64)


def hist_threshold_model(values, mask, nbins=256):
    """``hist_threshold.cu`` in torch on the CPU: (Otsu, criterion,
    triangle, min(triangle, Otsu), any masked value, flip)."""
    f = values.reshape(-1).float()
    m = np.ones(f.numel(), bool) if mask is None else mask.reshape(-1).numpy()
    visits = masked_visits(m)
    assert np.array_equal(np.sort(visits), np.flatnonzero(m))
    record = f.numpy()[visits]  # pass 1's record, in the order of one thread's walk
    # pass 2 bins the record where it holds every masked value, else walks
    # the mask again (with no mask, the values): the same values either way
    sel = record if mask is not None and record.size <= min(m.size, RECORD) else \
        f.numpy()[masked_visits(m)]
    any_valid = sel.size > 0
    # pass 1: the maxima of ~key and of key
    keys = order_key(sel)
    lo = key_value(0xFFFFFFFF ^ int((0xFFFFFFFF ^ keys).max())) if any_valid else np.float32(0)
    hi = key_value(int(keys.max())) if any_valid else np.float32(1)
    lo, hi = torch.tensor(lo), torch.tensor(hi)
    span = hi - lo
    safe = span if span > 0 else torch.tensor(1.0)
    # pass 2: the bins, integer counts
    q = torch.floor((torch.from_numpy(sel) - lo) / safe * float(nbins))
    b = torch.where(q >= 0, torch.where(q < nbins - 1, q, float(nbins - 1)), 0.0).long()
    counts = torch.bincount(b, minlength=nbins)
    # the tail
    denom = torch.clamp(xla_total(counts), min=1.0)
    bins = torch.arange(nbins, dtype=torch.float32)
    p = counts.float() / denom
    centres = _fp.fma_plain(bins, span / float(nbins), lo) + span / float(2 * nbins)
    pc = p * centres
    w1, s_pc, rev_w, rev_pc = level_scans([p, pc, p.flip(0), pc.flip(0)])
    # one bin a thread: v12[k] from w1[k] and the reversed scans at n - 2 - k
    mean1 = s_pc[:-1] / torch.clamp(w1[:-1], min=1e-30)
    r = torch.arange(nbins - 2, -1, -1)
    mean2 = rev_pc[r] / torch.clamp(rev_w[r], min=1e-30)
    gap = mean1 - mean2
    v12 = (w1[:-1] * rev_w[r]) * (gap * gap)
    _, idx = block_argmax(v12.numpy())
    criterion = v12[idx]
    otsu = centres[idx] if any_valid else torch.tensor(0.0)
    _, arg_peak = block_argmax(p.numpy())
    peak_height = p[arg_peak]
    nz = [k for k in range(nbins) if p[k] > 0]
    low, high = (min(nz), max(nz) + 1) if nz else (nbins, 0)  # the unsigned block range
    arg_low, arg_high = low, high - 1
    flip = (arg_peak - arg_low) < (arg_high - arg_peak)
    low_f = nbins - arg_high - 1 if flip else arg_low
    peak_f = nbins - arg_peak - 1 if flip else arg_peak
    width = torch.tensor(float(peak_f - low_f))
    norm = _fp.sqrt(_fp.fma_plain(peak_height, peak_height, width * width))
    ph = peak_height / torch.clamp(norm, min=1e-30)
    wd = width / torch.clamp(norm, min=1e-30)
    hist_f = p.flip(0) if flip else p
    k = torch.arange(nbins)
    length = torch.where((k >= low_f) & (k < peak_f),
                         _fp.fma_plain(ph, (k - low_f).float(), -(wd * hist_f)), -float("inf"))
    level = block_argmax(length.numpy())[1] if peak_f > low_f and low_f < nbins else low_f
    if flip:
        level = nbins - level - 1
    tri = centres[level] if any_valid else torch.tensor(0.0)
    return otsu, criterion, tri, torch.minimum(tri, otsu), any_valid, flip


N_VALUES = 4000


def sample(kind, seed, n=N_VALUES):
    rng = np.random.default_rng(seed)
    if kind == "bimodal":
        v = np.concatenate([rng.normal(1.0, 0.3, n - n // 3), rng.gamma(2.0, 2.0, n // 3)])
    elif kind == "peak_low":  # a peak near the low end: the triangle flips
        v = rng.gamma(1.5, 1.0, n)
    elif kind == "peak_high":  # a peak near the high end: no flip
        v = 10.0 - rng.gamma(1.5, 1.0, n)
    elif kind == "log":  # Label's log10 domain, negative values
        v = np.log10(rng.gamma(2.0, 1e-3, n) + 1e-6)
    elif kind == "equal":
        v = np.full(n, 0.75)
    elif kind == "two_bins":
        v = np.where(rng.random(n) < 0.3, 2.0, 5.0)
    else:
        raise ValueError(kind)
    return v.astype(np.float32)


# the reference's functions, jitted once each (nbins static)
REFERENCE = {name: jax.jit(getattr(j_thr, name), static_argnames=("nbins",))
             for name in ("otsu_threshold", "triangle_threshold", "min_triangle_otsu")}


def reference(v, m, nbins):
    """(Otsu, criterion, triangle, min) of the reference's jitted functions."""
    jv, jm = jnp.asarray(v), None if m is None else jnp.asarray(m)
    ots = REFERENCE["otsu_threshold"](jv, jm, nbins=nbins)
    return (ots[0], ots[1], REFERENCE["triangle_threshold"](jv, jm, nbins=nbins),
            REFERENCE["min_triangle_otsu"](jv, jm, nbins=nbins))


def plain_bodies(tv, tm, nbins):
    """(Otsu, criterion, triangle, min) of the plain bodies, and
    ``triangle_and_otsu_plain``'s pair."""
    ots = thresholds.otsu_threshold_plain(tv, tm, nbins)
    return ((ots[0], ots[1], thresholds.triangle_threshold_plain(tv, tm, nbins),
             thresholds.min_triangle_otsu_plain(tv, tm, nbins)),
            thresholds.triangle_and_otsu_plain(tv, tm, nbins))


# (values, mask rule, nbins)
CASES = {
    "bimodal": ("bimodal", "random", 256),
    "peak_low": ("peak_low", "random", 256),
    "peak_high": ("peak_high", "random", 256),
    "log_no_mask": ("log", None, 256),
    "empty_mask": ("bimodal", "none", 256),
    "span_0": ("equal", "random", 256),
    "one_value": ("bimodal", "one", 256),
    "two_bins": ("two_bins", "random", 256),
    "bins_100": ("bimodal", "random", 100),
    "bins_1000": ("peak_low", "random", 1000),
    "bins_10000": ("bimodal", "random", 10000),
}


def mask_of(rule, n, seed):
    rng = np.random.default_rng(seed + 100)
    if rule is None:
        return None
    m = {"random": rng.random(n) < 0.8, "none": np.zeros(n, bool),
         "one": np.arange(n) == 17}[rule]
    return m


# the Filter's samples, stride_mask(shape, strides) & (frame > 0), at the 3D
# frame's strides (2, 2, 2) and the capacity window's (4, 4, 4), on frames
# with non-positive voxels whose size is not a multiple of 16: (shape,
# stride, mask rule, nbins); "empty" has no positive voxel, "full" masks
# every value, "nan" masks in a NaN
STRIDE_CASES = {
    "3D stride 2": ((15, 24, 41), 2, "positive", 256),
    "capacity stride 4": ((25, 28, 43), 4, "positive", 256),
    "3D stride 2, empty": ((15, 24, 41), 2, "empty", 256),
    "capacity stride 4, full mask": ((25, 28, 43), 4, "full", 256),
    "3D stride 2, NaN": ((15, 24, 41), 2, "nan", 256),
    "capacity stride 4, 9000 bins": ((25, 28, 43), 4, "positive", 9000),
}


def stride_sample(shape, stride, rule, seed):
    """(frame float32, mask bool) numpy arrays of a Filter-like sample."""
    rng = np.random.default_rng(seed + 200)
    v = rng.normal(0.3, 1.0, shape).astype(np.float32)
    if rule == "empty":
        v = -np.abs(v)
    m = thresholds.stride_mask(shape, (stride,) * 3, "cpu").numpy() & (v > 0)
    if rule == "full":
        m[:] = True
    if rule == "nan":
        v[2, 4, 6] = np.nan
        m[2, 4, 6] = True
    return v, m


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    """{case: (plain, model, reference, the plain pair)}; the first three
    each a tuple (Otsu, criterion, triangle, min)."""
    out = {}
    inputs = {name: (sample(kind, k), rule, nbins)
              for k, (name, (kind, rule, nbins)) in enumerate(CASES.items())}
    inputs = {name: (v, mask_of(rule, v.size, k), nbins)
              for k, (name, (v, rule, nbins)) in enumerate(inputs.items())}
    for k, (name, (shape, stride, rule, nbins)) in enumerate(STRIDE_CASES.items()):
        inputs[name] = (*stride_sample(shape, stride, rule, k), nbins)
    for name, (v, m, nbins) in inputs.items():
        tv, tm = torch.from_numpy(v), None if m is None else torch.from_numpy(m)
        plain_four, pair = plain_bodies(tv, tm, nbins)
        model = hist_threshold_model(tv, tm, nbins)
        out[name] = (plain_four, model, reference(v, m, nbins), pair)
    return out


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def same(got, want):
    """Equal float32 bits, or both NaN."""
    got, want = np.float32(got), np.float32(want)
    return bool(bits(got) == bits(want) or (np.isnan(got) and np.isnan(want)))


ALL_CASES = list(CASES) + list(STRIDE_CASES)


@pytest.mark.parametrize("name", ALL_CASES)
def test_model_equals_plain(runs, name):
    plain, model, _, _ = runs[name]
    for got, want in zip(model[:4], plain):
        assert same(got, want)


@pytest.mark.parametrize("name", ALL_CASES)
def test_plain_equals_reference(runs, name):
    plain, _, ref, _ = runs[name]
    for got, want in zip(plain, ref):
        assert same(got, want)


@pytest.mark.parametrize("name", ALL_CASES)
def test_triangle_and_otsu_equals_reference(runs, name):
    _, _, ref, (tri, ots) = runs[name]
    assert same(tri, ref[2]) and same(ots, ref[0])


# bin counts of every form of XLA's sum: up to 32 counts, single counts past
# 32 (one and two window levels, padding split odd and even), rows of 16 up
# to 32 rows and past them (one and two levels)
TOTAL_BINS = (2, 15, 16, 31, 32, 33, 40, 63, 100, 255, 256, 300, 512, 528, 1000, 1024, 1100,
              10000, 16400, 70000)


@pytest.mark.parametrize("nbins", TOTAL_BINS)
def test_counts_total_is_xlas_sum(nbins):
    """The reference sums its counts as the (nbins / 16, 16) matmul product
    where nbins is a multiple of 16, else as the 1-D slice of it."""
    rng = np.random.default_rng(nbins)
    counts = rng.integers(0, 2 ** 21, nbins).astype(np.float32)
    shape = (nbins // 16, 16) if nbins % 16 == 0 else (nbins,)
    want = jax.jit(jnp.sum)(jnp.asarray(counts.reshape(shape)))
    assert bits(thresholds.counts_total(torch.from_numpy(counts))) == bits(want)
    if nbins <= 10000:
        assert bits(xla_total(torch.from_numpy(counts))) == bits(want)


def test_past_2_24_masked_values(one_torch_thread):  # noqa: F811
    """2^24 + 2^21 masked values (of 2^24 + 2^22): the counts' float32
    total rounds, in XLA's order, to another value than the exact one, and
    the plain histogram with Otsu and the triangle on it, and the kernel's
    model, still equal the reference."""
    n = 2 ** 24 + 2 ** 22
    rng = np.random.default_rng(24)
    v = (rng.random(n, dtype=np.float32) ** 2).astype(np.float32)
    m = np.ones(n, bool)
    m[rng.choice(n, 2 ** 21, replace=False)] = False
    tv, tm = torch.from_numpy(v), torch.from_numpy(m)
    hist = thresholds._masked_histogram(tv, tm, 256)
    counts, total = hist[0], hist[3]
    assert int(counts.double().sum()) == int(m.sum()) > 2 ** 24
    assert float(total) != float(int(m.sum()))
    got = (*thresholds._otsu_from_hist(*hist), thresholds._triangle_from_hist(*hist))
    jv, jm = jnp.asarray(v), jnp.asarray(m)
    ref = (*REFERENCE["otsu_threshold"](jv, jm, nbins=256),
           REFERENCE["triangle_threshold"](jv, jm, nbins=256))
    del jv, jm
    model = hist_threshold_model(tv, tm, 256)
    for g, w in zip(got, ref):
        assert bits(g) == bits(w)
    for g, w in zip(model[:3], ref):
        assert bits(g) == bits(w)


def test_cases_reach_their_edges(runs):
    """Both triangle flips, no masked value, one masked value and a span
    of 0 are among the cases; a masked NaN makes every result NaN, and the
    empty stride sample gives 0 for both thresholds."""
    assert runs["peak_low"][1][5] and not runs["peak_high"][1][5]
    assert not runs["empty_mask"][1][4] and runs["one_value"][1][4]
    assert float(runs["empty_mask"][0][0]) == float(runs["empty_mask"][0][2]) == 0.0
    assert float(runs["span_0"][0][0]) == float(runs["span_0"][0][2]) == 0.75
    assert all(np.isnan(float(x)) for x in runs["3D stride 2, NaN"][0])
    assert not runs["3D stride 2, empty"][1][4]
    assert float(runs["3D stride 2, empty"][0][3]) == 0.0


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n", [0, 5, 16, 37, 1000])
def test_masked_visits(n, vec):
    """The mask-led walk hands on every masked value once, whatever the
    mask's length modulo 16, with mask words of one, some and no set
    bytes."""
    rng = np.random.default_rng(n)
    m = rng.random(n) < rng.choice([0.05, 0.5])
    visits = masked_visits(m, vec)
    assert np.array_equal(np.sort(visits), np.flatnonzero(m))


@pytest.mark.parametrize("nbins", [2, 16, 17, 256, 257, 4113])
def test_level_scans_are_cumsum_f32(nbins):
    """The tail's level-by-level scans equal ``cumsum_f32`` (one to three
    levels of block totals, a short last block)."""
    rng = np.random.default_rng(nbins)
    x = torch.from_numpy((rng.random(nbins) * 10.0 ** rng.uniform(-3, 3, nbins))
                         .astype(np.float32))
    assert torch.equal(level_scans([x])[0], thresholds.cumsum_f32(x))


def test_block_argmax_is_torchs():
    """The block reduction keeps torch.argmax's choice: ties to the first
    index, NaN first, -inf and -0 against +0."""
    rng = np.random.default_rng(5)
    for x in (np.zeros(300, np.float32), np.full(300, -np.inf, np.float32),
              np.array([0.0, -0.0, 0.0], np.float32),
              np.where(rng.random(1000) < 0.1, 3.0, 1.0).astype(np.float32),
              np.where(np.arange(700) % 300 == 299, np.nan, rng.random(700)).astype(np.float32)):
        assert block_argmax(x)[1] == int(torch.argmax(torch.from_numpy(x)))


def test_cpu_tensor_takes_the_plain_body(runs):
    v = torch.from_numpy(sample("bimodal", 0))
    m = torch.from_numpy(mask_of("random", v.numel(), 0))
    before = thresholds.HIST_THRESHOLD_KERNEL.launches
    got = (*thresholds.otsu_threshold(v, m), thresholds.triangle_threshold(v, m),
           thresholds.min_triangle_otsu(v, m))
    pair = thresholds.triangle_and_otsu(v, m)
    assert thresholds.HIST_THRESHOLD_KERNEL.launches == before
    for g, w in zip(got, runs["bimodal"][0]):
        assert bits(g) == bits(w)
    for g, w in zip(pair, runs["bimodal"][3]):
        assert bits(g) == bits(w)


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(TypeError):
        thresholds.HIST_THRESHOLD_KERNEL(torch.ones(10), None)
