"""The histogram thresholds: the port's plain bodies against the JAX
package, and the threshold kernel's schedule in torch against them.

``thresholds.otsu_threshold_plain``, ``triangle_threshold_plain`` and
``min_triangle_otsu_plain`` (the CPU paths of the three thresholds) equal
the reference's jitted functions bit for bit.  ``hist_threshold_model``
(``kernels/csrc/hist_threshold.cu``'s schedule in torch: the masked
minimum and maximum as ordered integer keys, integer counts of the float32
bin index, then the last block's tail: the counts' total in XLA's order
by one thread, p and the centres one bin a thread, the four blocked prefix
sums, the first argmax of Otsu's variance, the triangle's bins and its
first argmax, the minimum of the two) equals the plain bodies: skewed and
bimodal samples, the triangle's peak near either end (both flips), no
mask, an empty mask, every value equal (a span of 0), one masked value,
all values in two bins, and 100, 1,000 and 10,000 bins (two and three
levels of block totals, the total over single counts and over rows of 16).
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


def first_argmax(x):
    """torch.argmax's choice: the first maximum, the first NaN before all."""
    idx = 0
    for b in range(1, len(x)):
        v, best = float(x[b]), float(x[idx])
        if (np.isnan(v) and not np.isnan(best)) or (not np.isnan(best) and v > best):
            idx = b
    return idx


def blocked_scan(x):
    """``cumsum_f32``'s order, as the kernel's one thread runs it."""
    n = len(x)
    if n <= SCAN_BLOCK:
        out, acc = [x[0]], x[0]
        for k in range(1, n):
            acc = acc + x[k]
            out.append(acc)
        return torch.stack(out)
    nb = -(-n // SCAN_BLOCK)
    pad = torch.cat([x, torch.zeros(nb * SCAN_BLOCK - n)])
    inner = []
    for k in range(nb):
        inner.extend(blocked_scan(pad[k * SCAN_BLOCK:(k + 1) * SCAN_BLOCK]))
    inner = torch.stack(inner)
    scanned = blocked_scan(inner[SCAN_BLOCK - 1::SCAN_BLOCK].clone())
    offset = torch.cat([torch.zeros(1), scanned[:-1]]).repeat_interleave(SCAN_BLOCK)
    return (inner + offset)[:n]


def xla_total(counts):
    """The counts' total as the kernel's one thread sums it: over rows of
    16 counts where nbins is a multiple of 16, else single counts; windows
    of 32 rows, half the padding (rounded down) before the first, written
    over the front of the array, while more than 32 rows remain; then the
    rest in order."""
    x = [np.float32(c) for c in counts.tolist()]
    n = len(x)
    unit = 16 if n % 16 == 0 else 1
    rows = n // unit
    while rows > 32:
        pad = -rows % 32
        first, width, length = -(pad // 2) * unit, 32 * unit, rows * unit
        windows = (rows + pad) // 32
        for w in range(windows):
            acc = np.float32(0)
            for k in range(w * width + first, w * width + first + width):
                if 0 <= k < length:
                    acc = np.float32(acc + x[k])
            x[w] = acc
        unit, rows = 1, windows
    acc = x[0]
    for k in range(1, rows * unit):
        acc = np.float32(acc + x[k])
    return torch.tensor(acc)


def hist_threshold_model(values, mask, nbins=256):
    """``hist_threshold.cu`` in torch on the CPU: (Otsu, criterion,
    triangle, min(triangle, Otsu), any masked value)."""
    f = values.reshape(-1).float()
    m = torch.ones(f.shape, dtype=torch.bool) if mask is None else mask.reshape(-1)
    sel = f[m].numpy()
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
    w1, s_pc = blocked_scan(p), blocked_scan(pc)
    rev_w, rev_pc = blocked_scan(p.flip(0)), blocked_scan(pc.flip(0))
    # one bin a thread: v12[k] from w1[k] and the reversed scans at n - 2 - k
    mean1 = s_pc[:-1] / torch.clamp(w1[:-1], min=1e-30)
    r = torch.arange(nbins - 2, -1, -1)
    mean2 = rev_pc[r] / torch.clamp(rev_w[r], min=1e-30)
    gap = mean1 - mean2
    v12 = (w1[:-1] * rev_w[r]) * (gap * gap)
    idx = first_argmax(v12)
    otsu = centres[idx] if any_valid else torch.tensor(0.0)
    arg_peak = first_argmax(p)
    nz = [k for k in range(nbins) if p[k] > 0]
    arg_low, arg_high = (nz[0], nz[-1]) if nz else (nbins, -1)
    flip = (arg_peak - arg_low) < (arg_high - arg_peak)
    low_f = nbins - arg_high - 1 if flip else arg_low
    peak_f = nbins - arg_peak - 1 if flip else arg_peak
    width = torch.tensor(float(peak_f - low_f))
    norm = _fp.sqrt(_fp.fma_plain(p[arg_peak], p[arg_peak], width * width))
    ph = p[arg_peak] / torch.clamp(norm, min=1e-30)
    wd = width / torch.clamp(norm, min=1e-30)
    hist_f = p.flip(0) if flip else p
    k = torch.arange(nbins)
    length = torch.where((k >= low_f) & (k < peak_f),
                         _fp.fma_plain(ph, (k - low_f).float(), -(wd * hist_f)), -float("inf"))
    level = first_argmax(length) if peak_f > low_f and low_f < nbins else low_f
    if flip:
        level = nbins - level - 1
    tri = centres[level] if any_valid else torch.tensor(0.0)
    return otsu, v12[idx], tri, torch.minimum(tri, otsu), any_valid, flip


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


@pytest.fixture(scope="module")
def runs(one_torch_thread):  # noqa: F811
    """{case: (plain, model, reference, the plain pair)}; the first three
    each a tuple (Otsu, criterion, triangle, min)."""
    out = {}
    for k, (name, (kind, rule, nbins)) in enumerate(CASES.items()):
        v = sample(kind, k)
        m = mask_of(rule, v.size, k)
        tv, tm = torch.from_numpy(v), None if m is None else torch.from_numpy(m)
        plain_four, pair = plain_bodies(tv, tm, nbins)
        model = hist_threshold_model(tv, tm, nbins)
        out[name] = (plain_four, model, reference(v, m, nbins), pair)
    return out


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_model_equals_plain(runs, name):
    plain, model, _, _ = runs[name]
    for got, want in zip(model[:4], plain):
        assert bits(got) == bits(want)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_reference(runs, name):
    plain, _, ref, _ = runs[name]
    for got, want in zip(plain, ref):
        assert bits(got) == bits(want)


@pytest.mark.parametrize("name", list(CASES))
def test_triangle_and_otsu_equals_reference(runs, name):
    _, _, ref, (tri, ots) = runs[name]
    assert bits(tri) == bits(ref[2]) and bits(ots) == bits(ref[0])


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
    of 0 are among the cases."""
    assert runs["peak_low"][1][5] and not runs["peak_high"][1][5]
    assert not runs["empty_mask"][1][4] and runs["one_value"][1][4]
    assert float(runs["empty_mask"][0][0]) == float(runs["empty_mask"][0][2]) == 0.0
    assert float(runs["span_0"][0][0]) == float(runs["span_0"][0][2]) == 0.75


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
