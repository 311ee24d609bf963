"""The 1-D correlation of the Filter's Gaussian cascade and of the LoG: the
port's plain versions against the JAX package's, bit for bit on the CPU,
and ``kernel_model`` (``csrc/gauss_axis.cu``'s loop: the tap list, the
reflected index, the multiply-add chain) against the plain versions, so that the kernel's arithmetic is held on the CPU too (the
kernel itself, on the card: ``tests/test_torch_gauss_axis_cuda.py``).

The LoG is held where its taps are shorter than the axis, with the sigmas
of ``test_torch_segmentation.test_filters_bitwise`` and others; where its
reflected taps reach past the axis's extent, in
``tests/test_torch_log_programs.py``.  Jitted alone in 3D,
``gaussian_laplace`` at a sigma of exactly 1 along an axis (0.4, 1, 1 or
1, 2, 2) shares the order-0 and order-2 centre products of one input in
XLA's last fusion, which never contracts them (``filters.log_program``):
those sigmas are cases too, and ``kernel_model`` reads a centre tap from
another tensor as the kernel does for that program.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_port_data as D  # noqa: F401 — puts the repo on the path
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import filters as j_filters
from nellie_tpu_torch.kernels import filters, frangi

PARAMS = {3: frangi.FrangiParams(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2),
                                 z_ratio=2.5),
          2: frangi.FrangiParams(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
SHAPES = [(12, 48, 48), (5, 16, 128), (64, 128), (3, 200)]
LOG_SHAPES = [(12, 48, 48), (24, 32, 128), (64, 128)]  # every tap radius below the extent
LOG_TAPS = [(1.0, 0), (1.0, 2), (2.5, 2), (0.3, 0)]


def kernel_model(x, taps, axis, round_half=False, shared=None, centre=None):
    """``csrc/gauss_axis.cu`` in torch: each output reads tap k at the
    reflected index i + offset_k (numpy's "symmetric") and sums
    fma(x0, w0, x1 * w1), then fma(xk, wk, acc), rounding once a step; at
    the positions where ``shared`` (``filters.shared_products``' table)
    flags a tap, its product is rounded and added (for the first add the
    other product is contracted, or neither); the tap at offset 0 reads
    ``centre`` where given; optionally rounded through float16."""
    from nellie_tpu_torch.kernels._fp import fma_plain

    n = x.shape[axis]
    i = torch.arange(n, device=x.device)

    def at(offset):
        if offset == 0 and centre is not None:
            return centre
        m = torch.remainder(i + offset, 2 * n)
        return torch.index_select(x, axis, torch.where(m < n, m, 2 * n - 1 - m))

    def flag(k):  # tap k's flags broadcast along the axis
        col = torch.zeros(n, dtype=torch.bool) if shared is None else \
            torch.from_numpy(np.ascontiguousarray(shared[:, k]))
        return col.reshape([n if a == axis else 1 for a in range(x.ndim)])

    (o0, w0), rest = taps[0], taps[1:]
    if not rest:
        acc = at(o0) * w0
    else:
        (o1, w1) = rest[0]
        p0, p1 = at(o0) * w0, at(o1) * w1
        acc = torch.where(flag(0) & flag(1), p0 + p1,
                          torch.where(flag(0), fma_plain(at(o1), w1, p0),
                                      fma_plain(at(o0), w0, p1)))
        for k, (o, w) in enumerate(rest[1:], start=2):
            acc = torch.where(flag(k), acc + at(o) * w, fma_plain(at(o), w, acc))
    return acc.half().float() if round_half else acc


def _chain(reads, weights, flags):
    """The kernel's sum of one output's taps in torch: ``reads[k]`` the
    values tap k reads, ``flags[k]`` a bool tensor broadcastable to them
    (the tap's product rounded and added) or None."""
    from nellie_tpu_torch.kernels._fp import fma_plain

    if len(reads) == 1:
        return reads[0] * weights[0]
    no = [torch.zeros((), dtype=torch.bool) if f is None else f for f in flags]
    p0, p1 = reads[0] * weights[0], reads[1] * weights[1]
    acc = torch.where(no[0] & no[1], p0 + p1,
                      torch.where(no[0], fma_plain(reads[1], weights[1], p0),
                                  fma_plain(reads[0], weights[0], p1)))
    for r, w, f in zip(reads[2:], weights[2:], no[2:]):
        acc = torch.where(f, acc + r * w, fma_plain(r, w, acc))
    return acc


def _reflect(idx, n):
    m = np.remainder(idx, 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


SEG, THREADS = 32, 256  # gauss_axis.cu: output rows an outer-axis tile, threads a block


def tile_model(x, taps, axis, round_half=False, shared=None, centre=None, vec=4):
    """``csrc/gauss_axis.cu``'s tile plan in torch.  Along an outer axis
    (inner extent > 1) a tile holds SEG output rows with the taps' reach on
    both sides: rows seg0 - reach + r, read as they are where every one lies
    in the axis (an interior tile) and reflected otherwise; output row m of
    the segment reads tile row m + reach + offset (the unrolled instances
    stream the same rows through a window).  Along the last axis a tile
    holds ``span`` positions with ``margin`` (the reach rounded up to the
    copy width) on both sides, copied a chunk of ``vec`` at a time: as it is
    where the chunk lies in the line, reflected element by element
    otherwise.  Sums by :func:`_chain` with ``shared``'s flags a position;
    the tap at offset 0 reads ``centre`` where given.  Returns the output
    and the (interior, edge) tiles walked."""
    axis %= x.ndim
    n = x.shape[axis]
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    v = x.reshape(-1, n, inner)
    cen = None if centre is None else centre.reshape(-1, n, inner)
    weights = [w for _, w in taps]
    reach = max(abs(o) for o, _ in taps)
    out = torch.empty_like(v)
    tiles = [0, 0]

    def flags(k, rows):
        if shared is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(shared[rows, k]))

    if inner > 1:
        for seg0 in range(0, n, SEG):
            m = np.arange(min(SEG, n - seg0))
            rows = np.arange(seg0 - reach, seg0 - reach + len(m) + 2 * reach)
            interior = rows[0] >= 0 and rows[-1] < n
            tiles[0 if interior else 1] += 1
            tile = v[:, torch.from_numpy(rows if interior else _reflect(rows, n))]
            reads = [cen[:, torch.from_numpy(seg0 + m)] if o == 0 and cen is not None
                     else tile[:, torch.from_numpy(m + reach + o)] for o, _ in taps]
            fl = [None if flags(k, seg0 + m) is None else flags(k, seg0 + m)[None, :, None]
                  for k in range(len(taps))]
            out[:, torch.from_numpy(seg0 + m)] = _chain(reads, weights, fl)
    else:
        line = v.reshape(-1, n)
        res = out.reshape(-1, n)
        cl = None if cen is None else cen.reshape(-1, n)
        span = -(-min(n, THREADS * vec) // vec) * vec
        margin = -(-reach // vec) * vec
        for seg0 in range(0, n, span):
            pos = np.arange(seg0 - margin, seg0 + span + margin)
            interior = pos[0] >= 0 and pos[-1] < n
            tiles[0 if interior else 1] += 1
            chunks = pos.reshape(-1, vec)
            inside = (chunks[:, :1] >= 0) & (chunks[:, -1:] < n)
            src = np.where(inside, chunks, _reflect(chunks, n)).reshape(-1)
            assert not interior or (src == pos).all()
            tile = line[:, torch.from_numpy(src)]
            q = np.arange(seg0, min(seg0 + span, n))
            reads = [cl[:, torch.from_numpy(q)] if o == 0 and cl is not None
                     else tile[:, torch.from_numpy(q - seg0 + margin + o)] for o, _ in taps]
            fl = [None if flags(k, q) is None else flags(k, q)[None, :]
                  for k in range(len(taps))]
            res[:, torch.from_numpy(q)] = _chain(reads, weights, fl)
    out = out.reshape(x.shape)
    return (out.half().float() if round_half else out), tuple(tiles)


def assert_bitwise(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    differ = got.view(np.int32) != want.view(np.int32)
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def frame(request):
    return chip_smoke.filter_frame(request.param, seed=len(request.param))


@pytest.mark.parametrize("carry", ["float32", "float16"])
def test_cascade_correlation_bitwise(frame, carry):
    """Each scale's padded taps along each axis, the result in the carry
    type (the JAX cascade's ``.astype(carry)``)."""
    dtype = {"float32": jnp.float32, "float16": jnp.float16}[carry]
    for axis in range(frame.ndim):
        for w in frangi._delta_kernels(PARAMS[frame.ndim], frame.ndim)[axis]:
            want = jax.jit(lambda x: j_filters.correlate1d_traced(x, w, axis).astype(dtype)
                           .astype(jnp.float32))(frame)
            got = filters.correlate1d_traced(torch.from_numpy(frame), w, axis,
                                             frangi.CARRY_DTYPES[carry])
            assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("shape", LOG_SHAPES)
def test_log_correlation_bitwise(shape):
    frame = chip_smoke.filter_frame(shape, seed=len(shape))
    for axis in range(frame.ndim):
        for sigma, order in LOG_TAPS:
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            want = jax.jit(lambda x: j_filters._correlate1d(x, w, axis))(frame)
            assert_bitwise(filters._correlate1d(torch.from_numpy(frame), w, axis).numpy(), want)


@pytest.mark.parametrize("shape,sigma", [((12, 48, 48), (0.7, 1.6, 1.3)),
                                         ((24, 32, 128), (0.5, 1.25, 1.25)),
                                         ((64, 128), (1.0, 1.0)), ((64, 128), (0.5, 0.5)),
                                         ((12, 48, 48), (0.4, 1.0, 1.0)),
                                         ((12, 48, 48), (1.0, 2.0, 2.0)),
                                         ((12, 48, 48), (1.0, 1.0, 1.0)),
                                         ((10, 40, 56), (0.5, 1.0, 2.0)),
                                         ((64, 128), (2.0, 1.0))])
def test_gaussian_laplace_bitwise(shape, sigma):
    frame = chip_smoke.filter_frame(shape, seed=len(shape))
    want = jax.jit(lambda x: j_filters.gaussian_laplace(x, sigma))(frame)
    assert_bitwise(filters.gaussian_laplace(torch.from_numpy(frame), sigma).numpy(), want)


@pytest.mark.parametrize("round_half", [False, True])
def test_kernel_model_equals_plain(frame, round_half):
    """The kernel's loop, in torch, on the taps its wrapper passes."""
    x = torch.from_numpy(frame)
    for axis in range(x.ndim):
        for w in frangi._delta_kernels(PARAMS[x.ndim], x.ndim)[axis]:
            want = filters.correlate1d_traced_plain(x, w, axis)
            want = want.half().float() if round_half else want
            got = kernel_model(x, filters.traced_taps(w), axis, round_half)
            assert_bitwise(got.numpy(), want.numpy())
        for sigma, order in LOG_TAPS:
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            taps = filters.nonzero_taps(w)
            got = kernel_model(x, taps, axis,
                               shared=filters.shared_products(x.shape[axis], taps,
                                                              axis == x.ndim - 1))
            assert_bitwise(got.numpy(), filters._correlate1d_plain(x, w, axis).numpy())


def test_kernel_model_reads_the_centre():
    """The LoG program's passes (``filters.log_program``): taps flagged at
    every position and a centre read from another tensor, in the kernel's
    loop, equal ``_correlate1d_plain`` with the same flags and centre."""
    x = torch.from_numpy(chip_smoke.filter_frame((6, 20, 24), seed=4))
    other = torch.from_numpy(chip_smoke.filter_frame((6, 20, 24), seed=5))
    for axis in range(3):
        for sigma, order in LOG_TAPS + [(1.0, 2)]:
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            taps = filters.nonzero_taps(w)
            flags = [o == 0 or k % 3 == 1 for k, (o, _) in enumerate(taps)]
            table = filters.shared_products(x.shape[axis], taps, axis == 2)
            table = np.broadcast_to(np.asarray(flags), (x.shape[axis], len(taps))) | (
                False if table is None else table)
            got = kernel_model(x, taps, axis, shared=table, centre=other)
            want = filters._correlate1d_plain(x, w, axis, flags, centre=other)
            assert_bitwise(got.numpy(), want.numpy())


def test_tap_lists():
    w = np.array([0.0, 0.25, 0.0, 0.5, 0.25], np.float64)
    assert filters.nonzero_taps(w) == [(-1, 0.25), (1, 0.5), (2, 0.25)]
    assert [o for o, _ in filters.traced_taps(w)] == [-2, -1, 0, 1, 2]
    assert filters.nonzero_taps(np.array([0.0])) == [(0, 0.0)]
    assert filters.nonzero_taps(np.zeros(3)) == []
    x = torch.arange(10.0).reshape(2, 5)
    assert torch.equal(filters._correlate1d(x, np.zeros(3), 1), torch.zeros_like(x))
    with pytest.raises(ValueError):
        filters.correlate1d_traced(x.to("meta"), w, 1)


def _weights_of(taps):
    """A weight array whose nonzero taps (``filters.nonzero_taps``) are ``taps``."""
    reach = max(abs(o) for o, _ in taps)
    w = np.zeros(2 * reach + 1, np.float64)
    for o, wt in taps:
        w[o + reach] = wt
    return w


def _taps_of_reach(reach, seed):
    """Taps reaching ``reach``: -r..r for the short reaches (the unrolled
    instances' lists), a sparse list past them (the run-time loop's)."""
    rng = np.random.default_rng(seed)
    offsets = list(range(-reach, reach + 1)) if reach <= 12 else [-reach, -5, -1, 0, 2, reach]
    return [(o, float(np.float32(rng.uniform(0.05, 1.0) * rng.choice([-1, 1]))))
            for o in offsets]


# (shape, axis): inner extents 5, 6 and 1 (a 2-D frame along its first axis
# of one column), last axes of 301 (4-byte chunks), 2,100 (16-byte chunks,
# three tiles, one of them interior) and 40; axes long enough for interior
# tiles at the short reaches
TILE_CASES = [((70, 5), 0), ((3, 37, 6), 1), ((4, 301), 1), ((2, 2100), 1), ((40, 1), 0),
              ((3, 40), 1), ((150, 3), 0)]


@pytest.mark.parametrize("reach", [1, 2, 5, 12, 33, 64, 65, 128])
@pytest.mark.parametrize("shape,axis", TILE_CASES)
def test_tile_plan_equals_plain(shape, axis, reach):
    """The kernel's tile plan, edge tiles reflected and interior tiles
    not, at reaches from 1 to 128, equals the plain correlation; the
    16-byte chunks along a last axis only where it is a multiple of 4."""
    x = torch.from_numpy(chip_smoke.filter_frame(shape, seed=reach))
    taps = _taps_of_reach(reach, seed=reach)
    w = _weights_of(taps)
    n = shape[axis]
    last = axis == len(shape) - 1 or int(np.prod(shape[axis + 1:])) == 1
    vec = 4 if n % 4 == 0 else 1
    shared = filters.shared_products(n, taps, axis == len(shape) - 1)
    got, tiles = tile_model(x, taps, axis, shared=shared, vec=vec if last else 4)
    assert_bitwise(got.numpy(), filters._correlate1d_plain(x, w, axis).numpy())
    if reach <= 12 and shape in ((150, 3), (2, 2100)):  # both kinds of tile
        assert tiles[0] > 0 and tiles[1] > 0
    if reach <= 12:  # every tap kept: the traced pass, rounded through float16
        got, _ = tile_model(x, taps, axis, round_half=True, vec=vec if last else 4)
        want = filters.correlate1d_traced_plain(x, w.astype(np.float32), axis)
        assert_bitwise(got.numpy(), want.half().float().numpy())


def test_tile_plan_reads_the_centre():
    """The LoG program's passes in the tile plan: flags at every position
    and the centre from another tensor."""
    x = torch.from_numpy(chip_smoke.filter_frame((40, 6), seed=4))
    other = torch.from_numpy(chip_smoke.filter_frame((40, 6), seed=5))
    for axis in range(2):
        w = filters.gaussian_kernel1d(1.0, 4.0, order=2)
        taps = filters.nonzero_taps(w)
        flags = [o == 0 or k % 3 == 1 for k, (o, _) in enumerate(taps)]
        table = filters.shared_products(x.shape[axis], taps, axis == 1)
        table = np.broadcast_to(np.asarray(flags), (x.shape[axis], len(taps))) | (
            False if table is None else table)
        got, _ = tile_model(x, taps, axis, shared=table, centre=other,
                            vec=4 if x.shape[axis] % 4 == 0 else 1)
        want = filters._correlate1d_plain(x, w, axis, flags, centre=other)
        assert_bitwise(got.numpy(), want.numpy())


@pytest.mark.parametrize("n,last_axis", [(5, False), (2, True), (40, False), (3, True)])
def test_flag_table_cache(n, last_axis):
    """``filters.flag_table``'s key (n, taps, last axis, tap flags, device)
    and contents: ``shared_products`` | the tap flags at every position,
    packed 32 taps a word; made once a key."""
    for sigma, order in ((1.0, 2), (1.5, 0), (0.3, 0)):
        taps = filters.nonzero_taps(filters.gaussian_kernel1d(sigma, 4.0, order=order))
        for tap_flags in (None, [o == 0 for o, _ in taps], [False] * len(taps)):
            table = filters.flag_table(n, taps, last_axis, tap_flags, "cpu")
            shared = filters.shared_products(n, taps, last_axis)
            want = None if shared is None else shared
            if tap_flags is not None and any(tap_flags):
                flags = np.broadcast_to(np.asarray(tap_flags), (n, len(taps)))
                want = flags if want is None else want | flags
            if want is None:
                assert table is None
                continue
            assert table.dtype == torch.int32 and table.shape == (n, (len(taps) + 31) // 32)
            bits = (table.numpy().view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
            assert np.array_equal(bits.reshape(n, -1)[:, :len(taps)].astype(bool), want)
            hits = filters._flag_table.cache_info().hits
            assert filters.flag_table(n, tuple(taps), last_axis, tap_flags, "cpu") is table
            assert filters._flag_table.cache_info().hits == hits + 1
