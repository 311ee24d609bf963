"""Marker matching: masked pairwise costs and mutual argmin under a cutoff.

Port of ``nellie_tpu/kernels/matching.py``: ``pair_stats`` (masked sums
for z-scoring each feature difference over distance-gated pairs),
``pair_costs`` (z-scored cost, row and column minima), ``_select_matches``
(the reference's union of row and column candidates under cost 1.0),
``match_frames_device`` (all marker pairs of a frame pair in one tile) and
``match_frames`` (``:179-269``), which walks tiles of ``tile_rows`` rows
of the later frame: phase A sums each tile's moments on the device and
adds the tiles' sums in float64 on the host, phase B z-scores every tile
with those global moments and keeps the row minima and, across tiles, the
first column minimum.  The tiles run in the reference's order with its
reductions, because a single big tile sums in another order and moves the
z-scored costs.

``pair_stats`` and ``pair_costs`` on CUDA tensors launch the hand-written
kernels ``csrc/pair_sums.cu`` and ``csrc/pair_costs.cu`` (built for
``sm_90a`` with ``nvcc`` on first use, bound through ``ctypes``; both gate
the pairs with ``csrc/pair_gate.cuh`` and work on the gated pairs only), or
raise; on CPU tensors they run :func:`pair_stats_plain` and
:func:`pair_costs_plain`.  A call of ``pair_stats`` on the card is a memset,
one or two CUDA kernels and one read of its packed result; one of
``pair_costs`` is a memset and one CUDA kernel whose four results are views
of one device buffer, which ``match_frames_device`` reads in one copy
(:func:`to_host`): two host reads a frame pair, as the reference's packed
pulls.  ``PAIR_SUMS_KERNEL`` and ``PAIR_COSTS_KERNEL`` count their calls
(``launches``) and the CUDA kernels they launched (``kernel_launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CountedKernel, check_error, on_card
from nellie_tpu_torch.kernels._fp import (
    REDUCE_WINDOW,
    f32,
    fma,
    reduce_sum_of_squares,
    sqrt,
    tree_sum_2d,
)

COST_CUTOFF = 1.0


def _pair_mask_and_dist(coords_post, coords_pre, max_distance):
    diff = coords_post[:, None, :] - coords_pre[None, :, :]
    dist = sqrt(reduce_sum_of_squares(diff))
    # a divisor on the device: PyTorch's CUDA division by a number
    # multiplies by its reciprocal, which rounds otherwise
    max_d = torch.full((), f32(max_distance), dtype=torch.float32, device=dist.device)
    return dist / max_d, dist < max_d


def pair_stats_plain(coords_post, coords_pre, feats_post, feats_pre, max_distance, padded):
    """:func:`pair_stats` in plain torch.

    Each masked (rows, cols) sum is XLA's CPU tree reduction
    (:func:`_fp.tree_sum_2d`); its first level, the 32 x 32 windows, is
    taken here one window element at a time for every window and feature
    at once, so that no (rows, cols, F) array is built.  ``padded`` is the
    reference's padded tile (rows, cols): the window sums are padded with
    zero windows to its shape, on which the later levels' order depends."""
    dist_n, mask = _pair_mask_and_dist(coords_post, coords_pre, max_distance)
    w = REDUCE_WINDOW
    pad_r, pad_c = -mask.shape[0] % w, -mask.shape[1] % w
    mask = torch.nn.functional.pad(mask, (0, pad_c, 0, pad_r))
    dist_n = torch.nn.functional.pad(dist_n, (0, pad_c, 0, pad_r))
    feats_post = torch.nn.functional.pad(feats_post, (0, 0, 0, pad_r))
    feats_pre = torch.nn.functional.pad(feats_pre, (0, 0, 0, pad_c))
    sums = sumsqs = None
    for i in range(w):
        for j in range(w):
            d = torch.cat([dist_n[i::w, j::w, None],
                           (feats_post[i::w, None, :] - feats_pre[None, j::w, :]).abs()], dim=2)
            m = mask[i::w, j::w, None]
            v, v2 = torch.where(m, d, 0.0), torch.where(m, d * d, 0.0)
            sums = v if sums is None else sums + v
            sumsqs = v2 if sumsqs is None else sumsqs + v2
    grow = (0, 0, 0, padded[1] // w - sums.shape[1], 0, padded[0] // w - sums.shape[0])
    sums = torch.nn.functional.pad(sums, grow)
    sumsqs = torch.nn.functional.pad(sumsqs, grow)
    return (int(mask.sum()), tree_sum_2d(sums.permute(2, 0, 1)),
            tree_sum_2d(sumsqs.permute(2, 0, 1)))


def _raw_stream(dev):
    """The current CUDA stream of ``dev`` as the C entry points take it (the
    raw handle, without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(dev.index if dev.index is not None
                                               else torch.cuda.current_device())


class _PairSumsKernel(CountedKernel):
    """The compiled pair sums (``csrc/pair_sums.cu``), built once per
    process, with a launch count and a count of the CUDA kernels
    launched.  The packed result reaches a pinned host buffer kept for the
    next call on the same device and stream; the lock covers the launch and
    the read."""

    source = "pair_sums.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def __init__(self):
        super().__init__()
        self._host = {}  # (device index, stream, words): pinned int32 host buffer

    def bind(self, lib):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pair_sums_scratch.argtypes = [i32, i32, i32, i32, i32]
        lib.pair_sums_scratch.restype = i64
        lib.pair_sums_packed_words.argtypes = [i32]
        lib.pair_sums_packed_words.restype = i64
        lib.pair_sums.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32,
                                  i32, ptr, ptr, ctypes.POINTER(i32), ptr]
        lib.pair_sums.restype = i32
        lib.pair_sums_max_features.argtypes = []
        lib.pair_sums_max_features.restype = i32
        self.max_features = lib.pair_sums_max_features()

    def __call__(self, coords_post, coords_pre, feats_post, feats_pre, max_distance, padded):
        """(count, sums, sumsqs), the sums float32 tensors on the host, by
        one C call (a memset and one or two CUDA kernels) and one copy of
        its packed result to the host; float32 CUDA tensors of one device,
        coordinates (n, 1-3) and features (n, F)."""
        args = (coords_post, coords_pre, feats_post, feats_pre)
        dev = _check_tile("pair_stats", *args)
        (n_post, ndim), n_pre, n_feat = coords_post.shape, coords_pre.shape[0], feats_post.shape[1]
        w = REDUCE_WINDOW
        rows, cols = padded[0] // w, padded[1] // w
        if padded[0] % w or padded[1] % w or rows * w < n_post or cols * w < n_pre:
            raise ValueError(f"pair_stats: padded tile {tuple(padded)} is not a multiple of "
                             f"{w} holding {n_post} x {n_pre} pairs")
        lib = self._lib or self.build()
        if n_feat > self.max_features:
            raise ValueError(f"pair_stats on the card takes at most {self.max_features} "
                             f"features, not {n_feat}")
        s = n_feat + 1
        with self.on_device(dev):
            inputs = [a.contiguous() for a in args]
            words = lib.pair_sums_packed_words(n_feat)
            floats = lib.pair_sums_scratch(n_feat, rows, cols, n_post, n_pre)
            # one buffer: the packed result (count, sums, sums of squares,
            # two block counters), then the window sums
            buf = torch.empty(words + floats, dtype=torch.int32, device=dev)
            kernels = ctypes.c_int(0)
            stream = _raw_stream(dev)
            with self._lock:
                err = lib.pair_sums(*(a.data_ptr() for a in inputs), n_post, n_pre, ndim,
                                    n_feat, f32(max_distance), rows, cols,
                                    buf[words:].data_ptr(), buf.data_ptr(),
                                    ctypes.byref(kernels), stream)
                check_error("pair_sums launch", err)
                self.count_call(kernels.value)
                key = (dev.index, stream, 2 + 2 * s)
                host = self._host.get(key)
                if host is None:
                    host = self._host[key] = torch.empty(2 + 2 * s, dtype=torch.int32,
                                                         pin_memory=True)
                host.copy_(buf[:2 + 2 * s])  # the one read: waits for the kernels
                packed = host.numpy().copy()
        sums = packed[2:].view(np.float32)
        return (int(packed[:2].view(np.int64)[0]), torch.from_numpy(sums[:s]),
                torch.from_numpy(sums[s:]))


def _check_tile(name, coords_post, coords_pre, feats_post, feats_pre):
    """The device of a tile's float32 CUDA tensors, coordinates (n, 1-3) and
    features (n, F) of matching rows; raises on anything else."""
    args = (coords_post, coords_pre, feats_post, feats_pre)
    dev = coords_post.device
    if not coords_post.is_cuda or any(a.device != dev or a.dtype != torch.float32
                                      or a.dim() != 2 for a in args):
        raise TypeError(f"{name} takes 2-D float32 tensors on one CUDA device")
    (n_post, ndim), (n_pre, ndim_pre) = coords_post.shape, coords_pre.shape
    if not 1 <= ndim <= 3 or ndim_pre != ndim or feats_pre.shape[1] != feats_post.shape[1] \
            or feats_post.shape[0] != n_post or feats_pre.shape[0] != n_pre:
        raise ValueError(f"{name}: coordinates (n, 1-3) and features (n, F) of matching rows")
    return dev


PAIR_SUMS_KERNEL = _PairSumsKernel()


def pair_stats(coords_post, coords_pre, feats_post, feats_pre, max_distance, padded):
    """(count, sum_f, sumsq_f) over distance-gated pairs, F+1 entries with
    the normalised distance first, summed in the order of XLA's CPU tree
    reduction over the reference's padded tile ``padded`` (rows, cols).
    CUDA tensors go to the hand-written kernel (or it raises), which
    returns the sums on the host after one read; CPU tensors to
    :func:`pair_stats_plain`."""
    if on_card(coords_post, "pair_stats"):
        return PAIR_SUMS_KERNEL(coords_post, coords_pre, feats_post, feats_pre, max_distance,
                                padded)
    return pair_stats_plain(coords_post, coords_pre, feats_post, feats_pre, max_distance, padded)


def bucket(n: int, minimum: int = 128) -> int:
    """The reference's padded tile length: ``minimum`` doubled until it
    holds ``n`` (``matching._bucket``; the single tile pads to multiples
    of the ROI chunk the same way)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def cost_weights(n_feat, n_stats):
    """Each feature's weight in the cost: float32(1 / n_stats) for the
    statistics, float32(1 / n_hu) for the Hu features."""
    n_hu = n_feat - n_stats
    return [f32(1.0 / (n_stats if f < n_stats else n_hu)) for f in range(n_feat)]


def pair_cost_matrix(coords_post, coords_pre, feats_post, feats_pre, max_distance,
                     mean, std, n_stats):
    """The (n_post, n_pre) cost of :func:`pair_costs`, +inf where a pair is
    not gated.  ``mean`` and ``std`` are moved to the coordinates' device
    (on a CUDA tensor PyTorch divides by a host scalar as a multiply by its
    reciprocal)."""
    dist_n, mask = _pair_mask_and_dist(coords_post, coords_pre, max_distance)
    mean = torch.as_tensor(mean, dtype=torch.float32).to(dist_n.device)
    std = torch.as_tensor(std, dtype=torch.float32).to(dist_n.device)
    cost = (dist_n - mean[0]) / std[0]
    for f, w in enumerate(cost_weights(feats_post.shape[1], n_stats)):
        d = (feats_post[:, f][:, None] - feats_pre[:, f][None, :]).abs()
        z = (d - mean[1 + f]) / std[1 + f]
        cost = fma(z, w, cost)
    return torch.where(mask, cost, torch.full_like(cost, float("inf")))


def pair_costs_plain(coords_post, coords_pre, feats_post, feats_pre, max_distance,
                     mean, std, n_stats):
    """:func:`pair_costs` in plain torch: the whole cost matrix, then
    ``min`` over each axis."""
    cost = pair_cost_matrix(coords_post, coords_pre, feats_post, feats_pre, max_distance,
                            mean, std, n_stats)
    row_min_val, row_min_idx = cost.min(dim=1)
    col_min_val, col_min_idx = cost.min(dim=0)
    return row_min_val, row_min_idx, col_min_val, col_min_idx


class _PairCostsKernel(CountedKernel):
    """The compiled pair costs (``csrc/pair_costs.cu``), built once per
    process, with a launch count and a count of the CUDA kernels
    launched.  A call's keys (scratch, cleared by the call's memset) are
    kept for the next call on the same device and stream."""

    source = "pair_costs.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def __init__(self):
        super().__init__()
        self._keys = {}  # (device index, stream): int64 keys on that device

    def bind(self, lib):
        ptr, i32, f32p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
        lib.pair_costs_max_features.argtypes = []
        lib.pair_costs_max_features.restype = i32
        lib.pair_costs_key_words.argtypes = [i32, i32]
        lib.pair_costs_key_words.restype = ctypes.c_longlong
        lib.pair_costs.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float,
                                   f32p, f32p, f32p, ptr, ptr, ctypes.POINTER(i32), ptr]
        lib.pair_costs.restype = i32
        self.max_features = lib.pair_costs_max_features()

    def __call__(self, coords_post, coords_pre, feats_post, feats_pre, max_distance,
                 mean, std, n_stats):
        """(row_min_val, row_min_idx, col_min_val, col_min_idx) as views of
        one CUDA buffer (float32 minima, int64 indices), by one C call (a
        memset and one CUDA kernel) with no host read; float32 CUDA tensors
        of one device, coordinates (n, 1-3) and features (n, F), at least
        one of each; ``mean`` and ``std`` (F + 1) on the host, as launch
        arguments."""
        args = (coords_post, coords_pre, feats_post, feats_pre)
        dev = _check_tile("pair_costs", *args)
        (n_post, ndim), n_pre, n_feat = coords_post.shape, coords_pre.shape[0], feats_post.shape[1]
        if n_post == 0 or n_pre == 0:
            raise ValueError("pair_costs takes at least one marker of each frame")
        lib = self._lib or self.build()
        if n_feat > self.max_features:
            raise ValueError(f"pair_costs on the card takes at most {self.max_features} "
                             f"features, not {n_feat}")
        moments = [_launch_floats(name, m, n_feat + 1) for name, m in (("mean", mean),
                                                                         ("std", std))]
        with self.on_device(dev):
            inputs = [a.contiguous() for a in args]
            n = n_post + n_pre
            out = torch.empty((n + 1) // 2 + n, dtype=torch.int64, device=dev)
            kernels = ctypes.c_int(0)
            stream = _raw_stream(dev)
            words = lib.pair_costs_key_words(n_post, n_pre)
            with self._lock:
                keys = self._keys.get((dev.index, stream))
                if keys is None or keys.numel() < words:
                    keys = self._keys[(dev.index, stream)] = torch.empty(
                        words, dtype=torch.int64, device=dev)
                err = lib.pair_costs(*(a.data_ptr() for a in inputs), n_post, n_pre, ndim,
                                     n_feat, f32(max_distance), *moments,
                                     _weights(n_feat, n_stats), keys.data_ptr(), out.data_ptr(),
                                     ctypes.byref(kernels), stream)
                check_error("pair_costs launch", err)
                self.count_call(kernels.value)
        vals, idx = out[:(n + 1) // 2].view(torch.float32), out[(n + 1) // 2:]
        return vals[:n_post], idx[:n_post], vals[n_post:n], idx[n_post:]


def _launch_floats(name, values, n):
    """``values`` (a host tensor or sequence of n numbers) as a ctypes float
    array for a launch; a CUDA tensor raises (reading it would be a host
    read)."""
    if isinstance(values, torch.Tensor):
        if values.device.type != "cpu":
            raise TypeError(f"pair_costs on the card takes {name} on the host (it is a "
                            "launch argument)")
        values = values.reshape(-1).tolist()
    values = np.asarray(values, np.float32).reshape(-1)
    if values.size != n:
        raise ValueError(f"pair_costs: {name} has {values.size} entries for {n - 1} features "
                         "and the distance")
    return (ctypes.c_float * n)(*values.tolist())


@functools.lru_cache(maxsize=16)
def _weights(n_feat, n_stats):
    """:func:`cost_weights` as a ctypes float array (at least one entry)."""
    return (ctypes.c_float * max(n_feat, 1))(*cost_weights(n_feat, n_stats))


PAIR_COSTS_KERNEL = _PairCostsKernel()


def pair_costs(coords_post, coords_pre, feats_post, feats_pre, max_distance,
               mean, std, n_stats):
    """(row_min_val, row_min_idx, col_min_val, col_min_idx) of the cost.
    CUDA tensors go to the hand-written kernel (or it raises), with
    ``mean`` and ``std`` on the host; its four results are views of one
    device buffer (:func:`to_host` copies them in one read).  CPU tensors
    go to :func:`pair_costs_plain`."""
    if on_card(coords_post, "pair_costs"):
        return PAIR_COSTS_KERNEL(coords_post, coords_pre, feats_post, feats_pre, max_distance,
                                 mean, std, n_stats)
    return pair_costs_plain(coords_post, coords_pre, feats_post, feats_pre, max_distance,
                            mean, std, n_stats)


def to_host(tensors):
    """``tensors`` on the host: CPU tensors as they are; CUDA views of one
    buffer (the card's :func:`pair_costs`) by one copy of that buffer."""
    if tensors[0].device.type == "cpu":
        return tuple(tensors)
    storage = tensors[0].untyped_storage()
    if any(t.untyped_storage().data_ptr() != storage.data_ptr() for t in tensors):
        raise ValueError("to_host takes views of one buffer")
    whole = torch.empty(0, dtype=torch.uint8, device=tensors[0].device).set_(
        storage, 0, (storage.nbytes(),))
    host = torch.empty(storage.nbytes(), dtype=torch.uint8, pin_memory=True)
    host.copy_(whole)  # the one read
    host = host.untyped_storage()
    return tuple(torch.empty(0, dtype=t.dtype).set_(host, t.storage_offset(), t.shape, t.stride())
                 for t in tensors)


def _select_matches(row_min_val, row_min_idx, col_min_val, col_min_idx,
                    n_post, n_pre):
    """Every row whose best column is under the cutoff, then every column
    whose best row is (duplicates kept)."""
    row_matches, col_matches, costs = [], [], []
    for i in range(n_post):
        if row_min_idx[i] >= 0 and row_min_val[i] <= COST_CUTOFF and np.isfinite(row_min_val[i]):
            row_matches.append(int(i))
            col_matches.append(int(row_min_idx[i]))
            costs.append(float(row_min_val[i]))
    for j in range(n_pre):
        if col_min_idx[j] >= 0 and col_min_val[j] <= COST_CUTOFF and np.isfinite(col_min_val[j]):
            row_matches.append(int(col_min_idx[j]))
            col_matches.append(int(j))
            costs.append(float(col_min_val[j]))
    return row_matches, col_matches, costs


def match_frames_device(
    coords_post: torch.Tensor, feats_post: torch.Tensor,
    coords_pre: torch.Tensor, feats_pre: torch.Tensor,
    max_distance: float, n_stats: int, chunk: int = 1024,
) -> Tuple[list, list, list]:
    """Matching over device-resident features: two reductions on the device,
    the z-score moments in float64 on the host between them.  ``chunk`` is
    the tracker's ROI chunk, to which the reference pads each frame's
    markers (doubling)."""
    n_post, n_pre = coords_post.shape[0], coords_pre.shape[0]
    if n_post == 0 or n_pre == 0:
        return [], [], []
    max_d = f32(max_distance)
    count, sums, sumsqs = pair_stats(coords_post, coords_pre, feats_post, feats_pre, max_d,
                                     padded=(bucket(n_post, chunk), bucket(n_pre, chunk)))
    if count == 0:
        return [], [], []
    mean, std = _moments(count, sums.numpy().astype(np.float64),
                         sumsqs.numpy().astype(np.float64))
    costs = pair_costs(coords_post, coords_pre, feats_post, feats_pre, max_d,
                       torch.from_numpy(mean.astype(np.float32)),
                       torch.from_numpy(std.astype(np.float32)), n_stats)
    return _select_matches(*(c.numpy() for c in to_host(costs)), n_post, n_pre)


def _moments(count, sums, sumsqs):
    """(mean, std) of each feature difference, in float64."""
    mean = sums / count
    var = np.maximum(sumsqs / count - mean ** 2, 0.0)
    return mean, np.sqrt(var) + 1e-8


def match_frames(
    coords_post: np.ndarray, coords_pre: np.ndarray,
    stats_post: np.ndarray, stats_pre: np.ndarray,
    hu_post: np.ndarray, hu_pre: np.ndarray,
    max_distance: float,
    tile_rows: int = 8192,
    device="cuda",
) -> Tuple[list, list, list]:
    """Matching in row tiles of ``tile_rows`` later-frame markers, each
    tile on ``device``; host arrays in, (rows, cols, costs) out with the
    selection of :func:`_select_matches`."""
    dev = resolve_device(device)
    n_post, n_pre = coords_post.shape[0], coords_pre.shape[0]
    if n_post == 0 or n_pre == 0:
        return [], [], []
    n_stats = stats_post.shape[1]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    feats_post = np.concatenate([stats_post, hu_post], axis=1)
    coords_pre_d = put(coords_pre)
    feats_pre_d = put(np.concatenate([stats_pre, hu_pre], axis=1))
    tiles = [(start, min(start + tile_rows, n_post)) for start in range(0, n_post, tile_rows)]
    tiles = [(s, e, put(coords_post[s:e]), put(feats_post[s:e])) for s, e in tiles]
    max_d = f32(max_distance)

    # phase A: each tile's masked sums, added across tiles in float64
    count = 0
    sums = sumsqs = 0.0
    for start, end, c, f in tiles:
        cnt, s, ss = pair_stats(c, coords_pre_d, f, feats_pre_d, max_d,
                                padded=(bucket(end - start), bucket(n_pre)))
        count += cnt
        sums = sums + s.numpy().astype(np.float64)
        sumsqs = sumsqs + ss.numpy().astype(np.float64)
    if count == 0:
        return [], [], []
    mean, std = _moments(count, sums, sumsqs)

    # phase B: tile costs; row minima per tile, column minima across tiles
    # (an earlier tile keeps a tie)
    row_min_val = np.full(n_post, np.inf, np.float32)
    row_min_idx = np.full(n_post, -1, np.int64)
    col_min_val = np.full(n_pre, np.inf, np.float32)
    col_min_idx = np.full(n_pre, -1, np.int64)
    mean_h = torch.from_numpy(mean.astype(np.float32))
    std_h = torch.from_numpy(std.astype(np.float32))
    for start, end, c, f in tiles:
        rmv, rmi, cmv, cmi = (t.numpy() for t in to_host(pair_costs(
            c, coords_pre_d, f, feats_pre_d, max_d, mean_h, std_h, n_stats)))
        row_min_val[start:end] = rmv
        row_min_idx[start:end] = rmi
        better = cmv < col_min_val
        col_min_val = np.where(better, cmv, col_min_val)
        col_min_idx = np.where(better, cmi + start, col_min_idx)
    return _select_matches(row_min_val, row_min_idx, col_min_val, col_min_idx, n_post, n_pre)
