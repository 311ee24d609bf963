"""Halo-padded window tiling of a volume.

Copy of ``nellie_tpu/utils/chunking.py``: the volume is split into core
chunks, each extended by a per-axis halo clamped to the volume, and every
window has one static core shape and one static extended shape (the last
windows along an axis shift inward).  Each window owns the disjoint part
of its core that no earlier window covers, and callers write only that.

The extended shape keeps the reference's alignment (last axis to a
multiple of 128, the one before to 8).  That rule was chosen for the TPU's
tile layout and buys nothing on a GPU, but it is kept for parity: the
Frangi γ and Frobenius thresholds are statistics of the whole extended
window, so a window of another extent gives other values near window
borders than the JAX package does.
"""
from __future__ import annotations

import itertools

import numpy as np


def crop_core(v, offsets, size):
    """The ``size`` box of ``v`` starting at ``offsets`` (a view)."""
    return v[tuple(slice(o, o + s) for o, s in zip(offsets, size))]


def compute_chunk_shape(shape, max_chunk_voxels):
    """Halve the longest axis until the chunk holds at most
    ``max_chunk_voxels`` voxels (the whole shape for None or <= 0)."""
    if max_chunk_voxels is None or max_chunk_voxels <= 0:
        return tuple(shape)
    chunk = list(shape)
    while int(np.prod(chunk)) > max_chunk_voxels:
        idx = int(np.argmax(chunk))
        chunk[idx] = max(1, int(np.ceil(chunk[idx] / 2)))
    return tuple(chunk)


def _align_up(n, m):
    return ((n + m - 1) // m) * m


def _tile_alignments(ndim):
    """Per-axis multiples of the extended shape: 128 on the last axis, 8 on
    the one before (the reference's TPU tile; kept for parity, see the
    module docstring)."""
    align = [1] * ndim
    if ndim >= 1:
        align[-1] = 128
    if ndim >= 2:
        align[-2] = 8
    return align


def uniform_window_shapes(shape, chunk_shape, halo):
    """(core_shape, ext_shape) of the static-shape window tiling: the
    extended shape is the core plus both halos, rounded up to the
    alignment and clipped to the volume."""
    core_shape = tuple(min(d, c) for d, c in zip(shape, chunk_shape))
    align = _tile_alignments(len(shape))
    ext_shape = tuple(
        min(d, _align_up(c + 2 * h, a))
        for d, c, h, a in zip(shape, core_shape, halo, align))
    return core_shape, ext_shape


def iter_uniform_windows(shape, chunk_shape, halo):
    """Yield (owned, ext, offset, local) per window: ``owned`` and ``ext``
    are slice tuples into the volume (the owned boxes tile it disjointly),
    ``offset`` is the core's start within the extended window and
    ``local`` the owned box relative to the core."""
    if halo is None or len(halo) != len(shape):
        halo = (0,) * len(shape)
    core_shape, ext_shape = uniform_window_shapes(shape, chunk_shape, halo)
    axis_starts = []
    axis_owned = []
    for d, c in zip(shape, core_shape):
        starts = list(range(0, d - c + 1, c))
        if starts[-1] != d - c:
            starts.append(d - c)
        o_starts = [s if k == 0 else max(s, starts[k - 1] + c)
                    for k, s in enumerate(starts)]
        o_ends = o_starts[1:] + [d]
        axis_starts.append(starts)
        axis_owned.append(list(zip(o_starts, o_ends)))
    for item in itertools.product(*(zip(s, o) for s, o in zip(axis_starts, axis_owned))):
        starts = tuple(s for s, _ in item)
        owned_iv = tuple(o for _, o in item)
        ext_start = tuple(
            int(np.clip(s - h, 0, d - e))
            for s, h, d, e in zip(starts, halo, shape, ext_shape))
        owned = tuple(slice(lo, hi) for lo, hi in owned_iv)
        ext = tuple(slice(es, es + e) for es, e in zip(ext_start, ext_shape))
        offset = tuple(s - es for s, es in zip(starts, ext_start))
        local = tuple(slice(lo - s, hi - s) for (lo, hi), s in zip(owned_iv, starts))
        yield owned, ext, offset, local
