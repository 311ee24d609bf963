"""Simple-point lookup table for topology-preserving 3D thinning.

The port's copy of ``nellie_tpu/kernels/simple_point.py``.  For every
26-bit neighbourhood configuration the table holds the exact
Bertrand–Malandain (26,6) simple-point characterisation [Malandain &
Bertrand 1992]:

  a foreground voxel P is *simple* iff
   (1) fg ∩ N26(P) has exactly one 26-connected component, and
   (2) bg ∩ N18(P) has exactly one 6-connected component that is
       6-adjacent to P (i.e. contains a face neighbour).

``deletable`` additionally excludes endpoints (exactly one fg neighbour)
and isolated voxels, so iterative deletion yields a curve skeleton.

The table is 2^26 bits (8 MiB bit-packed).  It ships beside this module
as ``_simple26_lut.xz`` (the packed bytes, lzma-compressed to 4 KB) and
is decompressed once per process, at first use.  :func:`build_simple26_lut`
is the file's documented source: it rebuilds the same bytes in numpy
(about a minute and a half on one CPU core), and a slow test holds the
two against each other.
"""
from __future__ import annotations

import lzma
import os

import numpy as np

# Cell ordering: raster order over (dz, dy, dx) in {-1,0,1}^3, center excluded.
OFFSETS_26 = [
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if not (dz == 0 and dy == 0 and dx == 0)
]

_LUT_PATH = os.path.join(os.path.dirname(__file__), "_simple26_lut.xz")
_LUT_BYTES = 1 << 23


def _adjacency_26():
    """26-adjacency among the 26 cells (Chebyshev distance 1)."""
    adj = []
    for i, a in enumerate(OFFSETS_26):
        nbrs = []
        for j, b in enumerate(OFFSETS_26):
            if i != j and max(abs(a[0] - b[0]), abs(a[1] - b[1]), abs(a[2] - b[2])) <= 1:
                nbrs.append(j)
        adj.append(nbrs)
    return adj


def _n18_cells():
    """Indices (into OFFSETS_26) of the 18-neighbourhood (no corners)."""
    return [i for i, o in enumerate(OFFSETS_26) if abs(o[0]) + abs(o[1]) + abs(o[2]) <= 2]


def _face_cells():
    return [i for i, o in enumerate(OFFSETS_26) if abs(o[0]) + abs(o[1]) + abs(o[2]) == 1]


def _adjacency_6_within_18():
    cells = _n18_cells()
    pos = {c: OFFSETS_26[c] for c in cells}
    adj = {}
    for a in cells:
        adj[a] = [
            b for b in cells
            if b != a and sum(abs(x - y) for x, y in zip(pos[a], pos[b])) == 1
        ]
    return adj


def _count_components_chunk(bits, cell_ids, adjacency, seed_cells=None, iters=None):
    """Vectorised component counting over many configurations.

    bits: (26, N) bool occupancy.  Returns (count, N) where count = number
    of connected components among occupied cells (optionally only
    components containing a seed cell).  Propagation iterates to full
    convergence (worst case = longest induced path, e.g. 12 for the
    6-adjacency N18 graph) unless ``iters`` caps it.
    """
    n = bits.shape[1]
    big = np.uint8(99)
    labels = {c: np.where(bits[c], np.uint8(c), big) for c in cell_ids}
    max_iters = iters if iters is not None else len(list(cell_ids)) + 2
    for _ in range(max_iters):
        changed = False
        new_labels = {}
        for c in cell_ids:
            m = labels[c]
            for j in adjacency[c]:
                m = np.minimum(m, labels[j])
            new = np.where(bits[c], m, big)
            changed = changed or not np.array_equal(new, labels[c])
            new_labels[c] = new
        labels = new_labels
        if not changed:
            break
    if seed_cells is None:
        count = np.zeros(n, np.uint8)
        for c in cell_ids:
            count += (bits[c] & (labels[c] == c)).astype(np.uint8)
        return count
    # count roots reachable from seeds: a component counts if any of its
    # members is a seed cell -> collect root labels of seeds, count unique.
    touched = np.zeros((27, n), bool)  # root label in 0..25 or 99->bucket 26
    for c in seed_cells:
        root = np.where(bits[c], labels[c], big)
        root_clipped = np.where(root == big, 26, root).astype(np.int64)
        touched[root_clipped, np.arange(n)] |= bits[c]
    return touched[:26].sum(axis=0).astype(np.uint8)


def build_simple26_lut(chunk_bits: int = 22) -> np.ndarray:
    """Build the packed 2^26-bit deletability table (vectorised numpy)."""
    adj26 = _adjacency_26()
    cells18 = _n18_cells()
    adj6 = _adjacency_6_within_18()
    faces = _face_cells()

    total = 1 << 26
    chunk = 1 << chunk_bits
    out = np.zeros(total // 8, dtype=np.uint8)

    for start in range(0, total, chunk):
        codes = np.arange(start, start + chunk, dtype=np.int64)
        bits = np.empty((26, chunk), bool)
        for k in range(26):
            bits[k] = (codes >> k) & 1

        n_fg = bits.sum(axis=0)
        # condition 1: exactly one 26-component of fg cells
        cond1 = _count_components_chunk(bits, range(26), adj26) == 1
        # condition 2: exactly one 6-component of bg within N18 touching a face
        cond2 = _count_components_chunk(~bits, cells18, adj6, seed_cells=faces) == 1

        deletable = cond1 & cond2 & (n_fg > 1)  # n_fg==1 endpoint, ==0 isolated
        out[start // 8: (start + chunk) // 8] = np.packbits(deletable.view(np.uint8),
                                                            bitorder="little")
    return out


_lut_cache = None


def get_simple26_lut() -> np.ndarray:
    """The packed deletability table, (2^23,) uint8: bit ``code & 7`` of
    byte ``code >> 3`` is set when configuration ``code`` is deletable."""
    global _lut_cache
    if _lut_cache is None:
        with open(_LUT_PATH, "rb") as f:
            lut = np.frombuffer(bytearray(lzma.decompress(f.read())), dtype=np.uint8)
        if lut.shape != (_LUT_BYTES,):
            raise ValueError(f"{_LUT_PATH}: {lut.size} bytes, expected {_LUT_BYTES}")
        _lut_cache = lut
    return _lut_cache
