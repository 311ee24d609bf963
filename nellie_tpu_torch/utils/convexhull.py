"""Convex hulls for solidity (2D monotone chain, 3D quickhull/Qhull).

Used by :mod:`nellie_tpu_torch.utils.regionprops` for solidity — the discrete
convex-image voxel count (the reference gets this from skimage
regionprops, the original Nellie's ``nellie/feature_extraction/
hierarchical.py:1771-1804``).  The 3D hull build uses scipy's Qhull
binding when importable (C — the per-frame hot path) and falls back to
the self-contained vectorised numpy quickhull below, which also serves
as the cross-implementation oracle in tests.

The hulls are returned as half-space systems (A, b) with outward
normals: a point p is inside iff ``A @ p <= b + eps`` for every row.
Voxelised regions produce many near-coplanar facets, so the plane set is
deduplicated before the grid test and the test itself runs as chunked
float32 matmuls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_EPS = 1e-9


def hull_halfspaces_2d(points: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Monotone-chain hull -> (A, b) half-spaces; None if degenerate."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) < 3:
        return None
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(seq):
        out = []
        for p in seq:
            # scalar 2D cross (np.cross on 2-vectors is removed in new numpy)
            while len(out) >= 2:
                e0 = out[-1] - out[-2]
                e1 = p - out[-2]
                if e0[0] * e1[1] - e0[1] * e1[0] > _EPS:
                    break
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1])
    if len(hull) < 3:
        return None
    a = hull
    bpt = np.roll(hull, -1, axis=0)
    edge = bpt - a
    normals = np.stack([edge[:, 1], -edge[:, 0]], axis=1)  # outward for CCW
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norms, _EPS)
    offsets = np.sum(normals * a, axis=1)
    return normals, offsets


def _face_planes_batch(pts: np.ndarray, V: np.ndarray, interior: np.ndarray):
    """Outward unit plane (normal, offset) for each vertex triple in ``V``;
    ``keep`` False where the triple is degenerate."""
    p0 = pts[V[:, 0]]
    nrm = np.cross(pts[V[:, 1]] - p0, pts[V[:, 2]] - p0)
    ln = np.linalg.norm(nrm, axis=1)
    keep = ln >= _EPS
    nrm = nrm / np.maximum(ln, _EPS)[:, None]
    flip = np.einsum("ij,ij->i", nrm, interior[None, :] - p0) > 0
    nrm[flip] = -nrm[flip]
    off = np.einsum("ij,ij->i", nrm, p0)
    return nrm, off, keep


def hull_halfspaces_3d(points: np.ndarray, tol: float = 1e-7,
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Quickhull -> (A, b) half-space system; None for degenerate input
    (all points coplanar/collinear).

    Faces live in flat arrays (vertex triples ``V``, unit normals ``N``,
    offsets ``OFF``) and every per-iteration step — visibility, horizon
    extraction, new-face planes, orphan reassignment — is one vectorised
    numpy call, so the Python cost per added hull vertex is O(1) calls
    (the round-2 per-face dict version spent ~200µs/face in
    ``make_face`` alone).  Each outside point is assigned to its
    most-violated face (classic quickhull conflict lists).

    ``tol``: points within ``tol`` of a facet count as inside.  1e-7 is
    exact for integer voxel coordinates; a half-voxel tolerance (0.5)
    bounds the facet explosion on huge smooth voxel surfaces at a
    sub-voxel approximation cost (used for giant regions only)."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    n = len(pts)
    if n < 4:
        return None

    # initial simplex: extreme pair, furthest from line, furthest from plane
    d0 = int(np.argmin(pts[:, 0]))
    d1 = int(np.argmax(pts[:, 0]))
    if d0 == d1:
        d1 = int(np.argmax(np.linalg.norm(pts - pts[d0], axis=1)))
    a, b = pts[d0], pts[d1]
    ab = b - a
    if np.linalg.norm(ab) < _EPS:
        return None
    t = np.cross(ab, pts - a)
    d2 = int(np.argmax(np.linalg.norm(t, axis=1)))
    c = pts[d2]
    normal = np.cross(ab, c - a)
    if np.linalg.norm(normal) < _EPS:
        return None
    dpl = (pts - a) @ normal
    d3 = int(np.argmax(np.abs(dpl)))
    if abs(dpl[d3]) < _EPS:
        return None  # coplanar
    d = pts[d3]
    interior = (a + b + c + d) / 4.0

    V = np.asarray([(d0, d1, d2), (d0, d1, d3), (d0, d2, d3), (d1, d2, d3)],
                   np.int64)
    N, OFF, keep = _face_planes_batch(pts, V, interior)
    V, N, OFF = V[keep], N[keep], OFF[keep]
    if len(V) < 4:
        return None

    # conflict lists: each point's most-violated face (-1 = inside)
    D = pts @ N.T - OFF[None, :]
    best_f = np.argmax(D, axis=1)
    best_d = D[np.arange(n), best_f]
    assign = np.where(best_d > tol, best_f, -1)
    dist = np.where(assign >= 0, best_d, -np.inf)

    vis_eps = min(tol, 1e-9)
    for _ in range(n):
        far = int(np.argmax(dist))
        if assign[far] < 0:
            break
        p_far = pts[far]
        vis = N @ p_far - OFF > vis_eps
        if not vis[assign[far]]:
            vis[assign[far]] = True  # numerical safety: its own face is visible
        # horizon: undirected edges of visible faces seen exactly once
        tri = V[vis]
        e = np.concatenate([tri[:, (0, 1)], tri[:, (1, 2)], tri[:, (2, 0)]])
        key = np.minimum(e[:, 0], e[:, 1]) * np.int64(n + 1) + np.maximum(e[:, 0], e[:, 1])
        _, first_idx, cnts = np.unique(key, return_index=True, return_counts=True)
        horizon = e[first_idx[cnts == 1]]

        # orphans: points whose conflict face is being removed
        alive = assign >= 0
        orphan_mask = alive.copy()
        orphan_mask[alive] = vis[assign[alive]]
        orphan_mask[far] = False
        orphan = np.nonzero(orphan_mask)[0]

        keep_mask = ~vis
        remap = -np.ones(len(V), np.int64)
        remap[keep_mask] = np.arange(int(keep_mask.sum()))
        V, N, OFF = V[keep_mask], N[keep_mask], OFF[keep_mask]
        assign[alive] = remap[assign[alive]]

        # cone of new faces from the horizon to the far point
        Vn = np.column_stack([horizon, np.full(len(horizon), far, np.int64)])
        Nn, OFFn, keep2 = _face_planes_batch(pts, Vn, interior)
        Vn, Nn, OFFn = Vn[keep2], Nn[keep2], OFFn[keep2]
        base = len(V)
        V = np.concatenate([V, Vn])
        N = np.concatenate([N, Nn])
        OFF = np.concatenate([OFF, OFFn])

        if len(orphan) and len(Vn):
            dd = pts[orphan] @ Nn.T - OFFn[None, :]
            bf = np.argmax(dd, axis=1)
            bd = dd[np.arange(len(orphan)), bf]
            sel = bd > tol
            assign[orphan[sel]] = base + bf[sel]
            dist[orphan[sel]] = bd[sel]
            assign[orphan[~sel]] = -1
            dist[orphan[~sel]] = -np.inf
        elif len(orphan):
            assign[orphan] = -1
            dist[orphan] = -np.inf
        assign[far] = -1
        dist[far] = -np.inf

    return N, OFF


def _dedup_planes(A: np.ndarray, b: np.ndarray, decimals: int = 7):
    """Voxel hulls produce many coincident facet planes; keep one of each."""
    key = np.round(np.column_stack([A, b]), decimals)
    _, idx = np.unique(key, axis=0, return_index=True)
    return A[idx], b[idx]


def _row_extremes(coords: np.ndarray) -> np.ndarray:
    """Exact hull-candidate reduction: any voxel strictly between its
    row's min-x and max-x is a convex combination of those extremes, so
    every hull vertex is a per-(leading dims)-row x-extreme.  Cuts the
    quickhull input from O(volume) to <= 2 x rows."""
    lead, x = coords[:, :-1], coords[:, -1]
    # 1D-encoded unique (np.unique(axis=0)'s void-view path is ~5x slower)
    dims = lead.max(axis=0) + 1
    key = np.ravel_multi_index(tuple(lead.T), tuple(dims))
    ukey, inv = np.unique(key, return_inverse=True)
    rows = np.column_stack(np.unravel_index(ukey, tuple(dims)))
    n_rows = len(rows)
    mn = np.full(n_rows, np.iinfo(np.int64).max)
    mx = np.full(n_rows, np.iinfo(np.int64).min)
    np.minimum.at(mn, inv, x)
    np.maximum.at(mx, inv, x)
    lo = np.column_stack([rows, mn])
    hi = np.column_stack([rows, mx])
    same = mn == mx
    return np.concatenate([lo, hi[~same]])


def _hull_halfspaces_qhull(coords: np.ndarray):
    """3D hull half-spaces via scipy's Qhull binding (C — ~10x the pure
    numpy quickhull on voxel regions).  Returns (handled, hs): handled
    False when scipy isn't importable (fall back to own quickhull); hs
    None for degenerate input (Qhull rejects flat point sets, matching
    ``hull_halfspaces_3d``'s None)."""
    try:
        from scipy.spatial import ConvexHull
    except Exception:  # noqa: BLE001 — optional fast path
        return False, None
    try:
        h = ConvexHull(np.asarray(coords, np.float64))
    except Exception:  # noqa: BLE001 — QhullError on degenerate input
        return True, None
    # equations rows are [normal | offset] with normal @ p + offset <= 0
    return True, (h.equations[:, :-1], -h.equations[:, -1])


def convex_image_count(coords: np.ndarray) -> Optional[int]:
    """Number of integer grid points (over the coords' bbox) inside the
    convex hull — skimage's discrete ``convex_image`` voxel count."""
    coords = np.asarray(coords)
    ndim = coords.shape[1]
    if len(coords) > 64:
        coords = _row_extremes(coords)
    # giant smooth voxel surfaces explode the exact facet count; a
    # half-voxel facet tolerance bounds it at sub-voxel count error
    tol = 1e-7 if len(coords) <= 2048 else 0.5
    if ndim == 2:
        hs = hull_halfspaces_2d(coords)
    else:
        handled, hs = _hull_halfspaces_qhull(coords)
        if handled:
            tol = 1e-7  # Qhull is exact at any region size
        else:
            hs = hull_halfspaces_3d(coords, tol=tol)
    if hs is None:
        return None
    A, b = _dedup_planes(*hs)
    mins = coords.min(axis=0)
    maxs = coords.max(axis=0)
    dims = maxs - mins + 1

    # exact interval counting: the hull's slice at fixed leading coords is
    # an interval along the last axis whose integer bounds come straight
    # from the half-planes — O(rows x planes) instead of a full-grid test
    lead_dims = tuple(int(v) for v in dims[:-1])
    n_rows = int(np.prod(lead_dims)) if lead_dims else 1
    lead = np.column_stack(np.unravel_index(np.arange(n_rows), lead_dims)) \
        if lead_dims else np.zeros((1, 0))
    lead = lead.astype(np.float64) + mins[:-1][None, :]
    c = b[None, :] + max(tol, 1e-7) - lead @ np.ascontiguousarray(A[:, :-1].T)
    a_last = A[:, -1]
    pos = a_last > 1e-12
    neg = a_last < -1e-12
    zero = ~pos & ~neg
    hi = np.full(n_rows, float(maxs[-1]))
    if pos.any():
        hi = np.minimum(hi, np.floor((c[:, pos] / a_last[pos][None, :]).min(axis=1)))
    lo = np.full(n_rows, float(mins[-1]))
    if neg.any():
        lo = np.maximum(lo, np.ceil((c[:, neg] / a_last[neg][None, :]).max(axis=1)))
    ok = np.ones(n_rows, bool)
    if zero.any():
        ok &= (c[:, zero] >= 0).all(axis=1)
    counts = np.where(ok, np.maximum(0.0, hi - lo + 1), 0.0)
    return int(counts.sum())
