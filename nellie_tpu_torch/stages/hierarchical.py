"""Stage 7 — Hierarchy: voxel → node → branch → organelle → image features.

Port of ``nellie_tpu/stages/hierarchical.py``.  Frame by frame it builds
the per-level tables and streams them into the five CSVs
(``features_voxels/nodes/branches/organelles/image``), then pickles the
adjacency edge lists (``adjacency_maps.pkl``), with the reference's column
names, column order and key layout:

* voxels: the motility bundle (``_motility_kernel``) from the flow
  interpolated at every voxel, with the per-branch reference voxel of
  minimum |flow| found by a segment argmin, plus structure and intensity;
* nodes (skeleton voxels, unless ``skip_nodes``): membership in each
  node's radius box, flow convergence and divergence and the voxel
  statistics of the members, chunk by chunk over the voxels
  (``_node_agg_scan_kernel``); thickness from the border distance;
* branches and organelles: segment statistics of the lower levels
  (``kernels/segstats.py``), centreline length and degree
  (``segstats.branch_geometry``), region morphology;
* the border distance is one nearest-neighbour pass per frame over the
  skeleton and node voxels, on the CUDA kernel when the device is a GPU
  (``kernels/nn.py``).

Region morphology (:mod:`nellie_tpu_torch.utils.regionprops`) and the adjacency
pair lists stay host numpy, as in the reference.  The CSVs are written
with numpy and the standard library on one background thread.

Frames are built one at a time in either mode.  ``low_memory`` divides
the node tables' membership budget (``max_node_mask_elems``) by four, so
the node aggregation takes smaller voxel chunks (``hierarchical.py:716``).

The skeleton volume of a frame comes from the fused chain's device cache
when the chain ran in this process (``_skel_dev``,
``hierarchical.py:1203-1215``), else from the artifact.

Not ported: the mesh paths, the trimmed transfers, the frames-ahead thread
pool and the host aggregate of small node tables.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import time

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.kernels._fp import f32, reduce_sum_of_squares, sqrt
from nellie_tpu_torch.kernels.nn import nearest_neighbors
from nellie_tpu_torch.kernels.segstats import STAT_KEYS, branch_geometry, segment_nanstats
from nellie_tpu_torch.stages.flow_interpolation import FlowInterpolator
from nellie_tpu_torch.utils import adaptive_run
from nellie_tpu_torch.utils.device_cache import frame_cache
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.utils.regionprops import regionprops

# statistic names per level, in CSV column order (reference parity)
VOXEL_STATS = (
    "linear_vel", "angular_vel", "linear_acc", "angular_acc",
    "rel_linear_vel", "rel_angular_vel", "rel_linear_acc",
    "rel_angular_acc", "rel_directionality", "structure", "intensity",
)
NODE_STATS = ("divergence", "convergence", "vergere", "node_thickness")
BRANCH_STATS = (
    "branch_length", "branch_thickness", "branch_aspect_ratio",
    "branch_tortuosity", "branch_area", "branch_axis_length_maj",
    "branch_axis_length_min", "branch_extent", "branch_solidity",
)
ORGANELLE_STATS = (
    "organelle_area", "organelle_axis_length_maj",
    "organelle_axis_length_min", "organelle_extent", "organelle_solidity",
)
_MOTILITY_KEYS = VOXEL_STATS[:9]

_NAN = float("nan")
_INF = float("inf")


def border_distance(border_mask: np.ndarray, coords: np.ndarray, spacing, device) -> np.ndarray:
    """Physical distance from each coordinate to the nearest border voxel
    (float32 numpy), by the brute-force nearest-neighbour argmin."""
    coords = np.asarray(coords, np.float64)
    if coords.size == 0:
        return np.zeros((0,), np.float32)
    border_coords = np.argwhere(border_mask)
    if border_coords.size == 0:
        return np.full(len(coords), np.nan, dtype=np.float32)
    spacing = np.asarray(spacing, np.float64)
    dist, _ = nearest_neighbors(coords * spacing, border_coords * spacing, device=device)
    return dist


# ---------------------------------------------------------------------------
# motility
# ---------------------------------------------------------------------------

def _segment_argmin(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Index of the minimum value per segment (-1 where empty); ties go to
    the smallest index."""
    n = values.shape[0]
    valid = ~torch.isnan(values) & (seg_ids >= 0) & (seg_ids < num_segments)
    sid = torch.where(valid, seg_ids, num_segments).long()
    seg_min = torch.full((num_segments + 1,), _INF, device=values.device).scatter_reduce_(
        0, sid, torch.where(valid, values, _INF), "amin")
    ismin = valid & (values == seg_min[sid])
    big = n + 1
    idx = torch.full((num_segments + 1,), big, dtype=torch.long, device=values.device)
    idx.scatter_reduce_(0, sid, torch.where(ismin, torch.arange(n, device=values.device), big),
                        "amin")
    return torch.where(idx == big, -1, idx)[:num_segments]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=1))


def _angle_wrap(x: torch.Tensor) -> torch.Tensor:
    """``(x + π) mod 2π − π`` with the floor-mod of ``jnp``'s ``%``: the
    truncated remainder moved into the divisor's sign."""
    two_pi = f32(2 * np.pi)
    mod = torch.fmod(x + f32(np.pi), two_pi)
    mod = torch.where((mod != 0) & (mod < 0), mod + two_pi, mod)
    return mod - f32(np.pi)


def _motility_kernel(coords_px, vec01_px, vec12_px, labels, spacing, dt: float,
                     has01: bool, num_labels: int) -> torch.Tensor:
    """All per-voxel motility statistics of one 2D or 3D frame.

    coords_px/vec01_px/vec12_px: (N, d) float32 voxel units; labels (N,)
    branch ids; spacing (d,) float32.  vec12 exists (t < T-1); vec01 is
    all NaN when ``has01`` is False.  Returns the (9, N) float32 columns
    in ``_MOTILITY_KEYS`` order.  In 2D the angular velocity is the
    wrapped change of the polar angle (a signed scalar), in 3D the cross
    product over the product of the norms."""
    n, d = coords_px.shape
    sp = spacing[None, :]
    coords_1 = coords_px * sp

    def lin(ra, rb):
        v = (rb - ra) / dt
        return v, _norm(v)

    def ang(ra, rb):
        if d == 2:
            theta_a = torch.atan2(ra[:, 1], ra[:, 0])
            theta_b = torch.atan2(rb[:, 1], rb[:, 0])
            av = _angle_wrap(theta_b - theta_a) / dt
            return av, av.abs()
        cross = torch.linalg.cross(ra, rb, dim=1)
        norm = (_norm(ra) * _norm(rb))[:, None]
        ang_disp = torch.where(norm != 0, cross / torch.where(norm != 0, norm, 1.0), _NAN)
        av = ang_disp / dt
        return av, _norm(av)

    def rel_coords(vec_phys, a_px, b_px):
        """Positions relative to the branch's reference voxel, the member
        of minimum |flow|.  |flow| is rounded as the reference rounds it
        (a near-tie decides the reference voxel), and the subtraction is
        done in voxel units before scaling, so that it is exactly zero at
        the reference voxel and the ``norm != 0`` gates hold there."""
        euc = sqrt(reduce_sum_of_squares(vec_phys))
        ref_of_label = _segment_argmin(euc, labels, num_labels)
        lbl_ok = (labels >= 0) & (labels < num_labels)
        ridx = torch.where(lbl_ok, ref_of_label[labels.clamp(0, num_labels - 1)], -1)
        ok = (ridx >= 0)[:, None]
        ridx_c = ridx.clamp(min=0)
        ra = torch.where(ok, (a_px - a_px[ridx_c]) * sp, _NAN)
        rb = torch.where(ok, (b_px - b_px[ridx_c]) * sp, _NAN)
        gone = torch.isnan(vec_phys)
        return torch.where(gone, _NAN, ra), torch.where(gone, _NAN, rb)

    vec12 = vec12_px * sp
    coords_2 = (coords_px + vec12_px) * sp

    lin_vel_v, lin_vel_mag = lin(coords_1, coords_2)
    ang_vel, ang_vel_mag = ang(coords_1, coords_2)
    r1_rel, r2_rel = rel_coords(vec12, coords_px, coords_px + vec12_px)
    lin_vel_rel_v, lin_vel_rel_mag = lin(r1_rel, r2_rel)
    ang_vel_rel, ang_vel_rel_mag = ang(r1_rel, r2_rel)
    r1m = _norm(r1_rel)
    r2m = _norm(r2_rel)
    denom = r2m + r1m
    directionality = torch.where(
        denom != 0, (r2m - r1m).abs() / torch.where(denom != 0, denom, 1.0), _NAN)

    if has01:
        vec01 = vec01_px * sp
        coords_0 = (coords_px - vec01_px) * sp
        lin_vel_01v, _ = lin(coords_0, coords_1)
        ang_vel_01, _ = ang(coords_0, coords_1)
        r0_rel, r1_rel01 = rel_coords(vec01, coords_px - vec01_px, coords_px)
        lin_vel_rel_01v, _ = lin(r0_rel, r1_rel01)
        ang_vel_rel_01, _ = ang(r0_rel, r1_rel01)
        lin_acc_mag = _norm((lin_vel_v - lin_vel_01v) / dt)
        lin_acc_rel_mag = _norm((lin_vel_rel_v - lin_vel_rel_01v) / dt)
        ang_acc = (ang_vel - ang_vel_01) / dt
        ang_acc_rel = (ang_vel_rel - ang_vel_rel_01) / dt
        if d == 2:
            ang_acc_mag, ang_acc_rel_mag = ang_acc.abs(), ang_acc_rel.abs()
        else:
            ang_acc_mag, ang_acc_rel_mag = _norm(ang_acc), _norm(ang_acc_rel)
    else:
        nana = torch.full((n,), _NAN, device=coords_px.device)
        lin_acc_mag = ang_acc_mag = lin_acc_rel_mag = ang_acc_rel_mag = nana

    return torch.stack([
        lin_vel_mag, ang_vel_mag, lin_acc_mag, ang_acc_mag,
        lin_vel_rel_mag, ang_vel_rel_mag, lin_acc_rel_mag, ang_acc_rel_mag,
        directionality,
    ])


def _frame_stats_kernel(coords_px, vec01_px, vec12_px, labels, structure, intensity,
                        spacing, dt: float, has01: bool, num_labels: int) -> torch.Tensor:
    """The frame's (11, N) voxel-statistics table in VOXEL_STATS order."""
    mot = _motility_kernel(coords_px, vec01_px, vec12_px, labels, spacing, dt,
                           has01=has01, num_labels=num_labels)
    return torch.cat([mot, structure[None], intensity[None]], dim=0)


# ---------------------------------------------------------------------------
# node aggregation
# ---------------------------------------------------------------------------

def _box_membership_kernel(lims_lo, lims_hi, coords) -> torch.Tensor:
    """(M, C) mask: coords[c] inside node m's box (inclusive bounds)."""
    mask = torch.ones((lims_lo.shape[0], coords.shape[0]), dtype=torch.bool, device=coords.device)
    for dim in range(coords.shape[1]):
        c = coords[None, :, dim]
        mask &= (lims_lo[:, dim, None] <= c) & (c <= lims_hi[:, dim, None])
    return mask


def _node_agg_scan_kernel(lims_lo, lims_hi, node_coords, coords, vec01, vec12, stats,
                          chunk: int):
    """All node-level aggregations of one frame, over voxel chunks.

    Shapes: ``lims_lo/hi`` (M, d) int32 boxes; ``node_coords`` (M, d)
    float32; ``coords`` (C, d) int32 voxel coordinates; ``vec01/vec12``
    (C, d) float32 flow vectors in physical units (NaN where missing);
    ``stats`` (S, C) float32 voxel statistics.  ``chunk`` voxels are
    taken at a time, so no (M, C) plane is larger than (M, chunk).

    direction = (voxel - node) / |voxel - node| (NaN at zero distance),
    convergence = mean of vec01·direction, divergence = mean of
    vec12·direction over the member voxels; and per node the NaN-aware
    count, sum, min, max and centred sum of squares of every voxel
    statistic (two passes).  Counts and sums accumulate in float64.

    Returns (node_sums (5 + d, M): c01, s01, c12, s12, member count,
    coordinate sums; stat_sums (5, S, M): count, sum, min, max, centred
    sum of squares), float64 tensors.
    """
    m, d = lims_lo.shape
    s = stats.shape[0]
    dev = coords.device
    f64 = torch.float64
    c01 = torch.zeros(m, dtype=f64, device=dev)
    s01, c12, s12 = c01.clone(), c01.clone(), c01.clone()
    sums = torch.zeros((m, 1 + d + 2 * s), dtype=f64, device=dev)
    mn_s = torch.full((s, m), _INF, device=dev)
    mx_s = torch.full((s, m), -_INF, device=dev)

    def nansum_count(mask, vals):
        valid = mask & ~torch.isnan(vals)
        return valid.sum(dim=1).double(), torch.where(valid, vals, 0.0).sum(dim=1, dtype=f64)

    starts = range(0, coords.shape[0], chunk)
    for start in starts:
        cc = coords[start:start + chunk]
        v01 = vec01[start:start + chunk]
        v12 = vec12[start:start + chunk]
        st = stats[:, start:start + chunk]
        mask = _box_membership_kernel(lims_lo, lims_hi, cc)
        ccf = cc.float()
        mag2 = torch.zeros(mask.shape, device=dev)
        rdot01 = torch.zeros(mask.shape, device=dev)
        rdot12 = torch.zeros(mask.shape, device=dev)
        for dim in range(d):
            dv = ccf[None, :, dim] - node_coords[:, dim, None]
            mag2 += dv * dv
            rdot01 += dv * v01[None, :, dim]
            rdot12 += dv * v12[None, :, dim]
        mag = torch.sqrt(mag2)
        ok = mag > 0
        safe = torch.where(ok, mag, 1.0)
        a, b = nansum_count(mask, torch.where(ok, rdot01 / safe, _NAN))
        c01 += a
        s01 += b
        a, b = nansum_count(mask, torch.where(ok, rdot12 / safe, _NAN))
        c12 += a
        s12 += b
        # member count, coordinate sums and per-stat count and sum as one
        # (M, chunk) @ (chunk, 1 + d + 2S) product in float64
        valid_st = ~torch.isnan(st)
        rhs = torch.cat([torch.ones((cc.shape[0], 1), dtype=f64, device=dev), cc.double(),
                         valid_st.double().T, torch.where(valid_st, st, 0.0).double().T], dim=1)
        sums += mask.double() @ rhs
        for i in range(s):
            valid = mask & valid_st[i][None, :]
            row = st[i][None, :]
            mn_s[i] = torch.minimum(mn_s[i], torch.where(valid, row, _INF).amin(dim=1))
            mx_s[i] = torch.maximum(mx_s[i], torch.where(valid, row, -_INF).amax(dim=1))

    cm = sums[:, 0]
    scoords = sums[:, 1:1 + d].T
    cnt_s = sums[:, 1 + d:1 + d + s].T
    sum_s = sums[:, 1 + d + s:].T
    mean_s = sum_s / cnt_s.clamp(min=1.0)
    ssq_s = torch.zeros((s, m), dtype=f64, device=dev)
    for start in starts:
        cc = coords[start:start + chunk]
        st = stats[:, start:start + chunk]
        mask = _box_membership_kernel(lims_lo, lims_hi, cc)
        for i in range(s):
            valid = mask & ~torch.isnan(st[i])[None, :]
            diff = st[i][None, :].double() - mean_s[i][:, None]
            ssq_s[i] += torch.where(valid, diff * diff, 0.0).sum(dim=1)

    node_sums = torch.cat([torch.stack([c01, s01, c12, s12, cm]), scoords], dim=0)
    stat_sums = torch.stack([cnt_s, sum_s, mn_s.double(), mx_s.double(), ssq_s])
    return node_sums, stat_sums


def _node_aggregate(lims_lo, lims_hi, node_coords, coords, vec01, vec12, stats, chunk: int):
    """:func:`_node_agg_scan_kernel` and the means it gives, on the host:
    (convergence (M,), divergence (M,), coordinate means (d, M), per-key
    (S, M) voxel statistics), NaN where a node has no member."""
    node_sums, stat_sums = _node_agg_scan_kernel(
        lims_lo, lims_hi, node_coords, coords, vec01, vec12, stats, chunk)
    node_sums = node_sums.cpu().numpy()
    cnt_s, sum_s, mn_s, mx_s, ssq_s = stat_sums.cpu().numpy()
    c01, s01, c12, s12, cm = node_sums[:5]
    scoords = node_sums[5:]
    with np.errstate(invalid="ignore", divide="ignore"):
        conv = np.where(c01 > 0, s01 / np.maximum(c01, 1.0), np.nan)
        div = np.where(c12 > 0, s12 / np.maximum(c12, 1.0), np.nan)
        coord_means = np.where(cm[None] > 0, scoords / np.maximum(cm[None], 1.0), np.nan)
        empty = cnt_s == 0
        safe = np.maximum(cnt_s, 1.0)
        vox_agg = {
            "mean": np.where(empty, np.nan, sum_s / safe),
            "std_dev": np.where(empty, np.nan, np.sqrt(np.maximum(ssq_s / safe, 0.0))),
            "min": np.where(empty, np.nan, mn_s),
            "max": np.where(empty, np.nan, mx_s),
            "sum": np.where(empty, np.nan, sum_s),
        }
    return conv, div, coord_means, vox_agg


def _host_box_pairs(lo, hi, coords, shape):
    """(pair_node, pair_vox) where ``lo[n] <= coords[v] <= hi[n]`` per
    dim, as numpy range queries.  ``coords`` from :func:`np.argwhere` is
    lexicographically sorted, so the raveled key is ascending and every
    node box decomposes into contiguous key segments per leading-dims
    row, found with two vectorized ``searchsorted`` calls."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    coords = np.asarray(coords, np.int64)
    m, d = lo.shape
    empty = np.zeros(0, np.int32), np.zeros(0, np.int32)
    if m == 0 or len(coords) == 0:
        return empty
    dims = np.asarray(shape, np.int64)
    gkey = np.ravel_multi_index(tuple(coords.T), tuple(dims))
    if np.any(np.diff(gkey) < 0):  # defensive: argwhere order is sorted
        order = np.argsort(gkey, kind="stable")
        gkey = gkey[order]
    else:
        order = None
    hi_c = np.minimum(hi, dims[None, :] - 1)
    # expand each node over its leading-dims grid (all dims except last)
    ext = np.clip(hi_c[:, :-1] - lo[:, :-1] + 1, 0, None)  # (m, d-1)
    rows_per_node = np.prod(ext, axis=1)
    total = int(rows_per_node.sum())
    if total == 0:
        return empty
    node_rep = np.repeat(np.arange(m), rows_per_node)
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(rows_per_node, out=offs[1:])
    r = np.arange(total) - offs[node_rep]  # row index within node grid
    base = np.zeros(total, np.int64)  # raveled key of (leading dims, x=0)
    for dim in range(d - 2, -1, -1):
        e = ext[node_rep, dim]
        base += (lo[node_rep, dim] + r % e) * np.prod(dims[dim + 1:])
        r //= e
    a = np.searchsorted(gkey, base + lo[node_rep, -1], "left")
    b = np.searchsorted(gkey, base + hi_c[node_rep, -1], "right")
    cnt = np.maximum(b - a, 0)
    tp = int(cnt.sum())
    if tp == 0:
        return empty
    row_rep = np.repeat(np.arange(total), cnt)
    starts = np.zeros(total + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    pair_vox = (np.arange(tp) - starts[row_rep] + a[row_rep])
    if order is not None:
        pair_vox = order[pair_vox]
    return node_rep[row_rep].astype(np.int32), pair_vox.astype(np.int32)


# ---------------------------------------------------------------------------
# per-frame level tables
# ---------------------------------------------------------------------------

def _agg_columns(stat_names, agg) -> dict:
    """Flatten a segment-stats result into `{stat}_{key}` CSV columns."""
    cols = {}
    for i, name in enumerate(stat_names):
        for key in STAT_KEYS:
            cols[f"{name}_{key}"] = np.asarray(agg[key][i], float)
    return cols


def _zyx(columns: np.ndarray):
    """(z, y, x) rows of a (d, n) coordinate array, d = 2 or 3; z is NaN
    in 2D, as the reference writes ``z_raw`` empty there."""
    if len(columns) == 2:
        return np.full(columns.shape[1], np.nan, columns.dtype), columns[0], columns[1]
    return columns[0], columns[1], columns[2]


def _ids_into(member_labels: np.ndarray, row_labels: np.ndarray) -> np.ndarray:
    """Map labels to row indices of `row_labels` (sorted unique); -1 where
    absent (those members don't contribute)."""
    member_labels = np.asarray(member_labels, np.int64)
    if len(row_labels) == 0:
        return np.full(member_labels.shape, -1, np.int32)
    pos = np.searchsorted(row_labels, member_labels)
    pos_c = np.clip(pos, 0, len(row_labels) - 1)
    ok = row_labels[pos_c] == member_labels
    return np.where(ok, pos_c, -1).astype(np.int32)


def _majority_by_label(labels: np.ndarray, values: np.ndarray,
                       row_labels: np.ndarray) -> np.ndarray:
    """Most frequent value per label (ties → smallest value), NaN where a
    row label has no members — np.argmax(np.bincount(...)) semantics
    without the per-region loop."""
    out = np.full(len(row_labels), np.nan)
    labels = np.asarray(labels, np.int64)
    if labels.size == 0 or len(row_labels) == 0:
        return out
    values = np.asarray(values, np.int64)
    order = np.lexsort((values, labels))
    l, v = labels[order], values[order]
    change = np.ones(len(l), bool)
    change[1:] = (l[1:] != l[:-1]) | (v[1:] != v[:-1])
    starts = np.nonzero(change)[0]
    counts = np.diff(np.append(starts, len(l)))
    gl, gv = l[starts], v[starts]
    pick = np.lexsort((gv, -counts, gl))
    first = np.ones(len(pick), bool)
    first[1:] = gl[pick][1:] != gl[pick][:-1]
    sel = pick[first]
    idx = _ids_into(gl[sel], np.asarray(row_labels, np.int64))
    ok = idx >= 0
    out[idx[ok]] = gv[sel][ok]
    return out


class _VoxelLevel:
    """Per-voxel features of one frame: coordinates, intensity and
    structure, and the motility bundle.  ``stats_dev`` is the (11, N)
    value table on the device in VOXEL_STATS order that every higher
    level aggregates from; ``stats`` is its host copy for the CSV."""

    def __init__(self, h: "Hierarchy", t: int):
        self.t = t
        dev = h.device
        label_frame = np.asarray(h.label_components[t])
        self.coords = np.argwhere(label_frame > 0)
        n = len(self.coords)
        at = tuple(self.coords.T)
        self.component_labels = label_frame[at].astype(np.int64)
        self.branch_labels = np.asarray(h.label_branches[t])[at].astype(np.int64)
        self.intensity = np.asarray(h.im_raw[t])[at].astype(np.float32)
        self.structure = np.asarray(h.im_struct[t])[at].astype(np.float32)
        self.z, self.y, self.x = _zyx(self.coords.T.astype(np.float32))

        vec01_px = vec12_px = None
        if h.flow_interpolator_fw is not None and n > 0:
            coords_f = self.coords.astype(np.float32)
            if t > 0:
                vec01_px = h.flow_interpolator_bw.interpolate_coord_dev(coords_f, t)
            if t < h.num_t - 1:
                vec12_px = h.flow_interpolator_fw.interpolate_coord_dev(coords_f, t)
        sp = h.spacing_dev
        nan_vec = torch.full((n, self.coords.shape[1]), _NAN, device=dev)
        # flow vectors in physical units, consumed by the node level
        self.vec01_dev = nan_vec if vec01_px is None else vec01_px * sp
        self.vec12_dev = nan_vec if vec12_px is None else vec12_px * sp

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        if vec12_px is not None:
            self.stats_dev = _frame_stats_kernel(
                put(self.coords.astype(np.float32)),
                nan_vec if vec01_px is None else vec01_px, vec12_px,
                put(self.branch_labels), put(self.structure), put(self.intensity), sp,
                float(np.float32(h.im_info.dim_res["T"] or 1.0)), has01=t > 0,
                num_labels=int(self.branch_labels.max()) + 1)
            self.stats = self.stats_dev.cpu().numpy()
        else:
            self.stats = np.concatenate([
                np.full((len(_MOTILITY_KEYS), n), np.nan, np.float32),
                self.structure[None], self.intensity[None]])
            self.stats_dev = put(self.stats)

    def columns(self) -> dict:
        cols = {f"{k}_raw": self.stats[i] for i, k in enumerate(_MOTILITY_KEYS)}
        cols["structure_raw"] = self.structure
        cols["intensity_raw"] = self.intensity
        cols["x_raw"] = self.x
        cols["y_raw"] = self.y
        cols["z_raw"] = self.z
        return cols


class _NodeLevel:
    """Skeleton-voxel ("node") features: radius-box voxel membership,
    flow divergence/convergence, thickness.  Optional (skip_nodes).

    The membership-weighted statistics reduce on the device
    (:func:`_node_agg_scan_kernel`); the (node, voxel) pair lists, needed
    only for ``adjacency_maps``, come from host range queries
    (:func:`_host_box_pairs`) on the hierarchy's background worker."""

    def __init__(self, h: "Hierarchy", t: int, vox: _VoxelLevel):
        self.t = t
        dev = h.device
        pixel_class = np.asarray(h.im_pixel_class[t])
        self.nodes = np.argwhere(pixel_class > 0)
        m = len(self.nodes)
        at = tuple(self.nodes.T)
        self.component_label = np.asarray(h.label_components[t])[at].astype(np.int64)
        self.branch_label = np.asarray(h.label_branches[t])[at].astype(np.int64)

        # radius boxes from the distance image at each skeleton voxel,
        # bounds in float64 and truncated as the reference computes them
        radius = np.asarray(h.im_distance[t])[at].astype(np.float64)
        shape = pixel_class.shape
        lo = np.empty((m, len(shape)), np.int32)
        hi = np.empty((m, len(shape)), np.int32)
        for dim in range(len(shape)):
            lo[:, dim] = np.clip((self.nodes[:, dim] - radius).astype(int), 0, shape[dim])
            hi[:, dim] = np.clip((self.nodes[:, dim] + radius).astype(int) + 1, 0, shape[dim])

        spacing = np.asarray(h.spacing, np.float64)
        self.node_thickness = h._border_distance_cached(t, self.nodes) * 2.0

        c_total = len(vox.coords)
        if m and c_total:
            max_elems = h.max_node_mask_elems // (4 if h.low_memory else 1)
            chunk = int(max(1, min(h.node_chunk_size or 65536, max_elems // m, c_total)))

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            self.convergence, self.divergence, coord_means, vox_agg = _node_aggregate(
                put(lo), put(hi), put(self.nodes.astype(np.float32)),
                put(vox.coords.astype(np.int32)), vox.vec01_dev, vox.vec12_dev,
                vox.stats_dev, chunk)
            if h._vn_results is not None:
                h._pool.submit(lambda: self._submit_pairs(
                    h, *_host_box_pairs(lo, hi, vox.coords, shape)))
            self.vergere = self.convergence + self.divergence
            self.z, self.y, self.x = _zyx(coord_means * spacing[:, None])
        else:
            nanm = np.full(m, np.nan)
            self.convergence = nanm.copy()
            self.divergence = nanm.copy()
            self.vergere = nanm.copy()
            self.z = nanm.copy()
            self.y = nanm.copy()
            self.x = nanm.copy()
            vox_agg = {k: np.full((len(VOXEL_STATS), m), np.nan) for k in STAT_KEYS}
            if h._vn_results is not None:
                self._submit_pairs(h, np.zeros(0, np.int32), np.zeros(0, np.int32))
        self.aggregate_voxel_metrics = vox_agg

        self.stats = np.stack([
            np.asarray(self.divergence, np.float64),
            np.asarray(self.convergence, np.float64),
            np.asarray(self.vergere, np.float64),
            np.asarray(self.node_thickness, np.float64),
        ]) if m else np.zeros((len(NODE_STATS), 0))

    def _submit_pairs(self, h, pair_node, pair_vox):
        """Record this frame's v_n edge list, sorted by (voxel, node)."""
        order = np.lexsort((pair_node, pair_vox))
        h._vn_results[self.t] = np.column_stack(
            (pair_vox[order], pair_node[order])).astype(np.int64)

    def columns(self) -> dict:
        cols = _agg_columns(VOXEL_STATS, self.aggregate_voxel_metrics)
        for k, v in (("divergence", self.divergence), ("convergence", self.convergence),
                     ("vergere", self.vergere), ("node_thickness", self.node_thickness),
                     ("x", self.x), ("y", self.y), ("z", self.z)):
            cols[f"{k}_raw"] = np.asarray(v, float)
        return cols


class _BranchLevel:
    """Branch features: centreline length (stencil), thickness (border
    distance), tortuosity, region morphology."""

    def __init__(self, h: "Hierarchy", t: int, vox: _VoxelLevel, nodes):
        self.t = t
        dev = h.device
        skel = np.asarray(h.im_skel[t])
        skel_coords = np.argwhere(skel > 0)
        skel_labels = skel[tuple(skel_coords.T)].astype(np.int64)
        row_labels, first_idx = np.unique(skel_labels, return_index=True)
        keep = row_labels > 0
        row_labels, first_idx = row_labels[keep], first_idx[keep]
        self.branch_label = row_labels
        b = len(row_labels)
        first_coords = skel_coords[first_idx] if b else np.zeros((0, skel.ndim), int)
        self.component_label = (
            np.asarray(h.label_components[t])[tuple(first_coords.T)].astype(np.int64)
            if b else np.zeros(0, np.int64))

        self.aggregate_voxel_metrics = segment_nanstats(
            vox.stats_dev, _ids_into(vox.branch_labels, row_labels), b)
        self.aggregate_node_metrics = None
        if nodes is not None:
            self.aggregate_node_metrics = segment_nanstats(
                torch.from_numpy(nodes.stats).to(dev),
                _ids_into(nodes.branch_label, row_labels), b)

        spacing = np.asarray(h.spacing, np.float64)
        if b:
            skel_dev = h._skel_dev(t)
            if skel_dev is None:
                skel_dev = torch.from_numpy(skel.astype(np.int32)).to(dev)
            lengths_all, deg_at = branch_geometry(skel_dev, spacing, skel_coords)
            lengths = lengths_all[row_labels].astype(np.float64)

            radii = h._border_distance_cached(t, skel_coords)
            rows = _ids_into(skel_labels, row_labels)

            # tip length corrections
            tips = deg_at == 1
            lone = deg_at == 0
            np.add.at(lengths, rows[lone], 2.0 * radii[lone])
            np.add.at(lengths, rows[tips], radii[tips])

            # median thickness per branch: values sorted within each
            # label run, median = mean of the two middle elements
            thickness = np.full(b, np.nan)
            order = np.lexsort((radii * 2.0, skel_labels))
            sl, st = skel_labels[order], (radii * 2.0)[order]
            starts = np.searchsorted(sl, row_labels)
            ends = np.searchsorted(sl, row_labels, side="right")
            run = ends - starts
            has = run > 0
            mid_lo = starts + np.maximum(run - 1, 0) // 2
            mid_hi = starts + np.maximum(run, 1) // 2
            thickness[has] = 0.5 * (st[np.minimum(mid_lo[has], len(st) - 1)]
                                    + st[np.minimum(mid_hi[has], len(st) - 1)])

            swap = (~np.isnan(thickness)) & (thickness > lengths)
            thickness[swap], lengths[swap] = lengths[swap], thickness[swap].copy()
            with np.errstate(divide="ignore", invalid="ignore"):
                aspect = np.where(thickness != 0, lengths / thickness, np.nan)

            # tortuosity: length / tip-to-tip distance (first two tips)
            tortuosity = np.ones(b)
            tip_rows = rows[tips]
            tip_coords = skel_coords[tips]
            torder = np.argsort(tip_rows, kind="stable")
            tr, tc = tip_rows[torder], tip_coords[torder]
            tstarts = np.searchsorted(tr, np.arange(b))
            tends = np.searchsorted(tr, np.arange(b), side="right")
            two = np.nonzero((tends - tstarts) >= 2)[0]
            if len(two):
                p0 = tc[tstarts[two]]
                p1 = tc[tstarts[two] + 1]
                tip_dist = np.sqrt(np.sum(((p0 - p1) * spacing) ** 2, axis=1))
                pos = tip_dist > 0
                tortuosity[two[pos]] = lengths[two[pos]] / tip_dist[pos]

            self.branch_length = lengths
            self.branch_thickness = thickness
            self.branch_aspect_ratio = aspect
            self.branch_tortuosity = tortuosity
        else:
            empty = np.zeros(0)
            self.branch_length = empty
            self.branch_thickness = empty.copy()
            self.branch_aspect_ratio = empty.copy()
            self.branch_tortuosity = empty.copy()

        label_branches = np.asarray(h.label_branches[t])
        start = time.perf_counter()
        props = {r.label: r for r in regionprops(label_branches, spacing=tuple(spacing))}
        self._fill_regionprops(props, row_labels, "branch")
        h.host_seconds["regionprops"] += time.perf_counter() - start

        if h.im_branch_reassigned is not None:
            fg = label_branches > 0
            self.reassigned_label = _majority_by_label(
                label_branches[fg], np.asarray(h.im_branch_reassigned[t])[fg], row_labels)
        else:
            self.reassigned_label = np.full(b, np.nan)

        self.stats = np.stack([
            self.branch_length, self.branch_thickness, self.branch_aspect_ratio,
            self.branch_tortuosity, self.branch_area, self.branch_axis_length_maj,
            self.branch_axis_length_min, self.branch_extent, self.branch_solidity,
        ]).astype(np.float64) if b else np.zeros((len(BRANCH_STATS), 0))

    def _fill_regionprops(self, props, row_labels, prefix):
        n = len(row_labels)
        area = np.full(n, np.nan)
        maj = np.full(n, np.nan)
        mino = np.full(n, np.nan)
        extent = np.full(n, np.nan)
        solidity = np.full(n, np.nan)
        z = np.full(n, np.nan)
        y = np.full(n, np.nan)
        x = np.full(n, np.nan)
        for i, lbl in enumerate(row_labels):
            r = props.get(int(lbl))
            if r is None:
                continue
            area[i] = r.area
            maj[i] = r.major_axis_length
            mino[i] = r.minor_axis_length
            extent[i] = r.extent
            solidity[i] = r.solidity
            if len(r.centroid) == 3:
                z[i], y[i], x[i] = r.centroid
            else:
                y[i], x[i] = r.centroid
        setattr(self, f"{prefix}_area", area)
        setattr(self, f"{prefix}_axis_length_maj", maj)
        setattr(self, f"{prefix}_axis_length_min", mino)
        setattr(self, f"{prefix}_extent", extent)
        setattr(self, f"{prefix}_solidity", solidity)
        self.z, self.y, self.x = z, y, x

    def columns(self, skip_nodes: bool) -> dict:
        cols = {}
        if not skip_nodes and self.aggregate_node_metrics is not None:
            cols.update(_agg_columns(NODE_STATS, self.aggregate_node_metrics))
        cols.update(_agg_columns(VOXEL_STATS, self.aggregate_voxel_metrics))
        for k in BRANCH_STATS:
            cols[f"{k}_raw"] = np.asarray(getattr(self, k), float)
        cols["reassigned_label_raw"] = np.asarray(self.reassigned_label, float)
        cols["x_raw"] = self.x
        cols["y_raw"] = self.y
        cols["z_raw"] = self.z
        return cols


class _ComponentLevel(_BranchLevel):
    """Organelle features: morphology + aggregations of every lower level."""

    def __init__(self, h: "Hierarchy", t: int, vox: _VoxelLevel, nodes, branches):
        self.t = t
        dev = h.device
        label_frame = np.asarray(h.label_components[t]).astype(np.int64)
        row_labels = np.unique(label_frame[label_frame > 0])
        self.component_label = row_labels
        o = len(row_labels)

        self.aggregate_voxel_metrics = segment_nanstats(
            vox.stats_dev, _ids_into(vox.component_labels, row_labels), o)
        self.aggregate_node_metrics = None
        if nodes is not None:
            self.aggregate_node_metrics = segment_nanstats(
                torch.from_numpy(nodes.stats).to(dev),
                _ids_into(nodes.component_label, row_labels), o)
        self.aggregate_branch_metrics = segment_nanstats(
            torch.from_numpy(branches.stats).to(dev),
            _ids_into(branches.component_label, row_labels), o)

        spacing = tuple(float(s) for s in h.spacing)
        start = time.perf_counter()
        props = {r.label: r for r in regionprops(label_frame, spacing=spacing)}
        self._fill_regionprops(props, row_labels, "organelle")
        h.host_seconds["regionprops"] += time.perf_counter() - start

        if h.im_obj_reassigned is not None:
            fg = label_frame > 0
            self.reassigned_label = _majority_by_label(
                label_frame[fg], np.asarray(h.im_obj_reassigned[t])[fg], row_labels)
        else:
            self.reassigned_label = np.full(o, np.nan)

        self.stats = np.stack([
            self.organelle_area, self.organelle_axis_length_maj,
            self.organelle_axis_length_min, self.organelle_extent,
            self.organelle_solidity,
        ]).astype(np.float64) if o else np.zeros((len(ORGANELLE_STATS), 0))

    def columns(self, skip_nodes: bool) -> dict:
        cols = {}
        if not skip_nodes and self.aggregate_node_metrics is not None:
            cols.update(_agg_columns(NODE_STATS, self.aggregate_node_metrics))
        cols.update(_agg_columns(VOXEL_STATS, self.aggregate_voxel_metrics))
        cols.update(_agg_columns(BRANCH_STATS, self.aggregate_branch_metrics))
        for k in ORGANELLE_STATS:
            cols[f"{k}_raw"] = np.asarray(getattr(self, k), float)
        cols["reassigned_label_raw"] = np.asarray(self.reassigned_label, float)
        cols["x_raw"] = self.x
        cols["y_raw"] = self.y
        cols["z_raw"] = self.z
        return cols


def _image_columns(vox, nodes, branches, components, skip_nodes: bool, device) -> dict:
    """Whole-frame aggregations — one segment with everything in it."""
    def whole(stats, names):
        if not isinstance(stats, torch.Tensor):
            stats = torch.from_numpy(stats).to(device)
        agg = segment_nanstats(stats, np.zeros(stats.shape[1], np.int64), 1)
        return _agg_columns(names, agg)

    cols = {}
    if not skip_nodes and nodes is not None:
        cols.update(whole(nodes.stats, NODE_STATS))
    cols.update(whole(vox.stats_dev, VOXEL_STATS))
    cols.update(whole(branches.stats, BRANCH_STATS))
    cols.update(whole(components.stats, ORGANELLE_STATS))
    return cols


# ---------------------------------------------------------------------------
# CSV output
# ---------------------------------------------------------------------------

class _AsyncWorker:
    """One background thread running callables in FIFO order (CSV
    formatting and adjacency pair lists, overlapping the next frame's
    device work).  The first exception re-raises at :meth:`submit` or
    :meth:`close`."""

    def __init__(self):
        self._q = queue.Queue(maxsize=16)
        self._exc = None
        self._thread = threading.Thread(target=self._work, name="nellie-hier-worker",
                                        daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            if self._exc is not None:
                continue
            try:
                job()
            except Exception as exc:  # noqa: BLE001 — re-raised at close
                self._exc = exc

    def submit(self, fn):
        if self._exc is not None:
            raise self._exc
        self._q.put(fn)

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc


def _format_column(values: np.ndarray) -> list:
    """CSV fields of one column: integers as integers, floats as the
    shortest repr that parses back to the same float64, NaN as an empty
    field (as pandas and pyarrow write it)."""
    values = np.asarray(values)
    if values.dtype.kind in "iub":
        return list(map(str, values.astype(np.int64).tolist()))
    wide = values.astype(np.float64)
    fields = list(map(repr, wide.tolist()))
    for i in np.flatnonzero(np.isnan(wide)).tolist():
        fields[i] = ""
    return fields


def _write_csv_rows(path, data: dict, first: bool):
    """Append one frame's rows (with the header line when ``first``)."""
    columns = [_format_column(v) for v in data.values()]
    lines = [",".join(data)] if first else []
    lines.extend(map(",".join, zip(*columns)))
    text = "\n".join(lines)
    with open(path, "w" if first else "a", encoding="ascii", newline="") as f:
        f.write(text + "\n" if text else "")


class _CsvStream:
    """Per-frame append writer with a stable header; writes run on the
    shared background worker and add their seconds to ``seconds``."""

    def __init__(self, path, pool: _AsyncWorker, seconds: dict):
        self.path = path
        self.first = True
        self.pool = pool
        self.seconds = seconds

    def write(self, t, labels, cols: dict):
        n = len(labels)
        data = {"t": np.full(n, t, np.int64), "label": np.asarray(labels)}
        for k, v in cols.items():
            data[k] = np.asarray(v)
        path, first, seconds = self.path, self.first, self.seconds

        def job():
            start = time.perf_counter()
            _write_csv_rows(path, data, first)
            seconds["csv"] += time.perf_counter() - start

        self.pool.submit(job)
        self.first = False


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

class Hierarchy:
    """Frame-major feature extraction (construct with ImInfo + flags, call
    run()).  After ``run``, ``host_seconds`` holds the seconds spent in
    CSV formatting and writing (``csv``, on the background thread),
    waiting for that thread at the end (``drain``) and in region
    morphology (``regionprops``)."""

    def __init__(
        self,
        im_info: ImInfo,
        skip_nodes: bool = True,
        viewer=None,
        low_memory: bool = False,
        enable_motility: bool = True,
        enable_adjacency: bool = True,
        device="cuda",
        node_chunk_size=None,
        max_node_mask_elems: int = int(5e7),
    ):
        self.im_info = im_info
        self.low_memory = bool(low_memory)
        self.device = resolve_device(device)
        self.num_t = im_info.shape[0]
        res = im_info.dim_res
        self.spacing = ((res["Y"], res["X"]) if im_info.no_z
                        else (res["Z"], res["Y"], res["X"]))
        self.spacing_dev = torch.tensor(self.spacing, dtype=torch.float32, device=self.device)
        self.skip_nodes = skip_nodes
        self.viewer = viewer
        self.enable_motility = enable_motility
        self.enable_adjacency = enable_adjacency
        self.node_chunk_size = node_chunk_size
        self.max_node_mask_elems = int(max_node_mask_elems)

        self.im_raw = None
        self.im_struct = None
        self.im_distance = None
        self.im_skel = None
        self.im_pixel_class = None
        self.label_components = None
        self.label_branches = None
        self.im_border_mask = None
        self.im_obj_reassigned = None
        self.im_branch_reassigned = None
        self.flow_interpolator_fw = None
        self.flow_interpolator_bw = None
        self._border_cache = None
        self._pool = None
        self._vn_results = None

    def _allocate_memory(self):
        pp = self.im_info.pipeline_paths
        self.im_raw = self.im_info.get_memmap(self.im_info.im_path)
        self.im_struct = self.im_info.get_memmap(pp["im_preprocessed"])
        self.im_distance = self.im_info.get_memmap(pp["im_distance"])
        self.im_skel = self.im_info.get_memmap(pp["im_skel"])
        self.label_components = self.im_info.get_memmap(pp["im_instance_label"])
        self.label_branches = self.im_info.get_memmap(pp["im_skel_relabelled"])
        self.im_border_mask = self.im_info.get_memmap(pp["im_border"])
        self.im_pixel_class = self.im_info.get_memmap(pp["im_pixel_class"])

        self.im_obj_reassigned = None
        self.im_branch_reassigned = None
        if not self.im_info.no_t:
            obj_path = pp.get("im_obj_label_reassigned")
            br_path = pp.get("im_branch_label_reassigned")
            if obj_path and br_path and os.path.exists(obj_path) and os.path.exists(br_path):
                self.im_obj_reassigned = self.im_info.get_memmap(obj_path)
                self.im_branch_reassigned = self.im_info.get_memmap(br_path)

    def _status(self, msg):
        if self.viewer is not None:
            self.viewer.status = msg

    def _border_distance_cached(self, t, coords):
        """Border distance at skeleton coordinates.  Nodes query
        pixel_class>0 and branches im_skel>0, nearly the same voxel set,
        so the first call of a frame runs one nearest-neighbour pass over
        their union and both look their subset up by raveled index."""
        coords = np.asarray(coords)
        shape = self.im_border_mask[t].shape
        if self._border_cache is None or self._border_cache[0] != t:
            union = np.asarray(self.im_skel[t]) > 0
            if not self.skip_nodes:
                union |= np.asarray(self.im_pixel_class[t]) > 0
            ucoords = np.argwhere(union)
            udist = border_distance(np.asarray(self.im_border_mask[t]) > 0, ucoords,
                                    self.spacing, self.device)
            self._border_cache = (t, np.ravel_multi_index(tuple(ucoords.T), shape), udist)
        _, ravel, udist = self._border_cache
        if coords.size == 0:
            return np.zeros((0,), np.float32)
        # every query voxel is in the union by construction
        return udist[np.searchsorted(ravel, np.ravel_multi_index(tuple(coords.T), shape))]

    def _build_levels(self, t):
        vox = _VoxelLevel(self, t)
        nodes = None if self.skip_nodes else _NodeLevel(self, t, vox)
        branches = _BranchLevel(self, t, vox, nodes)
        components = _ComponentLevel(self, t, vox, nodes, branches)
        cols = {
            "voxels": vox.columns(),
            "branches": branches.columns(self.skip_nodes),
            "organelles": components.columns(self.skip_nodes),
            "image": _image_columns(vox, nodes, branches, components, self.skip_nodes,
                                    self.device),
        }
        if nodes is not None:
            cols["nodes"] = nodes.columns()
        return vox, nodes, branches, components, cols

    def _run_hierarchy(self):
        if self.enable_motility and not self.im_info.no_t and self.num_t > 1:
            self.flow_interpolator_fw = FlowInterpolator(self.im_info, device=self.device)
            self.flow_interpolator_bw = FlowInterpolator(self.im_info, forward=False,
                                                         device=self.device)
        else:
            self.flow_interpolator_fw = None
            self.flow_interpolator_bw = None

        self._allocate_memory()
        pp = self.im_info.pipeline_paths
        pool = _AsyncWorker()
        self._pool = pool
        self.host_seconds = {"csv": 0.0, "drain": 0.0, "regionprops": 0.0}
        names = ["voxels", "branches", "organelles", "image"]
        if not self.skip_nodes:
            names.insert(1, "nodes")
        writers = {k: _CsvStream(pp[f"features_{k}"], pool, self.host_seconds) for k in names}

        adjacency = {"v_b": [], "v_n": [], "v_o": [], "n_b": [], "n_o": [], "b_o": []}
        self._vn_results = {} if self.enable_adjacency and not self.skip_nodes else None
        try:
            for t in range(self.num_t):
                self._status(f"Extracting features. Frame: {t + 1} of {self.num_t}.")
                logger.info("Hierarchy: frame %d/%d", t + 1, self.num_t)
                vox, nodes, branches, components, cols = self._build_levels(t)
                writers["voxels"].write(t, np.arange(len(vox.coords), dtype=np.int64),
                                        cols["voxels"])
                if nodes is not None:
                    writers["nodes"].write(t, np.arange(len(nodes.nodes), dtype=np.int64),
                                           cols["nodes"])
                writers["branches"].write(t, branches.branch_label, cols["branches"])
                writers["organelles"].write(t, components.component_label, cols["organelles"])
                writers["image"].write(t, np.zeros(1, np.int64), cols["image"])
                if self.enable_adjacency:
                    self._collect_adjacency(adjacency, vox, nodes, branches, components)
            self._status("Finalizing run.")
        finally:
            start = time.perf_counter()
            pool.close()
            self.host_seconds["drain"] = time.perf_counter() - start
            self._border_cache = None
        if self._vn_results is not None:
            adjacency["v_n"] = [self._vn_results[t] for t in range(self.num_t)]
        if self.enable_adjacency:
            with open(pp["adjacency_maps"], "wb") as f:
                pickle.dump(adjacency, f)
        self._status("Done!")

    @staticmethod
    def _label_edges(member_labels, level_labels):
        """(member_idx, level_row) pairs for members whose label appears in
        the level's row labels."""
        idx = _ids_into(member_labels, np.asarray(level_labels, np.int64))
        ok = idx >= 0
        return np.column_stack((np.nonzero(ok)[0], idx[ok])).astype(np.int64)

    def _collect_adjacency(self, adjacency, vox, nodes, branches, components):
        """Sparse edge lists, with the reference's key layout and index
        conventions."""
        mask_b = vox.branch_labels > 0
        adjacency["v_b"].append(
            np.column_stack((np.nonzero(mask_b)[0], vox.branch_labels[mask_b] - 1))
            if mask_b.any() else np.zeros((0, 2), np.int64))
        mask_o = vox.component_labels > 0
        adjacency["v_o"].append(
            np.column_stack((np.nonzero(mask_o)[0], vox.component_labels[mask_o]))
            if mask_o.any() else np.zeros((0, 2), np.int64))
        if nodes is not None:
            adjacency["n_b"].append(self._label_edges(nodes.branch_label, branches.branch_label))
            adjacency["n_o"].append(
                self._label_edges(nodes.component_label, components.component_label))
        adjacency["b_o"].append(
            self._label_edges(branches.component_label, components.component_label))

    def _skel_dev(self, t):
        """Frame t's skeleton volume left on the device by the fused chain,
        or None; popped, as the Hierarchy is its last reader."""
        cache = frame_cache(self.im_info)
        skel = None if cache is None else cache.take("im_skel", t)
        return None if skel is None else skel.to(self.device)

    def run(self):
        def attempt(dev, low):
            self.low_memory = low
            self._run_hierarchy()

        adaptive_run.run_with_ladder("Hierarchy", self.device, self.low_memory, self.im_info,
                                     attempt)
