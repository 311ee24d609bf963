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
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
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
    return dist / max_distance, dist < max_distance


def pair_stats(coords_post, coords_pre, feats_post, feats_pre, max_distance):
    """(count, sum_f, sumsq_f) over distance-gated pairs, F+1 entries with
    the normalised distance first.

    Each masked (rows, cols) sum is XLA's CPU tree reduction
    (:func:`_fp.tree_sum_2d`); its first level, the 32 x 32 windows, is
    taken here one window element at a time for every window and feature
    at once, so that no (rows, cols, F) array is built."""
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
    return (int(mask.sum()), tree_sum_2d(sums.permute(2, 0, 1)),
            tree_sum_2d(sumsqs.permute(2, 0, 1)))


def pair_costs(coords_post, coords_pre, feats_post, feats_pre, max_distance,
               mean, std, n_stats):
    """(row_min_val, row_min_idx, col_min_val, col_min_idx) of the cost."""
    dist_n, mask = _pair_mask_and_dist(coords_post, coords_pre, max_distance)
    n_feat = feats_post.shape[1]
    n_hu = n_feat - n_stats
    cost = (dist_n - mean[0]) / std[0]
    for f in range(n_feat):
        d = (feats_post[:, f][:, None] - feats_pre[:, f][None, :]).abs()
        z = (d - mean[1 + f]) / std[1 + f]
        cost = fma(z, f32(1.0 / (n_stats if f < n_stats else n_hu)), cost)
    cost = torch.where(mask, cost, torch.full_like(cost, float("inf")))
    row_min_val, row_min_idx = cost.min(dim=1)
    col_min_val, col_min_idx = cost.min(dim=0)
    return row_min_val, row_min_idx, col_min_val, col_min_idx


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
    max_distance: float, n_stats: int,
) -> Tuple[list, list, list]:
    """Matching over device-resident features: two reductions on the device,
    the z-score moments in float64 on the host between them."""
    n_post, n_pre = coords_post.shape[0], coords_pre.shape[0]
    if n_post == 0 or n_pre == 0:
        return [], [], []
    max_d = f32(max_distance)
    count, sums, sumsqs = pair_stats(coords_post, coords_pre, feats_post, feats_pre, max_d)
    if count == 0:
        return [], [], []
    mean, std = _moments(count, sums.cpu().numpy().astype(np.float64),
                         sumsqs.cpu().numpy().astype(np.float64))
    dev = coords_post.device
    rmv, rmi, cmv, cmi = pair_costs(
        coords_post, coords_pre, feats_post, feats_pre, max_d,
        torch.from_numpy(mean.astype(np.float32)).to(dev),
        torch.from_numpy(std.astype(np.float32)).to(dev), n_stats)
    return _select_matches(rmv.cpu().numpy(), rmi.cpu().numpy(),
                           cmv.cpu().numpy(), cmi.cpu().numpy(), n_post, n_pre)


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
    device="cpu",
) -> Tuple[list, list, list]:
    """Matching in row tiles of ``tile_rows`` later-frame markers, each
    tile on ``device``; host arrays in, (rows, cols, costs) out with the
    selection of :func:`_select_matches`."""
    n_post, n_pre = coords_post.shape[0], coords_pre.shape[0]
    if n_post == 0 or n_pre == 0:
        return [], [], []
    dev = resolve_device(device)
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
    for _, _, c, f in tiles:
        cnt, s, ss = pair_stats(c, coords_pre_d, f, feats_pre_d, max_d)
        count += cnt
        sums = sums + s.cpu().numpy().astype(np.float64)
        sumsqs = sumsqs + ss.cpu().numpy().astype(np.float64)
    if count == 0:
        return [], [], []
    mean, std = _moments(count, sums, sumsqs)

    # phase B: tile costs; row minima per tile, column minima across tiles
    # (an earlier tile keeps a tie)
    row_min_val = np.full(n_post, np.inf, np.float32)
    row_min_idx = np.full(n_post, -1, np.int64)
    col_min_val = np.full(n_pre, np.inf, np.float32)
    col_min_idx = np.full(n_pre, -1, np.int64)
    mean_d, std_d = put(mean), put(std)
    for start, end, c, f in tiles:
        rmv, rmi, cmv, cmi = pair_costs(c, coords_pre_d, f, feats_pre_d, max_d,
                                        mean_d, std_d, n_stats)
        row_min_val[start:end] = rmv.cpu().numpy()
        row_min_idx[start:end] = rmi.cpu().numpy()
        cmv, cmi = cmv.cpu().numpy(), cmi.cpu().numpy()
        better = cmv < col_min_val
        col_min_val = np.where(better, cmv, col_min_val)
        col_min_idx = np.where(better, cmi + start, col_min_idx)
    return _select_matches(row_min_val, row_min_idx, col_min_val, col_min_idx, n_post, n_pre)
