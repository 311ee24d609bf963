"""Marker matching: masked pairwise costs and mutual argmin under a cutoff.

Port of ``nellie_tpu/kernels/matching.py``: ``pair_stats`` (masked sums
for z-scoring each feature difference over distance-gated pairs),
``pair_costs`` (z-scored cost, row and column minima), ``_select_matches``
(the reference's union of row and column candidates under cost 1.0) and
``match_frames_device``, the single-tile path the JAX stage takes.  The
port holds all marker pairs of a frame pair in one tile; the JAX package's
host-tiled ``match_frames`` for very large marker counts is not ported.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nellie_tpu_torch.kernels._fp import f32, fma, reduce_sum_of_squares

COST_CUTOFF = 1.0


def _pair_mask_and_dist(coords_post, coords_pre, max_distance):
    diff = coords_post[:, None, :] - coords_pre[None, :, :]
    dist = torch.sqrt(reduce_sum_of_squares(diff))
    return dist / max_distance, dist < max_distance


def pair_stats(coords_post, coords_pre, feats_post, feats_pre, max_distance):
    """(count, sum_f, sumsq_f) over distance-gated pairs, F+1 entries with
    the normalised distance first."""
    dist_n, mask = _pair_mask_and_dist(coords_post, coords_pre, max_distance)
    maskf = mask.float()
    sums = [(dist_n * maskf).sum()]
    sumsqs = [(dist_n * dist_n * maskf).sum()]
    for f in range(feats_post.shape[1]):
        d = (feats_post[:, f][:, None] - feats_pre[:, f][None, :]).abs()
        sums.append((d * maskf).sum())
        sumsqs.append((d * d * maskf).sum())
    return int(mask.sum()), torch.stack(sums), torch.stack(sumsqs)


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
    sums = sums.cpu().numpy().astype(np.float64)
    sumsqs = sumsqs.cpu().numpy().astype(np.float64)
    mean = sums / count
    var = np.maximum(sumsqs / count - mean ** 2, 0.0)
    std = np.sqrt(var) + 1e-8
    dev = coords_post.device
    rmv, rmi, cmv, cmi = pair_costs(
        coords_post, coords_pre, feats_post, feats_pre, max_d,
        torch.from_numpy(mean.astype(np.float32)).to(dev),
        torch.from_numpy(std.astype(np.float32)).to(dev), n_stats)
    return _select_matches(rmv.cpu().numpy(), rmi.cpu().numpy(),
                           cmv.cpu().numpy(), cmi.cpu().numpy(), n_post, n_pre)
