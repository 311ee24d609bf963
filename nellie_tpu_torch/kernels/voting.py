"""Weighted label voting for voxel reassignment.

Port of ``nellie_tpu/kernels/voting.py::_vote_kernel`` (``:43-77``) with
the tie rules of ``:8-17``: candidates are grouped by (target, label) with
the heaviest candidate first, each pair's weights are summed, and each
target takes the label of its largest pair sum, ties going to the lower
label.  The multi-key orders are chained stable sorts (least significant
key first).  Pair sums are taken after the sort, sequentially inside each
group in sorted order, one group element per step across all groups: the
same float32 additions in the same order as the reference's segment sum,
deterministic on CUDA (no float atomics).
"""
from __future__ import annotations

import numpy as np
import torch

_SENTINEL = int(np.iinfo(np.int32).max)


def stable_lexsort(keys):
    """Permutation sorting by ``keys`` (most significant first), stable."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _segment_sums(values: torch.Tensor, first: torch.Tensor, live_rows: torch.Tensor):
    """Per-element sum of its run (runs start where ``first``), added
    sequentially from the run's start; runs whose first row is not in
    ``live_rows`` are left at zero."""
    n = values.shape[0]
    starts = torch.nonzero(first).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    lengths = torch.where(live_rows[starts], ends - starts, 0)
    sums = torch.zeros(starts.shape[0], dtype=values.dtype, device=values.device)
    for k in range(int(lengths.max()) if lengths.numel() else 0):
        live = lengths > k
        sums = sums + torch.where(live, values[torch.clamp(starts + k, max=n - 1)], 0.0)
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
    return sums[seg_id]


def _vote_kernel(target_flat, labels, weights, valid):
    """(N,) int targets, int labels, float32 weights, bool valid ->
    (is_winner, target, label, candidate index), one row per candidate in
    winner-first order."""
    n = target_flat.shape[0]
    dev = target_flat.device
    cand_idx = torch.arange(n, device=dev)
    tgt = torch.where(valid, target_flat.long(), _SENTINEL)
    lbl = torch.where(valid, labels.long(), _SENTINEL)
    neg_w = torch.where(valid, -weights, float("inf"))
    w = torch.where(valid, weights, 0.0)

    perm = stable_lexsort([tgt, lbl, neg_w])
    tgt_s, lbl_s, w_s, idx_s = tgt[perm], lbl[perm], w[perm], cand_idx[perm]

    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (tgt_s[1:] != tgt_s[:-1]) | (lbl_s[1:] != lbl_s[:-1])
    row_valid = tgt_s != _SENTINEL
    row_pair_sum = _segment_sums(w_s, first, row_valid)

    lead = first & row_valid
    tgt_key = torch.where(lead, tgt_s, _SENTINEL)
    neg_sum = torch.where(lead, -row_pair_sum, float("inf"))
    perm2 = stable_lexsort([tgt_key, neg_sum])
    tgt2, lbl2, idx2 = tgt_key[perm2], lbl_s[perm2], idx_s[perm2]

    win = torch.ones(n, dtype=torch.bool, device=dev)
    win[1:] = tgt2[1:] != tgt2[:-1]
    return win & (tgt2 != _SENTINEL), tgt2, lbl2, idx2
