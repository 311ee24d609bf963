"""Connectivity over a frame's shards: hole filling, the area filter and
scipy-numbered labels.

The capacity path's cell machinery (``pipeline/capacity.py``:
``_cell_roots``, ``_merge_cells``, ``_fill_holes_chunked``,
``_remove_small_chunked``, ``_label_chunked``) with the shards of a
:class:`~nellie_tpu_torch.mesh.sharded.ShardPlan` as the cells, each on
its own device.  Every voxel of a piece carries the piece's global minimum
raveled index (its root); a host union-find joins the roots adjacent
across the boundary planes between shards; a component's merged root is
its minimum raveled index, so ranking the merged roots numbers the labels
as scipy does, and the results equal the whole frame's
(``kernels/ccl.py``) exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.kernels import ccl


def vol_strides(vol_shape):
    return tuple(int(np.prod(vol_shape[i + 1:])) for i in range(len(vol_shape)))


def _roots(shards, plan, invert: bool, connectivity: str) -> list:
    """Per shard: int64 roots (global minimum raveled index of each piece,
    -1 where the voxel does not take part) and the cell-local roots."""
    from nellie_tpu_torch.pipeline.capacity import _local_to_global_flat

    out = []
    for k, m in enumerate(shards):
        m = ~m if invert else m
        n_local = m.numel()
        local = ccl.union_find_roots(m, connectivity)
        g = _local_to_global_flat(local, plan.origin(k), tuple(m.shape), plan.shape)
        out.append((torch.where(local < n_local, g, -1).reshape(m.shape), local))
    return out


def _plane(roots: torch.Tensor, axis: int, index: int) -> np.ndarray:
    return roots.narrow(axis, index, 1).squeeze(axis).cpu().numpy()


def _merge(roots, plan, connectivity: str, border_outside: bool = False):
    """The host union-find over the planes between consecutive shards; with
    ``border_outside`` also every known root connected to the frame's
    border."""
    from nellie_tpu_torch.pipeline.capacity import _HostUnionFind, _plane_pair_edges

    uf = _HostUnionFind()
    ax = plan.axis
    for k in range(plan.n - 1):
        left = _plane(roots[k], ax, roots[k].shape[ax] - 1)
        right = _plane(roots[k + 1], ax, 0)
        uf.union_pairs(*_plane_pair_edges(left, right, connectivity))
    if not border_outside:
        return uf, None
    border = []
    for axis in range(len(plan.shape)):
        for k, r in enumerate(roots):
            if axis == ax and plan.n > 1:
                # the split axis meets the border only in the end shards
                sides = ([0] if k == 0 else []) + ([r.shape[axis] - 1] if k == plan.n - 1 else [])
            else:
                sides = [0, r.shape[axis] - 1]
            for index in sides:
                p = _plane(r, axis, index)
                border.append(np.unique(p[p >= 0]))
    border = np.unique(np.concatenate(border)) if border else np.empty(0, np.int64)
    outside_final = {uf.find(int(r)) for r in border}
    known = uf.nodes | {int(r) for r in border}
    return uf, {r for r in known if uf.find(r) in outside_final}


def _table(ids, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sorted(ids), np.int64), device=dev)


def fill_holes(mask, plan) -> list:
    """scipy ``binary_fill_holes``: background pieces not joined to the
    frame's border become foreground (``ccl.fill_holes``)."""
    roots = [r for r, _ in _roots(mask, plan, invert=True, connectivity="faces")]
    _, outside = _merge(roots, plan, "faces", border_outside=True)
    out = []
    for m, r in zip(mask, roots):
        hit = torch.isin(r, _table(outside, r.device))
        out.append(m | ((r >= 0) & ~hit))
    return out


def remove_small(mask, plan, min_size: int) -> list:
    """``ccl.remove_small_components``: each shard's pieces and sizes, the
    sizes summed over merged pieces, the small components dropped."""
    from nellie_tpu_torch.pipeline.capacity import _local_to_global_flat

    rl = _roots(mask, plan, invert=False, connectivity="full")
    roots = [r for r, _ in rl]
    tables = []
    for k, (_, local) in enumerate(rl):
        n_local = local.numel()
        sizes = torch.bincount(torch.where(local < n_local, local, n_local),
                               minlength=n_local + 1)[:n_local]
        ridx = torch.nonzero(sizes).reshape(-1)
        g = _local_to_global_flat(ridx, plan.origin(k), plan.shard_shape(k), plan.shape)
        tables.append((g.cpu().numpy(), sizes[ridx].cpu().numpy()))
    uf, _ = _merge(roots, plan, "full")
    total = {}
    for g, counts in tables:
        for r, c in zip(g.tolist(), counts.tolist()):
            f = uf.find(r)
            total[f] = total.get(f, 0) + c
    small = [r for g, _ in tables for r in g.tolist() if total[uf.find(r)] < min_size]
    return [m & ~torch.isin(r, _table(small, r.device)) for m, r in zip(mask, roots)]


def label(mask, plan):
    """(int32 label shards, component count), numbered like
    ``scipy.ndimage.label`` with the full structuring element."""
    roots = [r for r, _ in _roots(mask, plan, invert=False, connectivity="full")]
    uf, _ = _merge(roots, plan, "full")
    pieces = [torch.unique(r[r >= 0]).cpu().numpy() for r in roots]
    all_roots = np.unique(np.concatenate(pieces)) if pieces else np.empty(0, np.int64)
    final_of = np.asarray([uf.find(int(r)) for r in all_roots], np.int64)
    finals, inverse = np.unique(final_of, return_inverse=True)
    label_of_root = (np.arange(1, len(finals) + 1, dtype=np.int64)[inverse]
                     if len(all_roots) else np.zeros(1, np.int64))
    keys = all_roots if len(all_roots) else np.zeros(1, np.int64)
    out = []
    for r in roots:
        dev = r.device
        table = torch.as_tensor(keys, device=dev)
        values = torch.as_tensor(label_of_root.astype(np.int32), device=dev)
        idx = torch.clamp(torch.searchsorted(table, r), max=table.numel() - 1)
        out.append(torch.where(r >= 0, values[idx], 0).to(torch.int32))
    return out, int(len(finals))
