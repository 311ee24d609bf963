"""Euclidean distance transform and object-constrained nearest seed.

Port of ``nellie_tpu/kernels/edt.py``:

* ``distance_transform`` (``:217``) is exact: the squared EDT factorises
  into per-axis windowed min-plus transforms (Felzenszwalb & Huttenlocher).
* ``nearest_seed`` (``:72``) keeps the reference's jump flooding with the
  same JFA+1 step schedule, offset order and strict-``<`` updates, so that
  its rare approximate answers are the reference's too.  An exact nearest
  seed is later work (ROADMAP).
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import torch

from nellie_tpu_torch.kernels._fp import f32, sqrt, sum_of_products
from nellie_tpu_torch.kernels.filters import pad_constant


def _offsets(ndim: int):
    return [o for o in itertools.product((-1, 0, 1), repeat=ndim) if any(v != 0 for v in o)]


def nearest_seed(
    seed_labels: torch.Tensor,
    obj_labels: Optional[torch.Tensor] = None,
    sampling: Tuple[float, ...] = None,
    max_radius_px: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel nearest seed by JFA+1.

    Returns (labels, distances): the nearest seed's value (0 where none is
    reachable) and the physical distance to it (+inf where none).  With
    ``obj_labels`` a voxel only accepts seeds of its own object."""
    shape = tuple(seed_labels.shape)
    ndim = len(shape)
    dev = seed_labels.device
    if sampling is None:
        sampling = (1.0,) * ndim
    samp = [f32(s) for s in sampling]
    reach = max(shape)
    if max_radius_px is not None:
        reach = min(reach, int(max_radius_px) + 1)
    n_steps = max(1, int(math.ceil(math.log2(max(reach, 2)))))
    steps = [1 << (n_steps - 1 - i) for i in range(n_steps)] + [1]

    coords = [torch.arange(s, device=dev, dtype=torch.int32).reshape(
        [s if a == ax else 1 for a in range(ndim)]) for ax, s in enumerate(shape)]
    strides = [1] * ndim
    for ax in range(ndim - 2, -1, -1):
        strides[ax] = strides[ax + 1] * shape[ax + 1]
    flat_idx = sum(c * strides[ax] for ax, c in enumerate(coords)).expand(shape).to(torch.int32)

    def seed_dist(idx):
        rem = idx
        diffs = []
        for ax in range(ndim):
            if ax < ndim - 1:
                q = torch.div(rem, strides[ax], rounding_mode="floor")
                rem = rem - q * strides[ax]
            else:
                q = rem
            diff = (coords[ax] - q).float() * samp[ax]
            diffs.append((diff, diff))
        d = sum_of_products(diffs)
        return torch.where(idx >= 0, d, float("inf"))

    is_seed = seed_labels > 0
    idx = torch.where(is_seed, flat_idx, -1).to(torch.int32)
    has_obj = obj_labels is not None
    if has_obj:
        my_obj = obj_labels.to(torch.int32)
        obj = torch.where(is_seed, my_obj, -1).to(torch.int32)

    for step in steps:
        cur_d = seed_dist(idx)
        for off in _offsets(ndim):
            shifts = tuple(-o * step for o in off)
            cand_idx = torch.roll(idx, shifts=shifts, dims=tuple(range(ndim)))
            src_ok = torch.ones(shape, dtype=torch.bool, device=dev)
            for axis, o in enumerate(off):
                if o != 0:
                    src = coords[axis] + o * step
                    src_ok = src_ok & (src >= 0) & (src < shape[axis])
            valid = src_ok & (cand_idx >= 0)
            if has_obj:
                cand_obj = torch.roll(obj, shifts=shifts, dims=tuple(range(ndim)))
                valid = valid & (cand_obj == my_obj)
            cand_d = torch.where(valid, seed_dist(cand_idx), float("inf"))
            take = cand_d < cur_d
            idx = torch.where(take, cand_idx, idx)
            if has_obj:
                obj = torch.where(take, cand_obj, obj)
            cur_d = torch.where(take, cand_d, cur_d)

    valid = idx >= 0
    labels = torch.where(valid, seed_labels.reshape(-1)[torch.clamp(idx, min=0).long()], 0)
    return labels, sqrt(seed_dist(idx))


def _minplus_axis(f_sq: torch.Tensor, axis: int, radius: int, s: float) -> torch.Tensor:
    """out[i] = min_{|k|<=radius} f_sq[i+k] + (k*s)^2, out of bounds = +inf."""
    n = f_sq.shape[axis]
    fp = pad_constant(f_sq, axis, radius, radius, float("inf"))
    out = None
    for k in range(2 * radius + 1):
        cand = fp.narrow(axis, k, n) + f32(((k - radius) * s) ** 2)
        out = cand if out is None else torch.minimum(out, cand)
    return out


def distance_transform(mask: torch.Tensor, sampling: Tuple[float, ...] = None,
                       max_radius_px: Optional[int] = None) -> torch.Tensor:
    """Distance from each True voxel to the nearest False voxel
    (``scipy.ndimage.distance_transform_edt``); exact within
    ``max_radius_px``, an over-estimate only beyond it."""
    ndim = mask.ndim
    if sampling is None:
        sampling = (1.0,) * ndim
    f = torch.where(mask, float("inf"), 0.0).float()
    for axis in range(ndim):
        r = mask.shape[axis] - 1
        if max_radius_px is not None:
            r = min(r, int(max_radius_px))
        f = _minplus_axis(f, axis, r, float(sampling[axis]))
    dist = torch.nan_to_num(sqrt(f), posinf=float(max(mask.shape)))
    return torch.where(mask, dist, torch.zeros_like(dist))
