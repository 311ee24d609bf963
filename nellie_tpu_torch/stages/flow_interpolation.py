"""Flow vector interpolation (forward/backward) at arbitrary coordinates.

Port of ``nellie_tpu/stages/flow_interpolation.py``: ``_interp_tile_body``
and ``_interp_all_kernel`` (``:29-77``) and ``FlowInterpolator``.  Each
query is scored against every flow vector of its frame inside the radius:

  w = (−cost) · (1/dist)          (indicator(dist==0) if any zero dist)
  w := w − min(w) + 1; w /= Σw    (shift-normalise over the radius set)
  v = Σ w · vec                   (NaN where the radius set is empty)

``interpolate_coord_dev`` leaves the vectors on the interpolator's device
for the Hierarchy; ``interpolate_coord`` is its host copy.
``interpolate_all_forward`` and ``interpolate_all_backward`` (``:210-257``)
walk coordinates through time along the interpolated flow into napari
tracks, for :class:`~nellie_tpu_torch.stages.all_tracks_for_label.LabelTracks`.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels._fp import contract, fma, reduce_sum_of_squares, sqrt, tree_sum

_INTERP_TILE = 8192


def _interp_tile_body(query_scaled, flow_scaled, vectors, costs, max_distance):
    """(Q, d) interpolated vectors, NaN rows where no flow vector lies
    within ``max_distance``.

    Rounds as XLA rounds the reference on the CPU, so that the vectors
    are equal bit for bit (the Hierarchy's branch reference voxel is an
    argmin over their lengths): a correctly rounded square root, the
    shift ``w - min(w)`` fused into the product that makes ``w``, the
    weight sum in XLA's windowed order and the product with the vectors
    in its four-lane order."""
    diff = query_scaled[:, None, :] - flow_scaled[None, :, :]
    dist = sqrt(reduce_sum_of_squares(diff))
    mask = dist <= max_distance
    cost_w = -costs[None, :]
    zero = dist == 0
    has_zero = (mask & zero).any(dim=1, keepdim=True)
    pos = dist > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, dist, torch.ones_like(dist)),
                      torch.zeros_like(dist))
    dist_w = torch.where(has_zero, zero.float(), inv)
    w_min = torch.where(mask, cost_w * dist_w, float("inf")).amin(dim=1, keepdim=True)
    w = torch.where(mask, fma(cost_w, dist_w, -w_min) + 1.0, 0.0)
    w_sum = tree_sum(w)[:, None]
    any_nb = mask.any(dim=1, keepdim=True)
    w = w / torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))
    out = contract(w, vectors)
    return torch.where(any_nb, out, torch.full_like(out, float("nan")))


def _interp_all_kernel(query_scaled, flow_scaled, vectors, costs, max_distance):
    """All queries, one tile of ``_INTERP_TILE`` rows at a time."""
    return torch.cat([
        _interp_tile_body(query_scaled[s:s + _INTERP_TILE], flow_scaled, vectors,
                          costs, max_distance)
        for s in range(0, query_scaled.shape[0], _INTERP_TILE)
    ], dim=0)


class FlowInterpolator:
    """Inverse-distance + cost weighted flow interpolation, fwd or bwd."""

    def __init__(self, im_info: ImInfo, num_t=None, max_distance_um=0.5, forward=True,
                 device="cuda"):
        self.im_info = im_info
        self.device = resolve_device(device)
        if im_info.no_t:
            return
        self.num_t = num_t
        if num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        res = im_info.dim_res
        self.scaling = ((res["Y"], res["X"]) if im_info.no_z
                        else (res["Z"], res["Y"], res["X"]))
        self.max_distance_um = max(max_distance_um * (res["T"] or 1.0), 0.5)
        self.forward = forward
        self.flow_vector_array = np.load(im_info.pipeline_paths["flow_vector_array"])
        self.current_t = None

    def _select_rows(self, t):
        """Flow rows and their anchors for timepoint t (fwd: origins; bwd:
        origins + vectors)."""
        d = len(self.scaling)
        if self.forward:
            rows = self.flow_vector_array[self.flow_vector_array[:, 0] == t]
            coords = rows[:, 1:1 + d]
        else:
            rows = self.flow_vector_array[self.flow_vector_array[:, 0] == t - 1]
            coords = rows[:, 1:1 + d] + rows[:, 1 + d:1 + 2 * d]
        self.check_rows = rows
        self.check_coords = coords
        self.current_t = t

    def interpolate_coord_dev(self, coords, t):
        """Interpolated flow vectors at ``coords`` as an (n, d) float32
        tensor on the interpolator's device (voxel units, NaN rows where
        no flow vector is within the radius), or None when frame t has no
        flow rows or there are no coordinates."""
        coords = np.asarray(coords, float)
        if self.current_t != t:
            self._select_rows(t)
        if coords.size == 0 or self.check_coords.shape[0] == 0:
            return None
        d = coords.shape[1]
        scaling = np.asarray(self.scaling, float)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        finite = ~np.isnan(coords).any(axis=1)
        query = np.where(finite[:, None], coords * scaling, 0.0)
        res = _interp_all_kernel(
            put(query), put(self.check_coords * scaling),
            put(self.check_rows[:, 1 + d:1 + 2 * d]), put(self.check_rows[:, -1]),
            float(np.float32(self.max_distance_um)))
        return torch.where(torch.from_numpy(finite).to(dev)[:, None], res, float("nan"))

    def interpolate_coord(self, coords, t):
        """Interpolated flow vectors (voxel units, float32 numpy) at
        ``coords``; NaN rows where no flow vector is within the radius."""
        coords = np.asarray(coords, float)
        if coords.size == 0:
            return np.zeros((0, coords.shape[1] if coords.ndim == 2 else 0))
        res = self.interpolate_coord_dev(coords, t)
        if res is None:
            return np.full(coords.shape, np.nan)
        return res.cpu().numpy()


def interpolate_all_forward(coords, start_t, end_t, im_info, min_track_num=0,
                            max_distance_um=0.5, device="cuda"):
    """Walk ``coords`` forward from ``start_t`` to ``end_t`` along the
    interpolated flow: napari tracks ``[id, t, (z,) y, x]`` and their
    ``frame_num`` property; a coordinate with no flow in reach stops
    (becomes NaN)."""
    flow_interpx = FlowInterpolator(im_info, forward=True, max_distance_um=max_distance_um,
                                    device=device)
    coords = np.asarray(coords, float).copy()
    tracks = []
    track_properties = {"frame_num": []}
    frame_range = np.arange(start_t, end_t)
    for t in frame_range:
        final_vector = flow_interpx.interpolate_coord(coords, t)
        if final_vector is None or len(final_vector) == 0:
            continue
        for coord_num, coord in enumerate(coords):
            if np.all(np.isnan(final_vector[coord_num])):
                coords[coord_num] = np.nan
                continue
            if t == frame_range[0]:
                tracks.append([coord_num + min_track_num, frame_range[0], *coord])
                track_properties["frame_num"].append(int(frame_range[0]))
            track_properties["frame_num"].append(int(t) + 1)
            coords[coord_num] = coord + final_vector[coord_num]
            tracks.append([coord_num + min_track_num, int(t) + 1, *coords[coord_num]])
    return tracks, track_properties


def interpolate_all_backward(coords, start_t, end_t, im_info, min_track_num=0,
                             max_distance_um=0.5, device="cuda"):
    """Walk ``coords`` backward from ``start_t`` down to ``end_t`` along the
    interpolated flow (the tracks of :func:`interpolate_all_forward`, in
    reverse time)."""
    flow_interpx = FlowInterpolator(im_info, forward=False, max_distance_um=max_distance_um,
                                    device=device)
    coords = np.asarray(coords, float).copy()
    tracks = []
    track_properties = {"frame_num": []}
    frame_range = list(np.arange(end_t, start_t + 1))[::-1]
    for t in frame_range:
        final_vector = flow_interpx.interpolate_coord(coords, t)
        if final_vector is None or len(final_vector) == 0:
            continue
        for coord_num, coord in enumerate(coords):
            if np.all(np.isnan(final_vector[coord_num])):
                coords[coord_num] = np.nan
                continue
            if t == frame_range[0]:
                tracks.append([coord_num + min_track_num, frame_range[0], *coord])
                track_properties["frame_num"].append(int(frame_range[0]))
            coords[coord_num] = coord - final_vector[coord_num]
            tracks.append([coord_num + min_track_num, int(t) - 1, *coords[coord_num]])
            track_properties["frame_num"].append(int(t) - 1)
    return tracks, track_properties
