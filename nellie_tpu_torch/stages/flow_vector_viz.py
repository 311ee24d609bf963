"""Flow vectors and motion-capture markers as napari tracks and points.

Port of ``nellie_tpu/stages/flow_vector_viz.py``: each flow vector becomes
a two-point track with a ``cost`` property; markers become (t, coords)
point rows.  Host formatting of the artifacts, with numpy only.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from nellie_tpu_torch.io import ImInfo


def load_flow_vector_array(im_info: ImInfo, path: Optional[str] = None) -> np.ndarray:
    flow_path = path or im_info.pipeline_paths["flow_vector_array"]
    if not os.path.exists(flow_path):
        raise FileNotFoundError(f"Flow vector array not found: {flow_path}")
    return np.load(flow_path)


def flow_vectors_to_tracks(
    flow_vector_array: np.ndarray,
    *,
    no_z: bool,
    cost_threshold: Optional[float] = None,
    stride: int = 1,
    max_vectors: Optional[int] = None,
) -> Tuple[np.ndarray, dict]:
    """Each flow row -> a two-point napari track (origin, origin+vector)."""
    track_cols = 4 if no_z else 5
    empty = (np.empty((0, track_cols), np.float32), {"cost": np.array([], np.float32)})
    if flow_vector_array.size == 0:
        return empty

    flow = flow_vector_array
    if cost_threshold is not None:
        flow = flow[flow[:, -1] <= cost_threshold]
    if stride > 1:
        flow = flow[::stride]
    if max_vectors is not None and flow.shape[0] > max_vectors:
        flow = flow[:max_vectors]
    if flow.size == 0:
        return empty

    d = 2 if no_z else 3
    track_ids = np.arange(flow.shape[0], dtype=np.int64)
    t0 = flow[:, 0].astype(np.int64)
    cost = flow[:, -1].astype(np.float32)
    coords0 = flow[:, 1 : 1 + d].astype(np.float32)
    coords1 = coords0 + flow[:, 1 + d : 1 + 2 * d].astype(np.float32)

    tracks = np.vstack([
        np.column_stack((track_ids, t0, coords0)),
        np.column_stack((track_ids, t0 + 1, coords1)),
    ]).astype(np.float32)
    return tracks, {"cost": np.repeat(cost, 2)}


def load_flow_vectors_as_tracks(
    im_info: ImInfo, *, path=None, cost_threshold=None, stride: int = 1, max_vectors=None,
) -> Tuple[np.ndarray, dict]:
    flow = load_flow_vector_array(im_info, path=path)
    return flow_vectors_to_tracks(
        flow, no_z=im_info.no_z, cost_threshold=cost_threshold,
        stride=stride, max_vectors=max_vectors)


def load_mocap_markers_as_points(
    im_info: ImInfo, *, t_range=None, time_stride: int = 1,
    point_stride: int = 1, max_points=None,
) -> np.ndarray:
    marker_memmap = im_info.get_memmap(im_info.pipeline_paths["im_marker"])
    t_start, t_end = (0, marker_memmap.shape[0]) if t_range is None else t_range

    points = []
    for t in range(t_start, t_end, time_stride):
        coords = np.argwhere(marker_memmap[t] > 0)
        if coords.size == 0:
            continue
        if point_stride > 1:
            coords = coords[::point_stride]
        t_col = np.full((coords.shape[0], 1), t, np.int64)
        points.append(np.concatenate((t_col, coords.astype(np.int64)), axis=1))

    if points:
        out = np.vstack(points)
    else:
        out = np.empty((0, 3 if im_info.no_z else 4), np.int64)
    if max_points is not None and out.shape[0] > max_points:
        out = out[:max_points]
    return out
