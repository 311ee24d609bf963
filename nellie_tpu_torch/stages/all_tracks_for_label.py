"""Tracks of labelled objects through time (the GUI's track view).

Port of ``nellie_tpu/stages/all_tracks_for_label.py``: the voxels of one
label (or of every label) at a start frame are walked forward and
backward along the interpolated flow field
(:func:`~nellie_tpu_torch.stages.flow_interpolation.interpolate_all_forward`,
``interpolate_all_backward``), the two halves merged, and track points
that leave the volume or the label mask dropped.  Output is napari's
``Tracks`` format ``[track_id, t, (z,) y, x]`` and a per-point property
dict.
"""
from __future__ import annotations

import numpy as np

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.stages.flow_interpolation import (
    interpolate_all_backward,
    interpolate_all_forward,
)


class LabelTracks:
    """Forward and backward track assembly for one label or all labels."""

    def __init__(self, im_info: ImInfo, num_t: int = None, label_im_path: str = None,
                 device="cuda"):
        self.im_info = im_info
        self.device = resolve_device(device)
        self.num_t = num_t
        if label_im_path is None:
            label_im_path = self.im_info.pipeline_paths["im_instance_label"]
        self.label_im_path = label_im_path
        if num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        self.im_memmap = None
        self.label_memmap = None

    def initialize(self):
        self.label_memmap = self.im_info.get_memmap(self.label_im_path)
        self.im_memmap = self.im_info.get_memmap(self.im_info.im_path)

    def run(self, label_num=None, start_frame=0, end_frame=None, min_track_num=0,
            skip_coords=1, max_distance_um=0.5):
        """(tracks, properties) of the voxels of ``label_num`` (every label
        when None) at ``start_frame``, every ``skip_coords``-th voxel."""
        if self.label_memmap is None:
            self.initialize()
        if end_frame is None:
            end_frame = self.num_t
        num_frames = self.label_memmap.shape[0] - 1
        if start_frame > num_frames:
            return [], {}
        if label_num is None:
            coords = np.argwhere(self.label_memmap[start_frame] > 0).astype(float)
        else:
            coords = np.argwhere(self.label_memmap[start_frame] == label_num).astype(float)
        if coords.shape[0] == 0:
            return [], {}
        coords = np.array(coords[::skip_coords])
        coords_copy = coords.copy()
        tracks = []
        track_properties = {}
        if start_frame < end_frame:
            tracks, track_properties = interpolate_all_forward(
                coords, start_frame, end_frame, self.im_info, min_track_num,
                max_distance_um=max_distance_um, device=self.device)

        if start_frame > 0:
            tracks_bw, props_bw = interpolate_all_backward(
                coords_copy, start_frame, 0, self.im_info, min_track_num,
                max_distance_um=max_distance_um, device=self.device)
            tracks_bw = tracks_bw[::-1]
            for key in props_bw:
                props_bw[key] = props_bw[key][::-1]
            sort_idx = np.argsort([track[0] for track in tracks_bw])
            tracks_bw = [tracks_bw[i] for i in sort_idx]
            for key in props_bw:
                props_bw[key] = [props_bw[key][i] for i in sort_idx]
            tracks = tracks_bw + tracks
            if not track_properties:
                track_properties = props_bw
            else:
                for key in props_bw:
                    track_properties[key] = props_bw[key] + track_properties[key]

        # drop track points off the mask or out of the volume
        filtered_tracks = []
        filtered_props = {key: [] for key in track_properties} if track_properties else {}
        for track_num, track in enumerate(tracks):
            dims = tuple(int(np.round(d)) for d in track[1:])
            in_range = all(0 <= dv < self.label_memmap.shape[i] for i, dv in enumerate(dims))
            if in_range and np.min(self.label_memmap[dims]) > 0:
                filtered_tracks.append(track)
                for key, values in track_properties.items():
                    filtered_props[key].append(values[track_num])
        return filtered_tracks, filtered_props
