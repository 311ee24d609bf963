"""Stage 5 — HuMomentTracking: frame-to-frame marker matching.

Port of ``nellie_tpu/stages/hu_tracking.py``, sequential path (``:410``)
with ``_prep_frame_kernel``, ``_roi_features_kernel`` and
``_frame_features_fused`` (``:76-176``): per marker a zero-padded ROI cube
is cut around it and reduced to 4 statistics (masked mean/variance of the
intensity and of the log-normalised Frangi image) and 18 log-Hu features
of its three max projections; consecutive frames are matched by
distance-gated z-scored costs.  Writes ``flow_vector_array.npy`` with rows
[t-1, z, y, x, dz, dy, dx, cost].

Not ported: the mesh frame-parallel path, the device frame cache shared
with the fused segmentation chain, and the host-tiled matcher for very
large marker counts (the port matches all markers of a pair in one tile).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import matching, moments
from nellie_tpu_torch.kernels._fp import f32, log10
from nellie_tpu_torch.kernels.filters import maximum_filter
from nellie_tpu_torch.stages import _frames

N_STATS = 4


@dataclass
class _FrameFeatures:
    coords_voxel: np.ndarray
    n: int = 0
    feats: torch.Tensor = None
    coords_phys: torch.Tensor = None


def _prep_frame_kernel(frangi: torch.Tensor, distance: torch.Tensor):
    """Log-normalised Frangi and 2x the 3^3-dilated distance."""
    f = frangi.float()
    pos = f > 0
    f = torch.where(pos, log10(torch.where(pos, f, torch.ones_like(f))), f)
    neg = f < 0
    if bool(neg.any()):
        f = torch.where(neg, f - f[neg].min(), f)
    dil = maximum_filter(distance.float(), 3) * 2.0
    return f, dil


def _roi_features_kernel(intensity_pad, frangi_pad, coords, radii, r):
    """Statistics and log-Hu features of the markers at ``coords``.

    ``*_pad``: the frame padded by ``r`` zeros per side; ``coords`` (n, 3)
    voxel coordinates; ``radii`` (n,) dilated-distance radii."""
    shape = torch.tensor([s - 2 * r for s in intensity_pad.shape], device=coords.device)
    rad = torch.ceil(radii).long()
    low = torch.minimum(torch.clamp(coords - rad[:, None], min=0), shape[None])
    high = torch.minimum(torch.clamp(coords + rad[:, None] + 1, min=0), shape[None])
    extent = high - low
    ar = torch.arange(r, device=coords.device)
    z = (low[:, 0, None] + r + ar).reshape(-1, r, 1, 1)
    y = (low[:, 1, None] + r + ar).reshape(-1, 1, r, 1)
    x = (low[:, 2, None] + r + ar).reshape(-1, 1, 1, r)
    inside = ((ar.reshape(1, r, 1, 1) < extent[:, 0].reshape(-1, 1, 1, 1))
              & (ar.reshape(1, 1, r, 1) < extent[:, 1].reshape(-1, 1, 1, 1))
              & (ar.reshape(1, 1, 1, r) < extent[:, 2].reshape(-1, 1, 1, 1)))
    cubes_i = torch.where(inside, intensity_pad[z, y, x], 0.0)
    cubes_f = torch.where(inside, frangi_pad[z, y, x], 0.0)
    n = coords.shape[0]
    stats = moments.masked_mean_variance(torch.cat([cubes_i, cubes_f]))
    stats = torch.cat([stats[:n], stats[n:]], dim=1)
    return stats, moments.log_hu(moments.hu_3d(cubes_i))


def _frame_features_fused(intensity, frangi, distance, coords, r, chunk, scaling):
    """Per-frame [stats | log-Hu] features (n, 22) and physical coords."""
    frangi_norm, dil = _prep_frame_kernel(frangi, distance)
    radii = dil[coords[:, 0], coords[:, 1], coords[:, 2]]
    pad = (r, r) * 3
    intensity_pad = torch.nn.functional.pad(intensity.float(), pad)
    frangi_pad = torch.nn.functional.pad(frangi_norm, pad)
    parts = [_roi_features_kernel(intensity_pad, frangi_pad, coords[s:s + chunk],
                                  radii[s:s + chunk], r)
             for s in range(0, coords.shape[0], chunk)]
    feats = torch.cat([torch.cat([st, hu], dim=1) for st, hu in parts], dim=0)
    scale = torch.tensor([f32(s) for s in scaling], device=coords.device)
    return feats, coords.float() * scale


def _next_multiple(n, m):
    return ((n + m - 1) // m) * m


class HuMomentTracking:
    """Hu-moment + distance cost matching across timepoints."""

    def __init__(self, im_info: ImInfo, num_t=None, max_distance_um=1.0, viewer=None,
                 roi_chunk: int = 1024, device="cuda"):
        self.im_info = im_info
        self.device = resolve_device(device)
        if im_info.no_t:
            return
        if im_info.no_z:
            raise NotImplementedError("the port runs 3D data; the 2D branch is not ported yet")
        self.num_t = num_t
        if num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        res = im_info.dim_res
        self.scaling = (res["Z"], res["Y"], res["X"])
        dt = res.get("T") or 1.0
        if res.get("T") is None:
            logger.warning("Time resolution missing; assuming 1.0s for max_distance_um scaling.")
        self.max_distance_um = max(max_distance_um * dt, 0.5)
        self.viewer = viewer
        self.roi_chunk = int(roi_chunk)

    def _allocate_memory(self):
        info = self.im_info
        self.im_memmap = info.get_memmap(info.im_path)
        self.im_frangi_memmap = info.get_memmap(info.pipeline_paths["im_preprocessed"])
        self.im_marker_memmap = info.get_memmap(info.pipeline_paths["im_marker"])
        self.im_distance_memmap = info.get_memmap(info.pipeline_paths["im_distance"])
        self.flow_vector_array_path = info.pipeline_paths["flow_vector_array"]

    def _get_frame_features(self, t) -> _FrameFeatures:
        marker = np.ascontiguousarray(self.im_marker_memmap[t]) > 0
        coords = np.argwhere(marker)
        n = coords.shape[0]
        if n == 0:
            return _FrameFeatures(np.zeros((0, 3), int), 0)
        distance = _frames.load(self.im_distance_memmap, t, self.device)
        dmax = float(distance.max())
        r = _next_multiple(max(int(np.ceil(2.0 * dmax)) * 2 + 1, 3), 4)
        feats, coords_phys = _frame_features_fused(
            _frames.load(self.im_memmap, t, self.device),
            _frames.load(self.im_frangi_memmap, t, self.device),
            distance, torch.from_numpy(coords).to(self.device), r, self.roi_chunk,
            self.scaling)
        return _FrameFeatures(coords.astype(int), n, feats, coords_phys)

    def _pair_rows(self, t, features, prev_features):
        """Rows [t-1, idx0, vec, cost] for the (t-1, t) pair."""
        if features.n == 0 or prev_features.n == 0:
            return None
        rows, cols, costs = matching.match_frames_device(
            features.coords_phys, features.feats,
            prev_features.coords_phys, prev_features.feats,
            self.max_distance_um, N_STATS)
        if len(rows) == 0:
            return None
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        costs = np.asarray(costs, np.float32)
        pre_idx = prev_features.coords_voxel[cols]
        vecs = features.coords_voxel[rows] - pre_idx
        columns = [np.full(len(rows), t - 1, np.int64)]
        columns += [pre_idx[:, d].astype(np.int64) for d in range(pre_idx.shape[1])]
        columns += [vecs[:, d].astype(np.int64) for d in range(vecs.shape[1])]
        columns += [costs]
        return np.column_stack(columns)

    def _run_hu_tracking_sequential(self):
        prev_features = None
        frame_vectors = []
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Tracking markers. Frame: {t + 1} of {self.num_t}."
            logger.info(f"Running Hu-moment tracking for frame {t + 1} of {self.num_t}")
            features = self._get_frame_features(t)
            if prev_features is not None:
                rows = self._pair_rows(t, features, prev_features)
                if rows is not None:
                    frame_vectors.append(rows)
            prev_features = features
        return frame_vectors

    def run(self):
        if self.im_info.no_t:
            logger.info("Skipping Hu moment tracking for non-temporal dataset.")
            return
        self._allocate_memory()
        frame_vectors = self._run_hu_tracking_sequential()
        if frame_vectors:
            flow_vector_array = np.concatenate(frame_vectors, axis=0)
        else:
            flow_vector_array = np.empty((0, 8), np.float32)
        np.save(self.flow_vector_array_path, flow_vector_array)
