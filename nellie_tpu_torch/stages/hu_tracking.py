"""Stage 5 — HuMomentTracking: frame-to-frame marker matching.

Port of ``nellie_tpu/stages/hu_tracking.py``, sequential path (``:410``)
with ``_prep_frame_kernel``, ``_roi_features_kernel`` and
``_frame_features_fused`` (``:76-176``): per marker a zero-padded ROI square
(2D) or cube (3D) is cut around it and reduced to 4 statistics (masked
mean/variance of the intensity and of the log-normalised Frangi image) and
6 log-Hu features of the square or 18 of the cube's three max projections;
consecutive frames are matched by distance-gated z-scored costs.  Writes
``flow_vector_array.npy`` with rows [t-1, y, x, dy, dx, cost] (2D) or
[t-1, z, y, x, dz, dy, dx, cost] (3D).

The tile-size rule is the reference's (``hu_tracking.py:308-339``):
``mode="dense"`` one tile, ``"sparse"`` tiles of 1,024 rows, ``"auto"``
tiles of 8,192, or 2,048 when the pair count exceeds ``max_dense_pairs``
or in low-memory mode.  A pair whose frames both fit one tile is matched
in one tile on the device features; otherwise by the row-tiled
``matching.match_frames`` on the host copies of the features, with the
physical coordinates taken in float64 and rounded to float32, as there.

When the fused segmentation chain ran in this process, each frame's raw
image, vesselness and distance are taken from its device cache
(:mod:`nellie_tpu_torch.utils.device_cache`, ``hu_tracking.py:241-253``)
instead of being read back from the artifacts; the low-memory rung clears
the cache instead (``:446-460``).

With a ``mesh`` of more than one device and more than two frames
(``_run_hu_tracking_mesh``, ``hu_tracking.py:360-430``) the frame features
are computed round-robin over the mesh's devices, each pair is matched on
the device of its later frame with the earlier frame's features copied
there, and the rows are assembled in t order: the same array as the
sequential loop.  The frame cache is not read under a mesh (it is
cleared, ``:446-460``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import matching, moments
from nellie_tpu_torch.kernels._fp import f32, log10
from nellie_tpu_torch.kernels.filters import maximum_filter
from nellie_tpu_torch.stages import _frames
from nellie_tpu_torch.utils import adaptive_run
from nellie_tpu_torch.utils.device_cache import frame_cache

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


def _roi_features_kernel(intensity_pad, frangi_pad, coords, radii, r, looped=False):
    """Statistics and log-Hu features of the markers at ``coords``.

    ``*_pad``: the frame padded by ``r`` zeros per side; ``coords`` (n, d)
    voxel coordinates; ``radii`` (n,) dilated-distance radii; ``looped``:
    round the moments as the reference's program over more than one chunk
    of markers does (:mod:`nellie_tpu_torch.kernels.moments`)."""
    n, ndim = coords.shape
    shape = torch.tensor([s - 2 * r for s in intensity_pad.shape], device=coords.device)
    rad = torch.ceil(radii).long()
    low = torch.minimum(torch.clamp(coords - rad[:, None], min=0), shape[None])
    high = torch.minimum(torch.clamp(coords + rad[:, None] + 1, min=0), shape[None])
    extent = high - low
    ar = torch.arange(r, device=coords.device)
    index = []
    inside = torch.ones((n,) + (r,) * ndim, dtype=torch.bool, device=coords.device)
    for axis in range(ndim):
        view = [-1 if a == axis else 1 for a in range(ndim)]
        index.append((low[:, axis, None] + r + ar).reshape(n, *view))
        inside = inside & (ar.reshape(1, *view) < extent[:, axis].reshape((n,) + (1,) * ndim))
    cubes_i = torch.where(inside, intensity_pad[tuple(index)], 0.0)
    cubes_f = torch.where(inside, frangi_pad[tuple(index)], 0.0)
    stats = moments.masked_mean_variance(torch.cat([cubes_i, cubes_f]))
    stats = torch.cat([stats[:n], stats[n:]], dim=1)
    return stats, moments.hu_features(cubes_i, looped)


def _frame_features_fused(intensity, frangi, distance, coords, r, chunk, scaling):
    """Per-frame [stats | log-Hu] features (n, 10 in 2D, 22 in 3D) and
    physical coords."""
    frangi_norm, dil = _prep_frame_kernel(frangi, distance)
    radii = dil[tuple(coords.T)]
    pad = (r, r) * coords.shape[1]
    intensity_pad = torch.nn.functional.pad(intensity.float(), pad)
    frangi_pad = torch.nn.functional.pad(frangi_norm, pad)
    looped = coords.shape[0] > chunk
    parts = [_roi_features_kernel(intensity_pad, frangi_pad, coords[s:s + chunk],
                                  radii[s:s + chunk], r, looped)
             for s in range(0, coords.shape[0], chunk)]
    feats = torch.cat([torch.cat([st, hu], dim=1) for st, hu in parts], dim=0)
    scale = torch.tensor([f32(s) for s in scaling], device=coords.device)
    return feats, coords.float() * scale


def _next_multiple(n, m):
    return ((n + m - 1) // m) * m


class HuMomentTracking:
    """Hu-moment + distance cost matching across timepoints."""

    def __init__(self, im_info: ImInfo, num_t=None, max_distance_um=1.0, viewer=None,
                 roi_chunk: int = 1024, device="cuda", mode: str = "auto",
                 max_dense_pairs: int = int(1e7), low_memory: bool = False, mesh=None):
        self.im_info = im_info
        self.mesh = mesh
        # with a mesh, the stage's own device is the mesh's first
        self.device = resolve_device(device) if mesh is None else mesh.flat()[0]
        self.mode = mode
        self.max_dense_pairs = int(max_dense_pairs)
        self.low_memory = bool(low_memory)
        self._cache = None
        if im_info.no_t:
            return
        self.num_t = num_t
        if num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        res = im_info.dim_res
        self.scaling = ((res["Y"], res["X"]) if im_info.no_z
                        else (res["Z"], res["Y"], res["X"]))
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

    def _frame(self, key, memmap, t, dev):
        """Frame t of an artifact on ``dev``: the fused chain's cached
        tensor when there is one, else read from ``memmap``."""
        cached = self._cache.take(key, t) if self._cache is not None else None
        if cached is not None:
            return cached.to(dev)
        return _frames.load(memmap, t, dev)

    def _get_frame_features(self, t, dev=None) -> _FrameFeatures:
        dev = self.device if dev is None else dev
        intensity = self._frame("im", self.im_memmap, t, dev)
        frangi = self._frame("im_preprocessed", self.im_frangi_memmap, t, dev)
        distance = self._frame("im_distance", self.im_distance_memmap, t, dev)
        marker = np.ascontiguousarray(self.im_marker_memmap[t]) > 0
        coords = np.argwhere(marker)
        n = coords.shape[0]
        if n == 0:
            return _FrameFeatures(np.zeros((0, marker.ndim), int), 0)
        dmax = float(distance.max())
        r = _next_multiple(max(int(np.ceil(2.0 * dmax)) * 2 + 1, 3), 4)
        feats, coords_phys = _frame_features_fused(
            intensity, frangi, distance, torch.from_numpy(coords).to(dev), r,
            self.roi_chunk, self.scaling)
        return _FrameFeatures(coords.astype(int), n, feats, coords_phys)

    def _tile_rows(self, n_post, n_pre):
        if self.mode == "dense":
            return max(n_post, 1)
        if self.mode == "sparse":
            return 1024
        too_big = n_post * n_pre > self.max_dense_pairs
        return 2048 if (too_big or self.low_memory) else 8192

    def _match_frames(self, frame_t: _FrameFeatures, frame_prev: _FrameFeatures, dev):
        n_post, n_pre = frame_t.n, frame_prev.n
        tile_rows = self._tile_rows(n_post, n_pre)
        if n_post <= tile_rows and n_pre <= tile_rows:
            return matching.match_frames_device(
                frame_t.coords_phys, frame_t.feats, frame_prev.coords_phys, frame_prev.feats,
                self.max_distance_um, N_STATS, chunk=self.roi_chunk)
        scaling = np.asarray(self.scaling, float)
        feats_t = frame_t.feats.cpu().numpy()
        feats_prev = frame_prev.feats.cpu().numpy()
        return matching.match_frames(
            frame_t.coords_voxel * scaling, frame_prev.coords_voxel * scaling,
            feats_t[:, :N_STATS], feats_prev[:, :N_STATS],
            feats_t[:, N_STATS:], feats_prev[:, N_STATS:],
            self.max_distance_um, tile_rows=tile_rows, device=dev)

    def _pair_rows(self, t, features, prev_features, dev=None):
        """Rows [t-1, idx0, vec, cost] for the (t-1, t) pair."""
        if features.n == 0 or prev_features.n == 0:
            return None
        rows, cols, costs = self._match_frames(features, prev_features,
                                               self.device if dev is None else dev)
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

    def _run_hu_tracking_mesh(self):
        """Frame features round-robin over the mesh's devices from a thread
        pool, then each pair on its later frame's device; rows in t order."""
        from nellie_tpu_torch.mesh.sharded import thread_pool

        devs = self.mesh.flat()
        feats = [None] * self.num_t

        def features_one(t):
            logger.info(f"Tracking features (mesh) frame {t + 1} of {self.num_t}")
            feats[t] = self._get_frame_features(t, devs[t % len(devs)])

        workers = max(1, min(len(devs), self.num_t))
        with thread_pool(workers, devs) as ex:
            list(ex.map(features_one, range(self.num_t)))
        pair_rows = [None] * (self.num_t - 1)

        def match_one(t):
            dev = devs[t % len(devs)]
            prev = feats[t - 1]
            if prev.feats is not None:
                prev = replace(prev, feats=prev.feats.to(dev),
                               coords_phys=prev.coords_phys.to(dev))
            pair_rows[t - 1] = self._pair_rows(t, feats[t], prev, dev)

        with thread_pool(workers, devs) as ex:
            list(ex.map(match_one, range(1, self.num_t)))
        return [r for r in pair_rows if r is not None]

    def _use_mesh(self):
        return self.mesh is not None and self.num_t > 2 and self.mesh.devices.size > 1

    def run(self):
        if self.im_info.no_t:
            logger.info("Skipping Hu moment tracking for non-temporal dataset.")
            return

        def attempt(dev, low):
            self.low_memory = low
            self._cache = frame_cache(self.im_info)
            if (low or self.mesh is not None) and self._cache is not None:
                # the low-memory rung exists because memory is tight, and
                # under a mesh frames run on other devices: free the fused
                # chain's frames instead of reading them
                self._cache.clear()
                self._cache = None
            self._run_hu_tracking()

        adaptive_run.run_with_ladder("HuMomentTracking", self.device, self.low_memory,
                                     self.im_info, attempt)

    def _run_hu_tracking(self):
        self._allocate_memory()
        frame_vectors = (self._run_hu_tracking_mesh() if self._use_mesh()
                         else self._run_hu_tracking_sequential())
        if frame_vectors:
            flow_vector_array = np.concatenate(frame_vectors, axis=0)
        else:
            flow_vector_array = np.empty((0, 2 + 2 * len(self.scaling)), np.float32)
        np.save(self.flow_vector_array_path, flow_vector_array)
