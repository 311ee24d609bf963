"""Stage 4 — Markers: motion-capture marker detection.

Port of ``nellie_tpu/stages/mocap_marking.py``: ``markers_frame``
(``:81``), ``markers_frame_distance`` (``:118``) and ``_run_frame``
(``:230``).  Per frame: the clamped EDT of the object mask, the outside
border shell, multi-scale LoG peaks with best-response cross-scale
suppression, and intensity-scored non-maximum suppression.  The
low-memory path (``_run_frame_chunked``, ``:254-288``) runs the same
function on halo windows of at most ``max_chunk_voxels`` core voxels, with
a halo (``_chunk_halo``, ``:216-227``) of the LoG's reach plus the
suppression distance plus the distance clamp, so that every owned voxel
sees what it sees in the whole frame.  Writes ``im_marker`` (uint8),
``im_distance`` (float32) and ``im_border`` (uint8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import edt
from nellie_tpu_torch.kernels._fp import f32
from nellie_tpu_torch.kernels.filters import binary_dilation, log_program, maximum_filter
from nellie_tpu_torch.utils import adaptive_run
from nellie_tpu_torch.utils.chunking import (
    compute_chunk_shape,
    crop_core,
    iter_uniform_windows,
    uniform_window_shapes,
)


@dataclass(frozen=True)
class MarkerParams:
    """Field for field the reference's ``MarkerParams``."""

    sigmas: Tuple[float, ...]
    z_ratio: float
    max_radius_px: float
    peak_min_distance: int
    truncate: float = 4.0
    no_z: bool = True

    def sigma_vec(self, sigma: float):
        if self.no_z:
            return (float(sigma), float(sigma))
        return (float(sigma) / self.z_ratio, float(sigma), float(sigma))


def _clamped_distance(mask: torch.Tensor, params: MarkerParams) -> torch.Tensor:
    clamp_px = int(params.max_radius_px * 2.0) + 1
    distance = edt.distance_transform(mask, max_radius_px=clamp_px)
    return torch.clamp(distance, max=f32(params.max_radius_px * 2.0))


def markers_frame(intensity, mask, base_im, params: MarkerParams, distance=None):
    """One frame: (marker uint8, distance float32, border uint8)."""
    mask = mask.bool()
    if distance is None:
        distance = _clamped_distance(mask, params)
    border = binary_dilation(mask, connectivity=1) ^ mask
    valid = mask & (distance > 0)
    base = base_im.float()

    best_resp = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    peak_mask = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    for s in params.sigmas:
        vec = params.sigma_vec(float(s))
        # the maximum filter reads the program's LoG, the peak test the one the
        # peak fusion recomputes at the voxel (filters.log_program's ``peak``)
        program, inline = log_program(base, vec, params.truncate,
                                      sunk_centre=distance is base_im, peak=True)
        log_resp = torch.clamp(-program * f32(float(s) ** 2), min=0.0)
        at_voxel = log_resp if inline is program else \
            torch.clamp(-inline * f32(float(s) ** 2), min=0.0)
        local_max = (at_voxel == maximum_filter(log_resp, 3)) & valid
        better = local_max & (at_voxel > best_resp)
        peak_mask = peak_mask | better
        best_resp = torch.where(better, at_voxel, best_resp)

    score = torch.where(peak_mask, intensity.float(), torch.zeros_like(best_resp))
    size = 2 * int(params.peak_min_distance) + 1
    keep = (score == maximum_filter(score, size)) & (score > 0)
    return keep.to(torch.uint8), distance, border.to(torch.uint8)


def markers_frame_distance(intensity, mask, params: MarkerParams):
    """Peak detection on the distance map, computed once and shared with
    the artifact."""
    mask = mask.bool()
    distance = _clamped_distance(mask, params)
    return markers_frame(intensity, mask, distance, params, distance=distance)


class Markers:
    """Mocap marker / distance / border generation."""

    def __init__(self, im_info: ImInfo, num_t=None, min_radius_um=0.20, max_radius_um=1,
                 use_im="distance", num_sigma=5, viewer=None, peak_min_distance=2,
                 device="cuda", low_memory=False, max_chunk_voxels=int(1e6)):
        self.im_info = im_info
        self.device = resolve_device(device)
        self.num_t = 1 if im_info.no_t else num_t
        if self.num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        res = im_info.dim_res
        self.z_ratio = 1.0 if im_info.no_z else res["Z"] / res["X"]
        self.min_radius_um = max(min_radius_um, res["X"])
        self.max_radius_um = max_radius_um
        self.min_radius_px = self.min_radius_um / res["X"]
        self.max_radius_px = self.max_radius_um / res["X"]
        self.use_im = use_im
        self.num_sigma = num_sigma
        self.peak_min_distance = int(peak_min_distance)
        self.truncate = 4.0
        self.viewer = viewer
        self.low_memory = bool(low_memory)
        self.max_chunk_voxels = int(max_chunk_voxels)

    def _set_default_sigmas(self):
        """σ ∈ [min_r/2, max_r/3] with a step of at least 0.2."""
        min_step = 0.2
        self.sigma_min = self.min_radius_px / 2.0
        self.sigma_max = self.max_radius_px / 3.0
        sigma_range = self.sigma_max - self.sigma_min
        if sigma_range <= 0:
            self.sigmas = [self.sigma_min]
        else:
            step = max(min_step, sigma_range / max(self.num_sigma, 1))
            self.sigmas = list(np.arange(self.sigma_min, self.sigma_max, step))
            if not self.sigmas:
                self.sigmas = [self.sigma_min]
        self._params = MarkerParams(
            sigmas=tuple(float(s) for s in self.sigmas),
            z_ratio=self.z_ratio,
            max_radius_px=float(self.max_radius_px),
            peak_min_distance=self.peak_min_distance,
            truncate=self.truncate,
            no_z=self.im_info.no_z,
        )

    def _allocate_memory(self):
        info = self.im_info
        self.label_memmap = info.get_memmap(info.pipeline_paths["im_instance_label"])
        self.im_memmap = info.get_memmap(info.im_path)
        self.shape = self.label_memmap.shape
        self.im_frangi_memmap = (info.get_memmap(info.pipeline_paths["im_preprocessed"])
                                 if self.use_im == "frangi" else None)
        self.im_marker_memmap = info.allocate_memory(
            info.pipeline_paths["im_marker"], dtype="uint8",
            description="mocap marker image", return_memmap=True)
        self.im_distance_memmap = info.allocate_memory(
            info.pipeline_paths["im_distance"], dtype="float32",
            description="distance transform image", return_memmap=True)
        self.im_border_memmap = info.allocate_memory(
            info.pipeline_paths["im_border"], dtype="uint8",
            description="border image", return_memmap=True)

    def _chunk_halo(self):
        """Per-axis halo of the windows: the LoG's reach, the suppression
        distance and the distance clamp."""
        sigma_max = float(max(self.sigmas))
        nms_h = self.peak_min_distance
        dist_h = int(np.ceil(self.max_radius_px * 2.0))
        h_xy = max(int(np.ceil(self.truncate * sigma_max)), 1) + nms_h + dist_h
        if self.im_info.no_z:
            return (h_xy, h_xy)
        log_hz = int(np.ceil(self.truncate * sigma_max / max(self.z_ratio, 1e-6)))
        return (max(log_hz, 1) + nms_h + dist_h, h_xy, h_xy)

    def _markers(self, intensity, mask, frangi):
        if frangi is not None:
            return markers_frame(intensity, mask, frangi, self._params)
        return markers_frame_distance(intensity, mask, self._params)

    def _run_frame(self, t):
        logger.info(f"Running motion capture marking, volume {t}/{self.num_t - 1}")
        mask = np.ascontiguousarray(self.label_memmap[t]) > 0
        if not mask.any():
            zero = np.zeros(mask.shape, np.uint8)
            return zero, np.zeros(mask.shape, np.float32), zero
        intensity = np.ascontiguousarray(self.im_memmap[t])
        frangi = (np.ascontiguousarray(self.im_frangi_memmap[t], np.float32)
                  if self.use_im == "frangi" else None)
        if self.low_memory:
            return self._run_frame_chunked(intensity, mask, frangi)

        def put(a):
            return None if a is None else torch.from_numpy(a).to(self.device)

        out = self._markers(put(intensity.astype(np.float32)), put(mask), put(frangi))
        return tuple(a.cpu().numpy() for a in out)

    def _run_frame_chunked(self, intensity, mask, frangi):
        """Window by window, each uploaded alone; the owned boxes are
        assembled on the host."""
        shape = mask.shape
        chunk_shape = compute_chunk_shape(shape, self.max_chunk_voxels)
        halo = self._chunk_halo()
        core_shape, _ = uniform_window_shapes(shape, chunk_shape, halo)
        out = (np.zeros(shape, np.uint8), np.zeros(shape, np.float32), np.zeros(shape, np.uint8))

        def put(a, ext):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a[ext], np.float32 if a.dtype != bool else bool)).to(self.device)

        for owned, ext, offset, local in iter_uniform_windows(shape, chunk_shape, halo):
            parts = self._markers(put(intensity, ext), put(mask, ext), put(frangi, ext))
            for dst, part in zip(out, parts):
                dst[owned] = crop_core(part, offset, core_shape)[local].cpu().numpy()
        return out

    def _run_mocap_marking(self):
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Running mocap marking. Frame: {t + 1} of {self.num_t}."
            self._write_frame(t, *self._run_frame(t))

    def _write_frame(self, t, marker, distance, border):
        for memmap, frame in ((self.im_marker_memmap, marker),
                              (self.im_distance_memmap, distance),
                              (self.im_border_memmap, border)):
            memmap[t] = frame
            memmap.flush()

    def run(self):
        def attempt(dev, low):
            self.low_memory = low
            self._allocate_memory()
            self._set_default_sigmas()
            self._run_mocap_marking()

        adaptive_run.run_with_ladder("Markers", self.device, self.low_memory, self.im_info, attempt)
