"""Stage 4 — Markers: motion-capture marker detection.

Port of ``nellie_tpu/stages/mocap_marking.py``: ``markers_frame``
(``:81``), ``markers_frame_distance`` (``:118``) and ``_run_frame``
(``:230``).  Per frame: the clamped EDT of the object mask, the outside
border shell, multi-scale LoG peaks with best-response cross-scale
suppression, and intensity-scored non-maximum suppression.  Writes
``im_marker`` (uint8), ``im_distance`` (float32) and ``im_border`` (uint8).

Not ported: the low-memory chunked path and the CPU fallback ladder.
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
from nellie_tpu_torch.kernels.filters import binary_dilation, gaussian_laplace, maximum_filter
from nellie_tpu_torch.stages import _frames


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
        log_resp = -gaussian_laplace(base, vec) * f32(float(s) ** 2)
        log_resp = torch.clamp(log_resp, min=0.0)
        local_max = (log_resp == maximum_filter(log_resp, 3)) & valid
        better = local_max & (log_resp > best_resp)
        peak_mask = peak_mask | better
        best_resp = torch.where(better, log_resp, best_resp)

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
                 device="cuda"):
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

    def _run_frame(self, t):
        logger.info(f"Running motion capture marking, volume {t}/{self.num_t - 1}")
        mask = _frames.load(self.label_memmap, t, self.device, np.int32) > 0
        if not bool(mask.any()):
            zero = torch.zeros(mask.shape, dtype=torch.uint8, device=self.device)
            return zero, torch.zeros(mask.shape, device=self.device), zero
        intensity = _frames.load(self.im_memmap, t, self.device)
        if self.use_im == "frangi":
            base = _frames.load(self.im_frangi_memmap, t, self.device)
            return markers_frame(intensity, mask, base, self._params)
        return markers_frame_distance(intensity, mask, self._params)

    def _run_mocap_marking(self):
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Running mocap marking. Frame: {t + 1} of {self.num_t}."
            marker, distance, border = self._run_frame(t)
            _frames.store(self.im_marker_memmap, t, marker, np.uint8)
            _frames.store(self.im_distance_memmap, t, distance, np.float32)
            _frames.store(self.im_border_memmap, t, border, np.uint8)

    def run(self):
        self._allocate_memory()
        self._set_default_sigmas()
        self._run_mocap_marking()
