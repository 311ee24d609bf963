"""Stage 2 — Label: threshold + connected-component instance segmentation.

Port of ``nellie_tpu/stages/labelling.py``, full-volume path
(``_run_frame_full_volume``, ``:265``) with the kernels at ``:49-92``:
log10-domain min(triangle, Otsu) Frangi threshold (optionally gated by an
intensity Otsu or fixed threshold), hole filling (3D only), the
small-component filter, a 3^d box-mean smoothing and scipy-numbered labelling.  Writes the
int32 ``im_instance_label`` artifact.

Not ported: the chunked-Z path with host union-find merging, the
mesh-batched path and the CPU fallback ladder.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.kernels import thresholds as thr_k
from nellie_tpu_torch.kernels._fp import f32, log10
from nellie_tpu_torch.kernels.filters import uniform_filter
from nellie_tpu_torch.stages import _frames


def _stride_valid(flat: torch.Tensor, step: int) -> torch.Tensor:
    if step <= 1:
        return flat > 0
    pos = torch.arange(flat.shape[0], device=flat.device) % step == 0
    return pos & (flat > 0)


def _frangi_threshold_kernel(frangi_flat, gate_flat, gate_thresh, nbins, step):
    """log10-domain min(triangle, Otsu) over the sampled positive values,
    optionally gated by ``gate_flat > gate_thresh``.  Returns
    (threshold, any_valid)."""
    valid = _stride_valid(frangi_flat, step)
    if gate_flat is not None:
        valid = valid & (gate_flat > f32(gate_thresh))
    logv = log10(torch.where(frangi_flat > 0, frangi_flat, torch.ones_like(frangi_flat)))
    tri = thr_k.triangle_threshold(logv, valid, nbins)
    ots, _ = thr_k.otsu_threshold(logv, valid, nbins)
    ten = torch.tensor(10.0, device=frangi_flat.device)
    return torch.minimum(torch.pow(ten, tri), torch.pow(ten, ots)), bool(valid.any())


def _intensity_otsu_kernel(frame_flat, nbins, step):
    valid = _stride_valid(frame_flat, step)
    ots, _ = thr_k.otsu_threshold(frame_flat.float(), valid, nbins)
    return ots, bool(valid.any())


def _label_frame_kernel(frangi, original, intensity_thresh, frangi_thresh,
                        min_area, fill, use_intensity):
    """mask -> fill holes -> area filter -> smooth -> label."""
    f = frangi.float()
    if use_intensity:
        f = f * (original > f32(intensity_thresh))
    mask = f > f32(frangi_thresh)
    if fill:
        mask = ccl.fill_holes(mask)
    mask = ccl.remove_small_components(mask, min_area)
    mask = uniform_filter(mask.float(), 3) > 0.5
    labels, _ = ccl.label(mask)
    return labels


class Label:
    """Instance segmentation of organelles from the Frangi image."""

    def __init__(self, im_info: ImInfo,
                 num_t=None,
                 threshold=None,
                 otsu_thresh_intensity=False,
                 viewer=None,
                 min_radius_um=0.25,
                 threshold_sampling_pixels=1_000_000,
                 histogram_nbins=256,
                 device="cuda"):
        self.im_info = im_info
        self.device = resolve_device(device)
        self.num_t = num_t
        if num_t is None and not im_info.no_t:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        self.threshold = threshold
        self.otsu_thresh_intensity = otsu_thresh_intensity
        self.viewer = viewer
        x_res = im_info.dim_res.get("X") or 1.0
        self.min_radius_um = max(float(min_radius_um), float(x_res))
        self.threshold_sampling_pixels = int(threshold_sampling_pixels)
        self.histogram_nbins = int(histogram_nbins)
        self.min_area_pixels = self._compute_min_area_pixels()
        self.im_memmap = None
        self.frangi_memmap = None
        self.instance_label_memmap = None

    def _compute_min_area_pixels(self):
        """π·r² / (x·y) pixels in 2D, 4/3·π·r³ / (x·y·z) voxels in 3D; at
        least 1."""
        res = self.im_info.dim_res
        x_res = res.get("X") or 1.0
        y_res = res.get("Y") or x_res
        if self.im_info.no_z:
            area_px = np.pi * self.min_radius_um ** 2 / (float(x_res) * float(y_res))
            return max(1, int(np.ceil(area_px)))
        z_res = res.get("Z") or x_res
        vol_px = (4.0 / 3.0) * np.pi * self.min_radius_um ** 3 / (
            float(x_res) * float(y_res) * float(z_res))
        return max(1, int(np.ceil(vol_px)))

    def _get_t(self):
        if self.num_t is None:
            self.num_t = 1 if self.im_info.no_t else self.im_info.shape[self.im_info.axes.index("T")]

    def _allocate_memory(self):
        self.im_memmap = self.im_info.get_memmap(self.im_info.im_path)
        self.frangi_memmap = self.im_info.get_memmap(self.im_info.pipeline_paths["im_preprocessed"])
        self.shape = self.frangi_memmap.shape
        self.instance_label_memmap = self.im_info.allocate_memory(
            self.im_info.pipeline_paths["im_instance_label"],
            dtype="int32", description="instance segmentation", return_memmap=True)

    def _sample_step(self, size):
        return max(int(size) // max(1, self.threshold_sampling_pixels), 1)

    def _compute_frame_thresholds(self, original, frangi):
        """Per-frame intensity and Frangi thresholds from a strided sample."""
        step = self._sample_step(frangi.numel())
        frangi_sample = frangi.reshape(-1)[::step]
        orig_sample = None
        intensity_thresh = None
        if self.otsu_thresh_intensity or self.threshold is not None:
            orig_sample = original.reshape(-1)[::step].float()
        if self.otsu_thresh_intensity:
            thr, ok = _intensity_otsu_kernel(orig_sample, self.histogram_nbins, 1)
            intensity_thresh = float(thr) if ok else 0.0
        elif self.threshold is not None:
            intensity_thresh = float(self.threshold)
        gate = orig_sample if intensity_thresh is not None else None
        thr, ok = _frangi_threshold_kernel(
            frangi_sample, gate, 0.0 if intensity_thresh is None else intensity_thresh,
            self.histogram_nbins, 1)
        return intensity_thresh, (float(thr) if ok else None)

    def _run_frame_full_volume(self, t, original, frangi, intensity_thresh, frangi_thresh):
        logger.info(f"Running semantic segmentation, volume {t}/{self.num_t - 1}")
        if frangi_thresh is None:
            return torch.zeros(frangi.shape, dtype=torch.int32, device=frangi.device)
        use_intensity = intensity_thresh is not None
        return _label_frame_kernel(
            frangi, original, intensity_thresh if use_intensity else 0.0,
            frangi_thresh, self.min_area_pixels, not self.im_info.no_z, use_intensity)

    def _run_segmentation(self):
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Extracting organelles. Frame: {t + 1} of {self.num_t}."
            original = _frames.load(self.im_memmap, t, self.device)
            frangi = _frames.load(self.frangi_memmap, t, self.device)
            intensity_thresh, frangi_thresh = self._compute_frame_thresholds(original, frangi)
            labels = self._run_frame_full_volume(t, original, frangi,
                                                 intensity_thresh, frangi_thresh)
            _frames.store(self.instance_label_memmap, t, labels, np.int32)

    def run(self):
        logger.info("Running semantic segmentation.")
        self._get_t()
        self._allocate_memory()
        self._run_segmentation()
