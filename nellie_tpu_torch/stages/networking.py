"""Stage 3 — Network: skeleton, pixel classes and branch labels.

Port of ``nellie_tpu/stages/networking.py``: ``_run_frame_device``
(``:202``) with the kernels at ``:51-134`` — thinning (the LUT in 3D,
Zhang–Suen in 2D), removal of skeleton voxels whose 3^d neighbourhood spans
two labels, a skeleton voxel for every label that lost its skeleton (the
raster-first Frangi argmax), the 3^d occupancy class (0 background, 1 isolated, 2 tip, 3 edge,
4 junction), branch labels as components of the non-junction skeleton, and
their propagation to whole objects by object-constrained nearest seed.
Writes ``im_skel`` (int32), ``im_pixel_class`` (uint8) and
``im_skel_relabelled`` (uint32).

``low_memory`` and ``max_chunk_voxels`` are accepted and change nothing,
as in the reference.

Not ported: the foreground-sparse pull bundles.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import ccl, edt
from nellie_tpu_torch.kernels.filters import maximum_filter, minimum_filter, sum_filter
from nellie_tpu_torch.kernels.skeleton import simple26_lut, skeletonize
from nellie_tpu_torch.stages import _frames
from nellie_tpu_torch.utils import adaptive_run

_INT32_MAX = int(np.iinfo(np.int32).max)


def _clean_skeleton_kernel(skel_labels: torch.Tensor) -> torch.Tensor:
    """Zero skeleton voxels whose 3^3 neighbourhood spans more than one
    instance label, keeping voxels on the volume boundary."""
    mask = skel_labels > 0
    max_labels = maximum_filter(skel_labels, 3, mode="constant", cval=0)
    bg_val = skel_labels.max() + 1
    no_bg = torch.where(skel_labels == 0, bg_val, skel_labels)
    min_labels = minimum_filter(no_bg, 3, mode="constant", cval=_INT32_MAX)
    min_labels = torch.where(min_labels == bg_val, 0, min_labels)
    ambiguous = mask & (min_labels > 0) & (max_labels > 0) & (min_labels != max_labels)
    boundary = torch.zeros(skel_labels.shape, dtype=torch.bool, device=skel_labels.device)
    for axis in range(skel_labels.ndim):
        boundary.narrow(axis, 0, 1).fill_(True)
        boundary.narrow(axis, skel_labels.shape[axis] - 1, 1).fill_(True)
    return torch.where(ambiguous & ~boundary, 0, skel_labels)


def _add_missing_skeleton_kernel(skel_labels, instance_labels, frangi):
    """Every instance label without a skeleton voxel gets one at the
    raster-first argmax of the Frangi image inside the label."""
    n = instance_labels.numel()
    lbl = instance_labels.reshape(-1).long()
    skel = skel_labels.reshape(-1)
    fr = frangi.reshape(-1).float()
    fg = lbl > 0
    sentinel = 3.0e38
    val = torch.where(skel > 0, sentinel, torch.where(fg, fr, -float("inf")))
    tgt = torch.where(fg | (skel > 0), lbl, n)
    seg_max = torch.full((n + 1,), -float("inf"), device=fr.device)
    seg_max = seg_max.scatter_reduce(0, tgt, val, reduce="amax", include_self=True)
    per_vox = seg_max[lbl]
    is_best = fg & (per_vox < sentinel) & (fr == per_vox)
    idx = torch.arange(n, device=fr.device)
    seg_first = torch.full((n + 1,), n, dtype=torch.long, device=fr.device)
    seg_first = seg_first.scatter_reduce(
        0, torch.where(is_best, lbl, n), torch.where(is_best, idx, n),
        reduce="amin", include_self=True)
    chosen = is_best & (idx == seg_first[lbl])
    out = torch.where(chosen, lbl.to(skel.dtype), skel)
    return out.reshape(skel_labels.shape)


def _pixel_class_kernel(skel: torch.Tensor) -> torch.Tensor:
    m = (skel > 0).to(torch.int32)
    return torch.clamp(sum_filter(m, 3) * m, max=4).to(torch.uint8)


def _branch_skel_labels_kernel(pixel_class: torch.Tensor) -> torch.Tensor:
    labels, _ = ccl.label((pixel_class > 0) & (pixel_class != 4))
    return labels


def _relabel_objects_kernel(branch_skel_labels, instance_labels, sampling):
    """Branch labels propagated to every voxel of their object."""
    seeds = torch.where(instance_labels > 0, branch_skel_labels, 0).to(torch.int32)
    labels, _ = edt.nearest_seed(seeds, instance_labels.to(torch.int32), sampling)
    return torch.where(instance_labels > 0, labels, 0)


class Network:
    """Skeleton / pixel-class / branch-label extraction."""

    def __init__(self, im_info: ImInfo, num_t=None, min_radius_um=0.20,
                 max_radius_um=1, viewer=None, device="cuda", low_memory: bool = False,
                 max_chunk_voxels: int = int(1e6)):
        self.im_info = im_info
        self.device = resolve_device(device)
        # accepted as the reference accepts them: Network has no windowed
        # path, so neither changes what runs (networking.py:147-152)
        self.low_memory = bool(low_memory)
        self.max_chunk_voxels = int(max_chunk_voxels)
        self.num_t = num_t
        if num_t is None and not im_info.no_t:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        res = im_info.dim_res
        self.min_radius_um = max(min_radius_um, res["X"])
        self.max_radius_um = max_radius_um
        self.min_radius_px = self.min_radius_um / res["X"]
        self.max_radius_px = self.max_radius_um / res["X"]
        self.scaling = ((res["Y"], res["X"]) if im_info.no_z
                        else (res["Z"], res["Y"], res["X"]))
        self.viewer = viewer
        self._luts = {}  # the 3D thinning table, per device

    def _get_t(self):
        if self.num_t is None:
            self.num_t = 1 if self.im_info.no_t else self.im_info.shape[self.im_info.axes.index("T")]

    def _allocate_memory(self):
        info = self.im_info
        self.label_memmap = info.get_memmap(info.pipeline_paths["im_instance_label"])
        self.im_frangi_memmap = info.get_memmap(info.pipeline_paths["im_preprocessed"])
        self.shape = self.label_memmap.shape
        self.skel_memmap = info.allocate_memory(
            info.pipeline_paths["im_skel"], dtype="int32",
            description="skeleton image", return_memmap=True)
        self.pixel_class_memmap = info.allocate_memory(
            info.pipeline_paths["im_pixel_class"], dtype="uint8",
            description="pixel class image", return_memmap=True)
        self.skel_relabelled_memmap = info.allocate_memory(
            info.pipeline_paths["im_skel_relabelled"], dtype="uint32",
            description="skeleton relabelled image", return_memmap=True)

    def _run_frame_device(self, t):
        logger.info(f"Running network analysis, volume {t}/{self.num_t - 1}")
        return self._frame(_frames.load(self.label_memmap, t, self.device, np.int32),
                           _frames.load(self.im_frangi_memmap, t, self.device))

    def _frame(self, label_frame, frangi_frame):
        """(skeleton labels on branch-labelled voxels, pixel class, branch
        labels of whole objects) of one frame's int32 labels and float32
        vesselness on the device (any device: a mesh runs frames on several)."""
        lut = None
        if not self.im_info.no_z:
            dev = label_frame.device
            lut = self._luts.get(dev)
            if lut is None:
                lut = self._luts[dev] = simple26_lut(dev)
        skel_mask = skeletonize(label_frame > 0, lut)
        skel = torch.where(skel_mask, label_frame, 0)
        skel = _clean_skeleton_kernel(skel)
        skel = _add_missing_skeleton_kernel(skel, label_frame, frangi_frame)
        skel = torch.where(skel > 0, label_frame, 0)

        pixel_class = _pixel_class_kernel(skel)
        branch_skel_labels = _branch_skel_labels_kernel(pixel_class)
        branch_labels = _relabel_objects_kernel(branch_skel_labels, label_frame, self.scaling)
        return torch.where(skel > 0, branch_skel_labels, 0), pixel_class, branch_labels

    def _run_networking(self):
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Extracting branches. Frame: {t + 1} of {self.num_t}."
            self._write_frame(t, *self._run_frame_device(t))

    def _write_frame(self, t, skel, pixel_class, branch):
        _frames.store(self.skel_memmap, t, skel, np.int32)
        _frames.store(self.pixel_class_memmap, t, pixel_class, np.uint8)
        _frames.store(self.skel_relabelled_memmap, t, branch, np.uint32)

    def run(self):
        def attempt(dev, low):
            self.low_memory = low
            self._get_t()
            self._allocate_memory()
            self._run_networking()

        adaptive_run.run_with_ladder("Network", self.device, self.low_memory, self.im_info, attempt)
