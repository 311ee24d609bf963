"""Stage 2 — Label: threshold + connected-component instance segmentation.

Port of ``nellie_tpu/stages/labelling.py``: the full-volume path
(``_run_frame_full_volume``) with the kernels at ``:49-92`` —
log10-domain min(triangle, Otsu) Frangi threshold (optionally gated by an
intensity Otsu or fixed threshold), hole filling (3D only), the
small-component filter, a 3^d box-mean smoothing and scipy-numbered
labelling — and the chunked-Z path (``:272-361``), which runs whenever
``chunk_z`` is set or low-memory mode infers one: each Z slab is labelled
on its own (its own hole filling and area filter, the last slab padded
with zeros to the slab depth), the slabs' labels are offset to be unique,
merged across slab faces with a union-find, and renumbered in the order
first seen.  The thresholds are taken per frame from a strided sample of
the whole frame.  Writes the int32 ``im_instance_label`` artifact.

With ``mesh`` (and neither ``chunk_z`` nor low-memory mode) frames run in
groups of the mesh's t extent, each split over its t row's z group, the
thresholds still taken per frame from the host sample
(``_run_segmentation_batched``, ``labelling.py:365-415``); the labels are
the single-device ones exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.kernels import thresholds as thr_k
from nellie_tpu_torch.kernels._fp import f32, log10, pow as xla_pow
from nellie_tpu_torch.kernels.filters import uniform_filter
from nellie_tpu_torch.utils import adaptive_run


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
    tri, ots = thr_k.triangle_and_otsu(logv, valid, nbins)
    # the reference's 10.0 ** t is glibc's powf, as XLA's CPU code calls it;
    # torch.pow is not, on the card (CUDA's powf) or on whole CPU tensors
    ten = torch.tensor(10.0, device=frangi_flat.device)
    return torch.minimum(xla_pow(ten, tri), xla_pow(ten, ots)), bool(valid.any())


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
    """Instance segmentation of organelles from the Frangi image.

    ``chunk_z``: label each frame in Z slabs of this depth and merge them
    (3D only).  ``low_memory``: without ``chunk_z``, slabs of
    ``max_chunk_voxels // (Y * X)`` planes."""

    def __init__(self, im_info: ImInfo,
                 num_t=None,
                 threshold=None,
                 otsu_thresh_intensity=False,
                 viewer=None,
                 chunk_z=None,
                 min_radius_um=0.25,
                 threshold_sampling_pixels=1_000_000,
                 histogram_nbins=256,
                 device="cuda",
                 low_memory: bool = False,
                 max_chunk_voxels: int = int(1e6),
                 mesh=None):
        self.im_info = im_info
        self.mesh = mesh
        # with a mesh, the stage's own device is the mesh's first
        self.device = resolve_device(device) if mesh is None else mesh.flat()[0]
        self.num_t = num_t
        if num_t is None and not im_info.no_t:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        self.threshold = threshold
        self.otsu_thresh_intensity = otsu_thresh_intensity
        self.viewer = viewer
        self.chunk_z = chunk_z if (not im_info.no_z and chunk_z is not None) else None
        self._user_chunk_z = self.chunk_z
        x_res = im_info.dim_res.get("X") or 1.0
        self.min_radius_um = max(float(min_radius_um), float(x_res))
        self.threshold_sampling_pixels = int(threshold_sampling_pixels)
        self.histogram_nbins = int(histogram_nbins)
        self.low_memory = bool(low_memory)
        self.max_chunk_voxels = int(max_chunk_voxels)
        if self.low_memory and self.chunk_z is None and not im_info.no_z:
            self.chunk_z = self._infer_chunk_z()
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

    def _infer_chunk_z(self):
        """Planes per slab for low-memory mode: ``max_chunk_voxels // (Y*X)``,
        at least 1 (None without a budget or a Z axis)."""
        if self.max_chunk_voxels is None or self.max_chunk_voxels <= 0:
            return None
        axes = [ax for ax in self.im_info.axes if ax != "T"]
        shape = [d for ax, d in zip(self.im_info.axes, self.im_info.shape) if ax != "T"]
        if "Z" not in axes:
            return None
        y_dim = int(shape[axes.index("Y")])
        x_dim = int(shape[axes.index("X")])
        if y_dim <= 0 or x_dim <= 0:
            return None
        return max(1, int(self.max_chunk_voxels // (y_dim * x_dim)))

    def _set_low_memory(self, low_memory):
        self.low_memory = bool(low_memory)
        if self.im_info.no_z:
            self.chunk_z = None
        elif self._user_chunk_z is not None:
            self.chunk_z = self._user_chunk_z
        else:
            self.chunk_z = self._infer_chunk_z() if self.low_memory else None

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

    def _compute_frame_thresholds(self, original_view, frangi_view):
        """Per-frame intensity and Frangi thresholds from a strided sample,
        taken on the host so that only the sample goes to the device."""
        step = self._sample_step(int(np.prod(frangi_view.shape)))

        def sample(view):
            flat = np.asarray(view).reshape(-1)[::step]
            return torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(self.device)

        frangi_sample = sample(frangi_view)
        orig_sample = None
        intensity_thresh = None
        if self.otsu_thresh_intensity or self.threshold is not None:
            orig_sample = sample(original_view)
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

    def _label_volume(self, original, frangi, intensity_thresh, frangi_thresh, fill):
        """int32 labels (host) of one volume given as host arrays."""
        if frangi_thresh is None:
            return np.zeros(frangi.shape, np.int32)
        use_intensity = intensity_thresh is not None

        def put(arr):
            return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(self.device)

        labels = _label_frame_kernel(
            put(frangi), put(original), intensity_thresh if use_intensity else 0.0,
            frangi_thresh, self.min_area_pixels, fill, use_intensity)
        return labels.cpu().numpy()

    def _run_frame_full_volume(self, t, original_view, frangi_view, intensity_thresh,
                               frangi_thresh):
        logger.info(f"Running semantic segmentation, volume {t}/{self.num_t - 1}")
        return self._label_volume(original_view, frangi_view, intensity_thresh, frangi_thresh,
                                  fill=not self.im_info.no_z)

    def _run_frame_chunked_z(self, t, original_view, frangi_view, intensity_thresh,
                             frangi_thresh):
        """Z slabs labelled one by one, unique by offset, merged across slab
        faces and renumbered (``labelling.py:272-361``)."""
        logger.info(f"Running semantic segmentation in Z-chunks, volume {t}/{self.num_t - 1}")
        z_dim = frangi_view.shape[0]
        chunk = max(1, min(int(self.chunk_z or z_dim), z_dim))
        offset = 0
        parent = {}
        prev_boundary = None
        had_merges = False
        for z_start in range(0, z_dim, chunk):
            z_end = min(z_start + chunk, z_dim)
            ov = np.asarray(original_view[z_start:z_end])
            fv = np.asarray(frangi_view[z_start:z_end])
            if z_end - z_start < chunk:
                # the last slab is padded with zeros to the slab depth: the
                # zero planes are background to hole filling and the area
                # filter, like the volume's border
                pad = [(0, chunk - (z_end - z_start))] + [(0, 0)] * (ov.ndim - 1)
                ov, fv = np.pad(ov, pad), np.pad(fv, pad)
            labels_chunk = self._label_volume(ov, fv, intensity_thresh, frangi_thresh,
                                              fill=True)[:z_end - z_start]
            max_label = int(labels_chunk.max())
            if max_label > 0:
                labels_chunk[labels_chunk > 0] += offset
                offset += max_label
            if prev_boundary is not None:
                curr_boundary = labels_chunk[0]
                both = (prev_boundary > 0) & (curr_boundary > 0)
                if both.any():
                    pairs = np.unique(np.stack([prev_boundary[both], curr_boundary[both]], 1),
                                      axis=0)
                    for a, b in pairs:
                        had_merges |= _uf_union(parent, int(a), int(b))
            prev_boundary = labels_chunk[-1].copy()
            self.instance_label_memmap[t, z_start:z_end, ...] = labels_chunk
        if had_merges:
            self._relabel_frame_from_unions(t, z_dim, chunk, parent)

    def _relabel_frame_from_unions(self, t, z_dim, chunk_z, parent):
        """Every label to its union-find root, the roots numbered 1, 2, ...
        in the order first seen (slab by slab, ascending within a slab)."""
        label_map = {0: 0}
        next_label = 1
        for z_start in range(0, z_dim, chunk_z):
            z_end = min(z_start + chunk_z, z_dim)
            labels_chunk = np.asarray(self.instance_label_memmap[t, z_start:z_end, ...])
            unique = np.unique(labels_chunk)
            if unique.size == 1 and unique[0] == 0:
                continue
            roots = [_uf_find(parent, int(lab)) for lab in unique]
            for root in roots:
                if root != 0 and root not in label_map:
                    label_map[root] = next_label
                    next_label += 1
            new_ids = np.array([label_map[r] for r in roots], labels_chunk.dtype)
            self.instance_label_memmap[t, z_start:z_end, ...] = new_ids[
                np.searchsorted(unique, labels_chunk)]

    def _run_segmentation_batched(self, tb):
        """Groups of ``tb`` frames over the mesh's t rows, each frame split
        over its row's z group."""
        from nellie_tpu_torch.mesh.sharded import batched_label_kernel

        use_intensity = self.otsu_thresh_intensity or self.threshold is not None
        fill = not self.im_info.no_z
        for start in range(0, self.num_t, tb):
            ts = list(range(start, min(start + tb, self.num_t)))
            if self.viewer is not None:
                self.viewer.status = (f"Extracting organelles. Frames: {ts[0] + 1}-{ts[-1] + 1} "
                                      f"of {self.num_t}.")
            it_b, ft_b, valid_b = [], [], []
            for t in ts:
                it, ft = self._compute_frame_thresholds(self.im_memmap[t, ...],
                                                        self.frangi_memmap[t, ...])
                it_b.append(0.0 if it is None else it)
                ft_b.append(ft)
                valid_b.append(ft is not None)
            labels = batched_label_kernel(
                [np.asarray(self.frangi_memmap[t]) for t in ts],
                [np.asarray(self.im_memmap[t]) for t in ts], it_b, ft_b, valid_b,
                self.min_area_pixels, fill, use_intensity, self.mesh)
            for t, lab in zip(ts, labels):
                self._write_frame(t, lab.cpu().numpy())

    def _run_segmentation(self):
        if self.mesh is not None and not self.low_memory and self.chunk_z is None:
            tb = int(self.mesh.shape.get("t", 1)) if self.num_t > 1 else 1
            return self._run_segmentation_batched(tb)
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Extracting organelles. Frame: {t + 1} of {self.num_t}."
            original_view = self.im_memmap[t, ...]
            frangi_view = self.frangi_memmap[t, ...]
            intensity_thresh, frangi_thresh = self._compute_frame_thresholds(
                original_view, frangi_view)
            if self.chunk_z is not None and not self.im_info.no_z:
                self._run_frame_chunked_z(t, original_view, frangi_view,
                                          intensity_thresh, frangi_thresh)
                self.instance_label_memmap.flush()
            else:
                self._write_frame(t, self._run_frame_full_volume(
                    t, original_view, frangi_view, intensity_thresh, frangi_thresh))

    def _write_frame(self, t, labels):
        self.instance_label_memmap[t, ...] = labels
        self.instance_label_memmap.flush()

    def run(self):
        logger.info("Running semantic segmentation.")

        def attempt(dev, low):
            self._set_low_memory(low)
            self._get_t()
            self._allocate_memory()
            self._run_segmentation()

        adaptive_run.run_with_ladder("Label", self.device, self.low_memory, self.im_info, attempt)


def _uf_find(parent, x):
    root = x
    while parent.get(root, root) != root:
        root = parent[root]
    while parent.get(x, x) != root:  # path compression
        parent[x], x = root, parent[x]
    return root


def _uf_union(parent, a, b):
    """Join the sets of ``a`` and ``b`` under the smaller root; True if
    they were apart."""
    ra, rb = _uf_find(parent, a), _uf_find(parent, b)
    if ra == rb:
        return False
    parent[max(ra, rb)] = min(ra, rb)
    return True
