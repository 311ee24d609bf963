"""Stage 1 — Filter: multi-scale Frangi vesselness preprocessing.

Port of ``nellie_tpu/stages/filtering.py``.  The whole-frame path
(``_run_frame`` and ``_run_filter``): one ``vesselness_frame`` call per
timepoint (in 2D its maximum with the LoG blobness), then
``finalize_frame`` and optionally ``remove_edges_frame``.  The low-memory
path (``_run_frame_chunked``, ``:271-320``): halo windows of at most
``max_chunk_voxels`` core voxels, each uploaded from the host, filtered on
the device and written back by its owned box (no blobness in 2D, as in the
reference); the frame stays on the host, where the 1st-percentile mask is
taken in float64 with numpy's linear interpolation (``_finalize_host``,
``:64-81``), and the edge margin removed.  Running out of device memory
there halves the window budget and retries on the same device.  Writes the
float32 ``im_preprocessed`` artifact.

With ``mesh`` (:mod:`nellie_tpu_torch.mesh`) the whole-frame path runs
frames in groups of the mesh's t extent, each frame split over its t row's
z group (``_run_filter_batched``, ``filtering.py:332-400``); the artifact
is the single-device one, bit for bit.  The low-memory path ignores the
mesh, as the reference's does.

Not ported: the compile warmer.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import frangi as frangi_k
from nellie_tpu_torch.kernels import thresholds
from nellie_tpu_torch.kernels.filters import binary_opening
from nellie_tpu_torch.stages import _frames
from nellie_tpu_torch.utils import adaptive_run
from nellie_tpu_torch.utils.chunking import (
    compute_chunk_shape,
    crop_core,
    iter_uniform_windows,
    uniform_window_shapes,
)


def _finalize_host(frangi: np.ndarray, max_samples: int) -> np.ndarray:
    """The 1st-percentile mask and binary opening of a frame kept on the
    host: the percentile of the positive strided sample in float64, with
    numpy's linear interpolation (the device finalize takes it in
    float32)."""
    if frangi.sum() <= 0:
        return frangi
    strides = thresholds.sample_strides(frangi.shape, max_samples)
    sample = frangi[tuple(slice(None, None, s) for s in strides)]
    pos_vals = sample[sample > 0]
    if pos_vals.size == 0:
        return frangi
    thr = np.percentile(pos_vals.astype(np.float64), 1.0)
    mask = binary_opening(torch.from_numpy(frangi > thr)).numpy()
    return frangi * mask


class Filter:
    """Multi-scale Frangi-style vesselness filter for 2D/3D(+T) data."""

    def __init__(
        self,
        im_info: ImInfo,
        num_t=None,
        remove_edges: bool = False,
        min_radius_um: float = 0.25,
        max_radius_um: float = 1.0,
        alpha_sq: float = 0.5,
        beta_sq: float = 0.5,
        frob_thresh=None,
        frob_thresh_division=2,
        viewer=None,
        device="cuda",
        low_memory: bool = False,
        max_chunk_voxels: int = int(1e6),
        max_threshold_samples: int = int(1e6),
        carry_dtype: str = "float32",
        mesh=None,
    ):
        self.im_info = im_info
        self.mesh = mesh
        # with a mesh, the stage's own device is the mesh's first
        self.device = resolve_device(device) if mesh is None else mesh.flat()[0]
        self.truncate = 3.0
        if im_info.no_z:
            self.z_ratio = 1.0
        else:
            z_res = im_info.dim_res.get("Z") or im_info.dim_res.get("X") or 1.0
            x_res = im_info.dim_res.get("X") or 1.0
            self.z_ratio = float(z_res) / float(x_res)
        self.num_t = num_t
        if num_t is None and not im_info.no_t:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        self.remove_edges = remove_edges
        self.min_radius_um = min_radius_um
        self.max_radius_um = max_radius_um
        self.min_radius_px = min_radius_um / im_info.dim_res["X"]
        self.max_radius_px = max_radius_um / im_info.dim_res["X"]
        self.alpha_sq = float(alpha_sq)
        self.beta_sq = float(beta_sq)
        self.frob_thresh = frob_thresh
        self.frob_thresh_division = frob_thresh_division
        self.viewer = viewer
        self.low_memory = bool(low_memory)
        self.max_chunk_voxels = int(max_chunk_voxels)
        self.max_threshold_samples = int(max_threshold_samples)
        self.carry_dtype = str(carry_dtype)
        self.sigmas = None
        self.im_memmap = None
        self.frangi_memmap = None

    def _get_t(self):
        if self.num_t is None:
            self.num_t = 1 if self.im_info.no_t else self.im_info.shape[self.im_info.axes.index("T")]

    def _allocate_memory(self):
        self.im_memmap = self.im_info.get_memmap(self.im_info.im_path)
        self.shape = self.im_memmap.shape
        self.frangi_memmap = self.im_info.allocate_memory(
            self.im_info.pipeline_paths["im_preprocessed"], dtype="float",
            description="frangi filtered im", return_memmap=True)

    def _get_spacing(self):
        res = self.im_info.dim_res
        yx = (float(res.get("Y") or 1.0), float(res.get("X") or 1.0))
        if self.im_info.no_z:
            return yx
        return (float(res.get("Z") or res.get("X") or 1.0),) + yx

    def _set_default_sigmas(self):
        """σ ∈ [min_r/2, max_r/3], at most 5 scales, step ≥ 0.2."""
        min_sigma_step_size = 0.2
        num_sigma = 5
        sigma_1 = self.min_radius_px / 2.0
        sigma_2 = self.max_radius_px / 3.0
        self.sigma_min = min(sigma_1, sigma_2)
        self.sigma_max = max(sigma_1, sigma_2)
        if self.sigma_max <= self.sigma_min:
            self.sigma_max = self.sigma_min + min_sigma_step_size
        step = max(min_sigma_step_size, (self.sigma_max - self.sigma_min) / float(num_sigma))
        self.sigmas = sorted(np.arange(self.sigma_min, self.sigma_max, step, dtype=float).tolist())
        self._params = frangi_k.FrangiParams(
            sigmas=tuple(self.sigmas),
            spacing=self._get_spacing(),
            z_ratio=self.z_ratio,
            alpha_sq=self.alpha_sq,
            beta_sq=self.beta_sq,
            frob_thresh=None if self.frob_thresh is None else float(self.frob_thresh),
            frob_thresh_division=float(self.frob_thresh_division or 0.0),
            max_threshold_samples=self.max_threshold_samples,
            truncate=self.truncate,
            carry_dtype=self.carry_dtype,
        )

    def _halo(self):
        sigma_vec = self._params.sigma_vec(max(self.sigmas))
        return tuple(int(np.ceil(self.truncate * float(s))) for s in sigma_vec)

    def _run_frame_chunked(self, frame_cpu: np.ndarray, mask=True) -> np.ndarray:
        """The frame's vesselness window by window, assembled on the host."""
        shape = frame_cpu.shape
        chunk_voxels = int(self.max_chunk_voxels or int(np.prod(shape)))
        halo = self._halo()
        while True:
            try:
                chunk_shape = compute_chunk_shape(shape, chunk_voxels)
                core_shape, _ = uniform_window_shapes(shape, chunk_shape, halo)
                vessel = np.zeros(shape, np.float32)
                for owned, ext, offset, local in iter_uniform_windows(shape, chunk_shape, halo):
                    window = torch.from_numpy(np.ascontiguousarray(frame_cpu[ext])).to(self.device)
                    v, _ = frangi_k.vesselness_frame(window, self._params, apply_mask=mask)
                    vessel[owned] = crop_core(v, offset, core_shape)[local].cpu().numpy()
                break
            except adaptive_run.OOM_ERRORS:
                if chunk_voxels <= 1:
                    raise
                chunk_voxels = max(1, chunk_voxels // 2)
                logger.warning("Filter: out of memory in a window; retrying with windows of "
                               "%d voxels on %s", chunk_voxels, self.device)
        if self.remove_edges:
            vessel = frangi_k.remove_edges_frame(torch.from_numpy(vessel)).numpy()
        return vessel

    def _run_frame(self, t, mask=True):
        logger.info(f"Running Frangi filter on t={t}.")
        return self._vesselness(_frames.load(self.im_memmap, t, self.device), mask=mask)

    def _vesselness(self, frame, mask=True):
        """Vesselness of one whole frame on the device (in 2D with the LoG
        blobness), before the percentile mask."""
        vessel, masks = frangi_k.vesselness_frame(frame, self._params, apply_mask=mask)
        if self.im_info.no_z:
            blob = frangi_k.log_blobness_2d(frame, masks, self._params)
            vessel = torch.maximum(vessel, torch.clamp(blob, min=0.0))
        if self.remove_edges:
            vessel = frangi_k.remove_edges_frame(vessel)
        return vessel

    def _mesh_t_batch(self):
        """Frames per group on the mesh (its t extent; 1 for one frame)."""
        return int(self.mesh.shape.get("t", 1)) if self.num_t > 1 else 1

    def _run_filter_batched(self, tb, mask=True):
        """Groups of ``tb`` frames, frame i of a group on the mesh's t row
        i, split over the row's z group."""
        from nellie_tpu_torch.mesh.sharded import batched_filter_kernel

        for start in range(0, self.num_t, tb):
            ts = list(range(start, min(start + tb, self.num_t)))
            if self.viewer is not None:
                self.viewer.status = (f"Preprocessing. Frames: {ts[0] + 1}-{ts[-1] + 1} of "
                                      f"{self.num_t}.")
            logger.info(f"Running Frangi filter on t={ts[0]}-{ts[-1]} over the mesh.")
            frames = [np.asarray(self.im_memmap[t]) for t in ts]
            out = batched_filter_kernel(frames, self._params, mask, self.max_threshold_samples,
                                        self.remove_edges, self.mesh)
            for t, frame in zip(ts, out):
                self._write_frame(t, frame)

    def _run_filter(self, mask=True):
        if self.mesh is not None and not self.low_memory:
            return self._run_filter_batched(self._mesh_t_batch(), mask=mask)
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Preprocessing. Frame: {t + 1} of {self.num_t}."
            if self.low_memory:
                logger.info(f"Running Frangi filter on t={t} in windows.")
                frame = _finalize_host(self._run_frame_chunked(
                    np.asarray(self.im_memmap[t]), mask=mask), self.max_threshold_samples)
                self.frangi_memmap[t] = frame
                self.frangi_memmap.flush()
                continue
            self._write_frame(t, frangi_k.finalize_frame(self._run_frame(t, mask=mask),
                                                         self.max_threshold_samples))

    def _write_frame(self, t, frame):
        _frames.store(self.frangi_memmap, t, frame, np.float32)

    def run(self, mask=True):
        logger.info("Running Frangi filter.")

        def attempt(dev, low):
            self.low_memory = low
            self._get_t()
            self._allocate_memory()
            self._set_default_sigmas()
            self._run_filter(mask=mask)

        adaptive_run.run_with_ladder("Filter", self.device, self.low_memory, self.im_info, attempt)
