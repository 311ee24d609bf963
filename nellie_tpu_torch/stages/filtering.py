"""Stage 1 — Filter: multi-scale Frangi vesselness preprocessing.

Port of ``nellie_tpu/stages/filtering.py``, whole-frame path
(``_run_frame`` and ``_run_filter``): one ``vesselness_frame`` call per
timepoint, then ``finalize_frame`` and optionally ``remove_edges_frame``.
Writes the float32 ``im_preprocessed`` artifact.

Not ported: the low-memory chunked path, the mesh-batched path, the
compile warmer, the CPU fallback ladder (``utils/adaptive_run.py``) and the
2D blobness branch.
"""
from __future__ import annotations

import numpy as np

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import frangi as frangi_k
from nellie_tpu_torch.stages import _frames


class Filter:
    """Multi-scale Frangi-style vesselness filter for 3D(+T) data."""

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
        max_threshold_samples: int = int(1e6),
        carry_dtype: str = "float32",
        device="cuda",
    ):
        if im_info.no_z:
            raise NotImplementedError("the port runs 3D data; the 2D branch is not ported yet")
        if carry_dtype != "float32":
            raise NotImplementedError(f"carry_dtype={carry_dtype!r}: the port keeps float32")
        self.im_info = im_info
        self.device = resolve_device(device)
        self.truncate = 3.0
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
        z = res.get("Z") or res.get("X") or 1.0
        return (float(z), float(res.get("Y") or 1.0), float(res.get("X") or 1.0))

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

    def _run_frame(self, t, mask=True):
        logger.info(f"Running Frangi filter on t={t}.")
        frame = _frames.load(self.im_memmap, t, self.device)
        vessel, _ = frangi_k.vesselness_frame(frame, self._params, apply_mask=mask)
        if self.remove_edges:
            vessel = frangi_k.remove_edges_frame(vessel)
        return vessel

    def _run_filter(self, mask=True):
        for t in range(self.num_t):
            if self.viewer is not None:
                self.viewer.status = f"Preprocessing. Frame: {t + 1} of {self.num_t}."
            frame = frangi_k.finalize_frame(self._run_frame(t, mask=mask),
                                            self.max_threshold_samples)
            _frames.store(self.frangi_memmap, t, frame, np.float32)

    def run(self, mask=True):
        logger.info("Running Frangi filter.")
        self._get_t()
        self._allocate_memory()
        self._set_default_sigmas()
        self._run_filter(mask=mask)
