"""Multi-scale Frangi vesselness of one 2D or 3D frame.

Port of ``nellie_tpu/kernels/frangi.py``: per scale an incremental
Gaussian (Δσ cascade), γ from min(triangle, Otsu) of the positive smoothed
voxels, the Hessian and its normalised Frobenius norm, the Frobenius mask,
closed-form eigenvalues, the Frangi response and a running maximum.  Then
``finalize_frame`` (1st-percentile mask and binary opening) and
``remove_edges_frame``.  2D frames add the multi-scale LoG blobness
(``log_blobness_2d``).

``carry_dtype="float16"`` stores the cascade's carries as float16, as the
reference's program does: the frame divided by its largest |value|, each
smoothing pass's output and the vesselness accumulator are rounded to
float16 (the converts of its optimised HLO), and all arithmetic stays
float32.  A user-set ``frob_thresh`` needs no rescaling there: the
Frobenius norm is divided by the largest |Hessian component|, so it does
not change when the frame is scaled.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from nellie_tpu_torch.kernels import eigen, filters, thresholds
from nellie_tpu_torch.kernels._fp import exp, f32, fma, sqrt, sum_of_products
from nellie_tpu_torch.kernels.hessian import (
    hessian_unnormalized,
    largest_component,
    nonzero_or_one,
)

EPS32 = float(np.finfo(np.float32).eps)
CARRY_DTYPES = {"float32": torch.float32, "float16": torch.float16}


@dataclass(frozen=True)
class FrangiParams:
    """Configuration of the vesselness filter; field for field the
    reference's ``FrangiParams``."""

    sigmas: Tuple[float, ...]
    spacing: Tuple[float, ...]
    z_ratio: float = 1.0
    alpha_sq: float = 0.5
    beta_sq: float = 0.5
    frob_thresh: Optional[float] = None
    frob_thresh_division: float = 2.0
    max_threshold_samples: int = int(1e6)
    truncate: float = 3.0
    carry_dtype: str = "float32"

    def __post_init__(self):
        if self.carry_dtype not in CARRY_DTYPES:
            raise ValueError(f"carry_dtype={self.carry_dtype!r}: use one of "
                             f"{sorted(CARRY_DTYPES)}")

    def sigma_vec(self, sigma: float) -> Tuple[float, ...]:
        if len(self.spacing) == 2:
            return (float(sigma), float(sigma))
        return (float(sigma) / self.z_ratio, float(sigma), float(sigma))


def _stride_masked_positive(volume: torch.Tensor, max_samples: int) -> torch.Tensor:
    strides = thresholds.sample_strides(tuple(volume.shape), max_samples)
    return thresholds.stride_mask(tuple(volume.shape), strides, volume.device) & (volume > 0)


class WholeFrame:
    """The frame-wide reductions of the cascade when the frame is held
    whole (one block, the frame itself).  :mod:`nellie_tpu_torch.mesh.sharded`
    has the same three methods over the cores of a frame's shards; the
    cascade reads nothing else of the whole frame."""

    minor_extent = None  # the Hessian's width rule reads the block's own

    @staticmethod
    def core(index: int, block: torch.Tensor) -> torch.Tensor:
        return block

    @staticmethod
    def all_max(values):
        return values

    @staticmethod
    def triangle_otsu(blocks, max_samples: int):
        """min(triangle, Otsu) of the strided positive voxels, one per
        block, or None when no sampled voxel is positive."""
        pos = _stride_masked_positive(blocks[0], max_samples)
        if not bool(pos.any()):
            return None
        return [thresholds.min_triangle_otsu(blocks[0], pos)]


def _gammas(gauss, max_samples: int, stats):
    thr = stats.triangle_otsu(gauss, max_samples)
    if thr is None:
        return [torch.tensor(EPS32, device=g.device) for g in gauss]
    return [torch.clamp(t, min=EPS32) for t in thr]


def _frob_masks(frobs, params: FrangiParams, stats):
    if not params.frob_thresh_division:
        return [frob > 0 for frob in frobs]
    if params.frob_thresh is not None:
        thr = [torch.tensor(f32(params.frob_thresh), device=f.device) for f in frobs]
    else:
        thr = stats.triangle_otsu(frobs, params.max_threshold_samples)
        if thr is None:
            thr = [torch.zeros((), device=f.device) for f in frobs]
    scale = f32(1.0 / params.frob_thresh_division)
    return [frob > (t * scale) for frob, t in zip(frobs, thr)]


def _frangi_response(eigs, gamma_sq, params: FrangiParams) -> torch.Tensor:
    """Frangi vesselness from |λ|-sorted eigenvalues; like the reference, the
    3D ratio numerators both use |λ2|.  XLA's exp and correctly rounded
    square root (:mod:`_fp`), so that the response is the reference's bit
    for bit in 2D and 3D."""
    if len(eigs) == 2:
        l1, l2 = eigs
        rb = l1.abs() / (l2.abs() + f32(1e-12))
        s_sq = fma(l1, l1, l2 * l2)
        v = exp(-(rb * rb * f32(1.0 / params.beta_sq))) * (1.0 - exp(-(s_sq / gamma_sq)))
        v = torch.where(l2 > 0, torch.zeros_like(v), v)
        return torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
    l1, l2, l3 = eigs
    a2 = l2.abs()
    ra = a2 / (l3.abs() + f32(1e-12))
    rb = a2 / (sqrt((l2 * l3).abs()) + f32(1e-12))
    ra_sq = ra * ra
    rb_sq = rb * rb
    s_sq = sum_of_products([(l1, l1), (l2, l2), (l3, l3)])
    v = ((1.0 - exp(-(ra_sq * f32(1.0 / params.alpha_sq))))
         * exp(-(rb_sq * f32(1.0 / params.beta_sq)))
         * (1.0 - exp(-(s_sq / gamma_sq))))
    v = torch.where((l3 > 0) | (l2 > 0), torch.zeros_like(v), v)
    return torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)


def _delta_kernels(params: FrangiParams, ndim: int):
    """Per-scale incremental Gaussian taps, zero-padded to one length per
    axis: a list (one per axis) of (n_scales, taps) float32 arrays."""
    deltas = []
    prev = 0.0
    for sigma in params.sigmas:
        vp = params.sigma_vec(prev)
        vc = params.sigma_vec(sigma)
        deltas.append(tuple(
            float(np.sqrt(max(0.0, c * c - p * p))) for p, c in zip(vp, vc)))
        prev = sigma
    taps = []
    for axis in range(ndim):
        r_max = max(int(params.truncate * d[axis] + 0.5) for d in deltas)
        t = 2 * r_max + 1
        taps.append(np.stack([
            filters.gaussian_kernel1d_padded(d[axis], t, params.truncate) for d in deltas
        ]).astype(np.float32))
    return taps


def vesselness_frame(frame: torch.Tensor, params: FrangiParams, apply_mask: bool = True):
    """(vesselness * accumulated mask, accumulated mask) of one 2D or 3D
    frame."""
    (vessel,), (mask,) = vesselness_blocks([frame], params, apply_mask, WholeFrame())
    return vessel, mask


def vesselness_blocks(blocks, params: FrangiParams, apply_mask: bool, stats):
    """:func:`vesselness_frame` of a frame given as blocks, each on its own
    device: every per-voxel step runs block by block, and the frame-wide
    reductions (the float16 carry's scale, γ, the Hessian's largest
    component, the Frobenius threshold) come from ``stats``
    (:class:`WholeFrame` or a mesh's shard statistics).  Returns the lists
    of vesselness and mask blocks."""
    frames = [b.float() for b in blocks]
    carry = CARRY_DTYPES[params.carry_dtype]
    if carry != torch.float32:
        # the response does not change under a uniform rescale; this keeps
        # the carried magnitudes inside float16's range
        scale = stats.all_max([stats.core(b, f).abs().max() for b, f in enumerate(frames)])
        frames = [f / torch.clamp(m, min=EPS32) for f, m in zip(frames, scale)]
    ndim = frames[0].ndim
    kernel_stacks = _delta_kernels(params, ndim)
    gauss = [f.to(carry) for f in frames]
    vessel = [torch.zeros(f.shape, dtype=carry, device=f.device) for f in frames]
    all_mask = [torch.ones(f.shape, dtype=torch.bool, device=f.device) for f in frames]
    for i in range(len(params.sigmas)):
        for b, g in enumerate(gauss):
            for axis in range(ndim):
                g = filters.correlate1d_traced(g.float(), kernel_stacks[axis][i], axis).to(carry)
            gauss[b] = g.float()
        gamma_sq = [2.0 * g * g for g in _gammas(gauss, params.max_threshold_samples, stats)]
        hf = [hessian_unnormalized(g, params.spacing, stats.minor_extent) for g in gauss]
        largest = stats.all_max([
            largest_component({k: stats.core(b, v) for k, v in h.items()})
            for b, (h, _) in enumerate(hf)])
        frobs = [frob / nonzero_or_one(m) for (_, frob), m in zip(hf, largest)]
        h_masks = (_frob_masks(frobs, params, stats) if apply_mask
                   else [torch.ones_like(m) for m in all_mask])
        for b, (h, _) in enumerate(hf):
            if ndim == 2:
                eigs = eigen.eigvalsh2(h["hxx"], h["hxy"], h["hyy"])
            else:
                eigs = eigen.eigvalsh3(h["hxx"], h["hxy"], h["hxz"], h["hyy"], h["hyz"],
                                       h["hzz"])
            v = _frangi_response(eigs, gamma_sq[b], params)
            v = torch.where(h_masks[b], v, torch.zeros_like(v))
            vessel[b] = torch.maximum(vessel[b], v.to(carry))
            all_mask[b] = all_mask[b] & h_masks[b]
    return [v.float() * m for v, m in zip(vessel, all_mask)], all_mask


def log_blobness_2d(frame: torch.Tensor, mask: torch.Tensor, params: FrangiParams) -> torch.Tensor:
    """Multi-scale LoG "blobness" of a 2D frame inside ``mask``, the
    maximum over scales, clipped at 0 and normalised to [0, 0.1]."""
    lap = log_blob_response(frame, mask, params)
    return normalize_blobness(lap, lap.max())


def log_blob_response(frame: torch.Tensor, mask: torch.Tensor, params: FrangiParams):
    """The blobness before its normalisation by the frame's maximum."""
    frame = frame.float()
    lap = None
    for sigma in params.sigmas:
        cur = -filters.gaussian_laplace(frame, params.sigma_vec(sigma)) * f32(float(sigma) ** 2)
        cur = cur * mask
        lap = cur if lap is None else torch.maximum(lap, cur)
    return torch.clamp(lap, min=0.0)


def normalize_blobness(lap: torch.Tensor, lap_max: torch.Tensor) -> torch.Tensor:
    return lap / (lap_max + f32(1e-12)) * f32(0.1)


def blob_radius(params: FrangiParams, axis: int) -> int:
    """Receptive radius of :func:`log_blob_response` along ``axis``."""
    return max(int(4.0 * params.sigma_vec(s)[axis] + 0.5) for s in params.sigmas)


def cascade_radius(params: FrangiParams, ndim: int, axis: int) -> int:
    """Receptive radius of :func:`vesselness_frame` along ``axis``: one
    padded tap radius per scale, and 2 for the Hessian's second
    differences."""
    taps = _delta_kernels(params, ndim)[axis].shape[1]
    return len(params.sigmas) * (taps // 2) + 2


def masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile (linear interpolation) of values[mask]."""
    flat = values.reshape(-1).float()
    m = mask.reshape(-1)
    n_valid = int(m.sum())
    if n_valid == 0:
        return torch.zeros((), device=flat.device)
    s = torch.sort(torch.where(m, flat, torch.full_like(flat, float("inf")))).values
    pos = torch.tensor(f32(q / 100.0), device=flat.device) * float(max(n_valid - 1, 0))
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.float()
    return fma(s[lo], 1.0 - frac, s[hi] * frac)


def mask_volume(frangi_frame: torch.Tensor, max_samples: int = int(1e6)) -> torch.Tensor:
    """1st-percentile threshold of the positive sample + binary opening."""
    strides = thresholds.sample_strides(tuple(frangi_frame.shape), max_samples)
    sample = thresholds.downsample(frangi_frame, strides)
    pos = sample > 0
    if not bool(pos.any()):
        return frangi_frame
    thr = masked_percentile(sample, pos, 1.0)
    mask = filters.binary_opening(frangi_frame > thr)
    return frangi_frame * mask


def finalize_frame(frangi_frame: torch.Tensor, max_samples: int = int(1e6)) -> torch.Tensor:
    """Percentile-mask refinement, applied only when the frame has signal."""
    if not bool(frangi_frame.sum() > 0):
        return frangi_frame
    return mask_volume(frangi_frame, max_samples)


def remove_edges_frame(frangi_frame: torch.Tensor) -> torch.Tensor:
    """Zero a 15-row margin at the top and bottom of each Z-slice's (or the
    2D frame's) nonzero bounding box."""
    x = frangi_frame[None] if frangi_frame.ndim == 2 else frangi_frame
    kill = edge_rows((x != 0).any(dim=2))
    out = torch.where(kill[:, :, None], torch.zeros_like(x), x)
    return out[0] if frangi_frame.ndim == 2 else out


def edge_rows(rows_any: torch.Tensor) -> torch.Tensor:
    """(Z, Y) rows that :func:`remove_edges_frame` zeroes, from the (Z, Y)
    table of rows holding a nonzero voxel."""
    ny = rows_any.shape[1]
    row_idx = torch.arange(ny, device=rows_any.device)[None, :]
    has_any = rows_any.any(dim=1, keepdim=True)
    rmin = torch.where(rows_any, row_idx, ny).min(dim=1, keepdim=True).values
    rmax = torch.where(rows_any, row_idx, -1).max(dim=1, keepdim=True).values
    height = torch.clamp(rmax - rmin + 1, min=0)
    margin = torch.clamp(height, max=15)
    return (((row_idx >= rmin) & (row_idx < rmin + margin))
            | ((row_idx > rmax - margin) & (row_idx <= rmax))) & has_any
