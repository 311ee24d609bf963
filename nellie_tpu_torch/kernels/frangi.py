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
from nellie_tpu_torch.kernels.hessian import hessian_components

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


def _gamma(gauss: torch.Tensor, max_samples: int) -> torch.Tensor:
    pos = _stride_masked_positive(gauss, max_samples)
    if not bool(pos.any()):
        return torch.tensor(EPS32, device=gauss.device)
    return torch.clamp(thresholds.min_triangle_otsu(gauss, pos), min=EPS32)


def _frob_mask(frob: torch.Tensor, params: FrangiParams) -> torch.Tensor:
    if not params.frob_thresh_division:
        return frob > 0
    if params.frob_thresh is not None:
        threshold = torch.tensor(f32(params.frob_thresh), device=frob.device)
    else:
        pos = _stride_masked_positive(frob, params.max_threshold_samples)
        if bool(pos.any()):
            threshold = thresholds.min_triangle_otsu(frob, pos)
        else:
            threshold = torch.zeros((), device=frob.device)
    return frob > (threshold * f32(1.0 / params.frob_thresh_division))


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
    frame = frame.float()
    carry = CARRY_DTYPES[params.carry_dtype]
    if carry != torch.float32:
        # the response does not change under a uniform rescale; this keeps
        # the carried magnitudes inside float16's range
        frame = frame / torch.clamp(frame.abs().max(), min=EPS32)
    ndim = frame.ndim
    kernel_stacks = _delta_kernels(params, ndim)
    gauss = frame.to(carry)
    vessel = torch.zeros(frame.shape, dtype=carry, device=frame.device)
    all_mask = torch.ones(frame.shape, dtype=torch.bool, device=frame.device)
    for i in range(len(params.sigmas)):
        for axis in range(ndim):
            gauss = filters.correlate1d_traced(gauss.float(), kernel_stacks[axis][i],
                                               axis).to(carry)
        gauss = gauss.float()
        gamma = _gamma(gauss, params.max_threshold_samples)
        gamma_sq = 2.0 * gamma * gamma

        h, frob = hessian_components(gauss, params.spacing)
        h_mask = _frob_mask(frob, params) if apply_mask else torch.ones_like(all_mask)
        if ndim == 2:
            eigs = eigen.eigvalsh2(h["hxx"], h["hxy"], h["hyy"])
        else:
            eigs = eigen.eigvalsh3(h["hxx"], h["hxy"], h["hxz"], h["hyy"], h["hyz"], h["hzz"])
        v = _frangi_response(eigs, gamma_sq, params)
        v = torch.where(h_mask, v, torch.zeros_like(v))
        vessel = torch.maximum(vessel, v.to(carry))
        all_mask = all_mask & h_mask
    return vessel.float() * all_mask, all_mask


def log_blobness_2d(frame: torch.Tensor, mask: torch.Tensor, params: FrangiParams) -> torch.Tensor:
    """Multi-scale LoG "blobness" of a 2D frame inside ``mask``, the
    maximum over scales, clipped at 0 and normalised to [0, 0.1]."""
    frame = frame.float()
    lap = None
    for sigma in params.sigmas:
        cur = -filters.gaussian_laplace(frame, params.sigma_vec(sigma)) * f32(float(sigma) ** 2)
        cur = cur * mask
        lap = cur if lap is None else torch.maximum(lap, cur)
    lap = torch.clamp(lap, min=0.0)
    return lap / (lap.max() + f32(1e-12)) * f32(0.1)


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
    rows_any = (x != 0).any(dim=2)  # (Z, Y)
    ny = x.shape[1]
    row_idx = torch.arange(ny, device=x.device)[None, :]
    has_any = rows_any.any(dim=1, keepdim=True)
    rmin = torch.where(rows_any, row_idx, ny).min(dim=1, keepdim=True).values
    rmax = torch.where(rows_any, row_idx, -1).max(dim=1, keepdim=True).values
    height = torch.clamp(rmax - rmin + 1, min=0)
    margin = torch.clamp(height, max=15)
    kill = (((row_idx >= rmin) & (row_idx < rmin + margin))
            | ((row_idx > rmax - margin) & (row_idx <= rmax))) & has_any
    out = torch.where(kill[:, :, None], torch.zeros_like(x), x)
    return out[0] if frangi_frame.ndim == 2 else out
