"""Multi-scale Frangi vesselness of one 2D or 3D frame.

Port of ``nellie_tpu/kernels/frangi.py``: per scale an incremental
Gaussian (Δσ cascade), γ from min(triangle, Otsu) of the positive smoothed
voxels, the Hessian and its normalised Frobenius norm, the Frobenius mask,
closed-form eigenvalues, the Frangi response and a running maximum.  Then
``finalize_frame`` (1st-percentile mask and binary opening) and
``remove_edges_frame``.  2D frames add the multi-scale LoG blobness
(``log_blobness_2d``).

On a CUDA frame a scale runs as one launch of ``csrc/gauss_axis.cu`` per
axis (:func:`filters.correlate1d_traced`) and two of ``csrc/frangi_tail.cu``
(:data:`FRANGI_TAIL_KERNEL`: the Hessian's Frobenius norm and largest
component, then, after the frame-wide statistics in torch, the
eigenvalues, the response, the mask and the running maximum); on a CPU
frame the plain versions (``hessian_frob_plain``, ``frangi_response_plain``
over :mod:`hessian` and :mod:`eigen`) compute the same bits.  The
finalize's 1st percentile is a radix select on a CUDA frame
(``csrc/masked_percentile.cu``, :data:`MASKED_PERCENTILE_KERNEL`, no host
read) and :func:`masked_percentile_plain` on a CPU one; the finalize keeps
its two predicates on the frame's device.

``carry_dtype="float16"`` stores the cascade's carries as float16, as the
reference's program does: the frame divided by its largest |value|, each
smoothing pass's output and the vesselness accumulator are rounded to
float16 (the converts of its optimised HLO), and all arithmetic stays
float32.  A user-set ``frob_thresh`` needs no rescaling there: the
Frobenius norm is divided by the largest |Hessian component|, so it does
not change when the frame is scaled.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from nellie_tpu_torch.kernels import eigen, filters, thresholds
from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CountedKernel, CudaKernel, check_error, on_card
from nellie_tpu_torch.kernels._fp import exp, f32, fma, sqrt, sum_of_products
from nellie_tpu_torch.kernels.hessian import (
    fused_axes,
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

    frame_shape = None  # the Hessian's fusion rules read the block's own shape

    @staticmethod
    def core(index: int, block: torch.Tensor) -> torch.Tensor:
        return block

    @staticmethod
    def all_max(values):
        return values

    @staticmethod
    def triangle_otsu(blocks, max_samples: int):
        """min(triangle, Otsu) of the strided positive voxels, one per
        block: 0 when no sampled voxel is positive, with no host read."""
        pos = _stride_masked_positive(blocks[0], max_samples)
        return [thresholds.min_triangle_otsu(blocks[0], pos)]


# With no positive sampled voxel the threshold is 0, and the reference's
# choices for that case (gamma EPS32, the Frobenius mask frob > 0) are what
# the clamp and the comparison give 0.
def _gammas(gauss, max_samples: int, stats):
    return [torch.clamp(t, min=EPS32) for t in stats.triangle_otsu(gauss, max_samples)]


def _frob_masks(frobs, params: FrangiParams, stats):
    if not params.frob_thresh_division:
        return [frob > 0 for frob in frobs]
    if params.frob_thresh is not None:
        thr = [torch.tensor(f32(params.frob_thresh), device=f.device) for f in frobs]
    else:
        thr = stats.triangle_otsu(frobs, params.max_threshold_samples)
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


class _Geometry(ctypes.Structure):
    """``csrc/frangi_tail.cu``'s ``Geometry``: the block's shape, the
    spacing's constants, the last axis's fusion rule and pass 1's core box."""

    _fields_ = [("ndim", ctypes.c_int), ("n", ctypes.c_int * 3), ("half", ctypes.c_float * 3),
                ("inv", ctypes.c_float * 3), ("fuse", ctypes.c_int * 3),
                ("core_lo", ctypes.c_int * 3), ("core_hi", ctypes.c_int * 3)]


def _core_box(block: torch.Tensor, core: torch.Tensor):
    """([lo], [hi)) per axis of ``core``, a box view of the contiguous
    ``block``."""
    if not block.is_contiguous() or core.stride() != block.stride():
        raise ValueError("the core is not a box of its contiguous block")
    offset = core.storage_offset() - block.storage_offset()
    lo = [int(v) for v in np.unravel_index(offset, tuple(block.shape))] if offset else \
        [0] * block.ndim
    return lo, [a + n for a, n in zip(lo, core.shape)]


def tail_geometry(g: torch.Tensor, spacing, frame_shape, core: torch.Tensor,
                  masked: bool = True) -> _Geometry:
    """The kernel's view of block ``g``: its shape, per axis the Hessian's
    constants f32(0.5 / spacing) and f32(1 / spacing) (the same as
    ``hessian.gradient``'s f32(0.5 * (1 / spacing)) and f32(1 / spacing)),
    whether each diagonal component fuses its whole inner gradient in the
    program with the Frobenius mask or without (``hessian.fused_axes``),
    and the core box of ``core``."""
    geo = _Geometry()
    geo.ndim = g.ndim
    shape = list(g.shape) + [1] * (3 - g.ndim)
    sp = [float(v) for v in spacing] + [1.0] * (3 - g.ndim)
    for a in range(3):
        geo.n[a] = shape[a]
        geo.half[a] = f32(0.5 / sp[a])
        geo.inv[a] = f32(1.0 / sp[a])
        if f32(0.5 * (1.0 / sp[a])) != geo.half[a]:
            raise ValueError(f"spacing {sp[a]}: the gradient's constants differ")
    for a, fused in enumerate(fused_axes(g, frame_shape, masked)):
        geo.fuse[a] = int(fused)
    lo, hi = _core_box(g, core)
    for a in range(3):
        geo.core_lo[a] = lo[a] if a < g.ndim else 0
        geo.core_hi[a] = hi[a] if a < g.ndim else 1
    return geo


class _FrangiTailKernel(CudaKernel):
    """The compiled per-scale Frangi tail (``csrc/frangi_tail.cu``): two
    entry points, each launch counted."""

    source = "frangi_tail.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def bind(self, lib):
        ptr = ctypes.c_void_p
        lib.hessian_frob.argtypes = [ptr, ptr, ptr, ctypes.POINTER(_Geometry), ctypes.c_longlong,
                                     ptr]
        lib.hessian_frob.restype = ctypes.c_int
        lib.frangi_response.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ptr,
                                        ctypes.POINTER(_Geometry), ctypes.c_float,
                                        ctypes.c_float, ctypes.c_longlong, ptr]
        lib.frangi_response.restype = ctypes.c_int

    @staticmethod
    def _check(g):
        if g.device.type != "cuda" or g.dtype != torch.float32 or not g.is_contiguous():
            raise TypeError(f"frangi_tail takes a contiguous float32 CUDA block, not {g.dtype} "
                            f"on {g.device}")
        if g.ndim not in (2, 3) or g.numel() == 0:
            raise ValueError(f"frangi_tail takes a 2D or 3D block, not {tuple(g.shape)}")

    def hessian_frob(self, g: torch.Tensor, geo: _Geometry):
        """Pass 1: (the unnormalised Frobenius norm, the largest |Hessian
        component| over the core box as a 0-dim float32 tensor)."""
        self._check(g)
        lib = self._lib or self.build()
        with self.on_device(g.device):
            frob = torch.empty_like(g)
            largest = torch.zeros((), dtype=torch.int32, device=g.device)
            err = lib.hessian_frob(g.data_ptr(), frob.data_ptr(), largest.data_ptr(),
                                   ctypes.byref(geo), g.numel(),
                                   torch.cuda.current_stream().cuda_stream)
        check_error("hessian_frob launch", err)
        self.count_launch()
        return frob, largest.view(torch.float32)

    def frangi_response(self, g, geo, mask, gamma_sq, params: FrangiParams, vessel, all_mask):
        """Pass 2, in place on ``vessel`` (the carry type) and ``all_mask``."""
        self._check(g)
        for name, t, dtype in (("vessel", vessel, (torch.float32, torch.float16)),
                               ("all_mask", all_mask, (torch.bool,)),
                               ("mask", mask if mask is not None else all_mask, (torch.bool,))):
            if t.shape != g.shape or t.dtype not in dtype or not t.is_contiguous() \
                    or t.device != g.device:
                raise ValueError(f"frangi_tail: {name} {t.dtype} {tuple(t.shape)} on {t.device}")
        gamma_sq = gamma_sq.to(device=g.device, dtype=torch.float32).contiguous()
        lib = self._lib or self.build()
        with self.on_device(g.device):
            err = lib.frangi_response(
                g.data_ptr(), mask.data_ptr() if mask is not None else None, gamma_sq.data_ptr(),
                vessel.data_ptr(), int(vessel.dtype == torch.float16), all_mask.data_ptr(),
                ctypes.byref(geo), f32(1.0 / params.alpha_sq), f32(1.0 / params.beta_sq),
                g.numel(), torch.cuda.current_stream().cuda_stream)
        check_error("frangi_response launch", err)
        self.count_launch()


FRANGI_TAIL_KERNEL = _FrangiTailKernel()


def hessian_frob_plain(g: torch.Tensor, spacing, frame_shape, core):
    """Pass 1 in plain torch: (the Hessian components, their unnormalised
    Frobenius norm, the largest |component| over ``core(component)``)."""
    h, frob = hessian_unnormalized(g, spacing, frame_shape)
    return h, frob, largest_component({k: core(v) for k, v in h.items()})


def frangi_response_plain(h, mask, gamma_sq, params: FrangiParams, vessel, all_mask):
    """Pass 2 in plain torch: the eigenvalues and the response from the
    components ``h``; returns the new (vessel, all_mask)."""
    if "hzz" in h:
        eigs = eigen.eigvalsh3(h["hxx"], h["hxy"], h["hxz"], h["hyy"], h["hyz"], h["hzz"])
    else:
        eigs = eigen.eigvalsh2(h["hxx"], h["hxy"], h["hyy"])
    v = _frangi_response(eigs, gamma_sq, params)
    if mask is not None:
        v = torch.where(mask, v, torch.zeros_like(v))
        all_mask = all_mask & mask
    return torch.maximum(vessel, v.to(vessel.dtype)), all_mask


def hessian_frob(g: torch.Tensor, spacing, frame_shape, core):
    """Pass 1 of a scale's tail on block ``g``: (the components for
    :func:`frangi_response`, or None where the kernel recomputes them; the
    unnormalised Frobenius norm; the largest |component| over the core box,
    ``core(g)``).  ``csrc/frangi_tail.cu`` on a CUDA block, or
    :func:`hessian_frob_plain`."""
    if not on_card(g, "frangi tail"):
        return hessian_frob_plain(g, spacing, frame_shape, core)
    frob, largest = FRANGI_TAIL_KERNEL.hessian_frob(
        g, tail_geometry(g, spacing, frame_shape, core(g)))
    return None, frob, largest


def frangi_response(g, h, params: FrangiParams, frame_shape, mask, gamma_sq, vessel, all_mask):
    """Pass 2 of a scale's tail on block ``g`` (``h`` from
    :func:`hessian_frob`): returns (vessel, all_mask) after
    ``vessel = max(vessel, response in the carry type)`` and
    ``all_mask &= mask`` (``mask`` None: all true, the program without the
    Frobenius mask, whose components round otherwise: they are computed
    here, ``h`` unused).  The kernel updates both in place; the plain
    version returns new tensors."""
    if not on_card(g, "frangi tail"):
        if h is None or mask is None:
            h, _ = hessian_unnormalized(g, params.spacing, frame_shape, masked=mask is not None)
        return frangi_response_plain(h, mask, gamma_sq, params, vessel, all_mask)
    geo = tail_geometry(g, params.spacing, frame_shape, g, masked=mask is not None)
    FRANGI_TAIL_KERNEL.frangi_response(g, geo, mask, gamma_sq, params, vessel, all_mask)
    return vessel, all_mask


def vesselness_blocks(blocks, params: FrangiParams, apply_mask: bool, stats):
    """:func:`vesselness_frame` of a frame given as blocks, each on its own
    device: every per-voxel step runs block by block, and the frame-wide
    reductions (the float16 carry's scale, γ, the Hessian's largest
    component, the Frobenius threshold) come from ``stats``
    (:class:`WholeFrame` or a mesh's shard statistics).  A scale is, per
    block, one 1-D correlation per axis (:func:`filters.correlate1d_traced`),
    pass 1 of the tail (:func:`hessian_frob`), the statistics, and pass 2
    (:func:`frangi_response`).  Returns the lists of vesselness and mask
    blocks."""
    frames = [b.float() for b in blocks]
    carry = CARRY_DTYPES[params.carry_dtype]
    if carry != torch.float32:
        # the response does not change under a uniform rescale; this keeps
        # the carried magnitudes inside float16's range
        scale = stats.all_max([stats.core(b, f).abs().max() for b, f in enumerate(frames)])
        frames = [f / torch.clamp(m, min=EPS32) for f, m in zip(frames, scale)]
    ndim = frames[0].ndim
    kernel_stacks = _delta_kernels(params, ndim)
    gauss = [f.to(carry).float() for f in frames]  # float32 holding carry values
    vessel = [torch.zeros(f.shape, dtype=carry, device=f.device) for f in frames]
    all_mask = [torch.ones(f.shape, dtype=torch.bool, device=f.device) for f in frames]
    for i in range(len(params.sigmas)):
        for b, g in enumerate(gauss):
            for axis in range(ndim):
                g = filters.correlate1d_traced(g, kernel_stacks[axis][i], axis, carry)
            gauss[b] = g
        gamma_sq = [2.0 * g * g for g in _gammas(gauss, params.max_threshold_samples, stats)]
        if apply_mask:
            tails = [hessian_frob(g, params.spacing, stats.frame_shape,
                                  lambda v, b=b: stats.core(b, v)) for b, g in enumerate(gauss)]
            largest = stats.all_max([m for _, _, m in tails])
            frobs = [frob / nonzero_or_one(m) for (_, frob, _), m in zip(tails, largest)]
            h_masks = _frob_masks(frobs, params, stats)
            del frobs
        else:
            # no Frobenius norm: pass 2 computes the components as the
            # program without the mask rounds them
            tails = [(None, None, None)] * len(gauss)
            h_masks = [None] * len(gauss)
        for b, (h, _, _) in enumerate(tails):
            vessel[b], all_mask[b] = frangi_response(gauss[b], h, params, stats.frame_shape,
                                                     h_masks[b], gamma_sq[b], vessel[b],
                                                     all_mask[b])
        del tails, h_masks
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
        # XLA turns the product with the converted mask into a select: +0
        # outside the mask, never -0
        cur = torch.where(mask.bool(), cur, torch.zeros_like(cur))
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


# The percentile's last step, s[lo] (1 - frac) + s[hi] frac, rounds once in
# either of two forms, and XLA contracts a different product in different
# fusions of one program:
A, B = 0, 1  # fma(s[lo], 1 - frac, s[hi] frac), fma(s[hi], frac, s[lo] (1 - frac))

# The form each term of the finalize's opening compares with, by the
# frame's axes: (the unshifted term, at every position of the dilation; the
# six (four) side terms of the erosion).  Read off XLA's CPU machine code,
# fusion by fusion, by ``scripts/xla_finalize_contractions.py`` at the main
# paths' frames (64 x 256 x 256 and 1024 x 1024) and the tests' smaller
# ones, the same in every reference program that opens the whole frame: the
# jitted ``finalize_frame`` and ``mask_volume`` (the Filter stage and the
# fused chain's per-frame loop, ``fused.py:292``), the mesh's vmapped
# ``batched_filter_kernel`` and capacity's monolithic
# ``_segment_from_vessel``.  Each side term is a fusion of its own, the
# unshifted term is computed inline in the last fusion.  Capacity's chunked
# windows compare with the percentile jitted alone (``_pct_from_sample``),
# form B in every term: :func:`masked_percentile`.
FINALIZE_FORMS = {3: (A, B), 2: (B, B)}


def masked_percentile_plain(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """:func:`masked_percentile_forms` in plain torch: a host read of the
    count, a full sort and the two fused multiply-adds.  The sort is the
    reference's: stable, -0 tied with +0, NaN last; it sorts keys with
    every zero +0 and every NaN one NaN, and takes the values in their
    order."""
    flat = values.reshape(-1).float()
    m = mask.reshape(-1)
    n_valid = int(m.sum())
    if n_valid == 0:
        return torch.zeros(2, device=flat.device)
    v = torch.where(m, flat, torch.full_like(flat, float("inf")))
    keys = torch.where(v == 0, torch.zeros_like(v), v)
    keys = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), keys)
    order = torch.sort(keys, stable=True).indices
    pos = torch.tensor(f32(q / 100.0), device=flat.device) * float(max(n_valid - 1, 0))
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.float()
    one = 1.0 - frac
    s_lo, s_hi = v[order[lo]], v[order[hi]]
    return torch.stack([fma(s_lo, one, s_hi * frac), fma(s_hi, frac, s_lo * one)])


class _MaskedPercentileKernel(CountedKernel):
    """The compiled radix select (``csrc/masked_percentile.cu``), built once
    per process, with a launch count, a count of the CUDA kernels launched
    and the last call's ``last_stats`` (CUDA kernels, host reads)."""

    source = "masked_percentile.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def bind(self, lib):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.masked_percentile_scratch_bytes.argtypes = []
        lib.masked_percentile_scratch_bytes.restype = i64
        lib.masked_percentile.argtypes = [ptr, ptr, i64, i64, i64, ctypes.c_float, ptr, ptr,
                                          ctypes.POINTER(ctypes.c_int), ptr]
        lib.masked_percentile.restype = ctypes.c_int

    def __call__(self, values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
        """The percentile's two forms, A and B, as a (2,) float32 tensor on
        ``values``' CUDA device, by one C call with no host read; ``mask``
        bool of the values' size, ``q`` in [0, 100].  A flat strided view is read in
        place; values of another float type are first copied to float32."""
        if values.device.type != "cuda" or not values.dtype.is_floating_point:
            raise TypeError(f"the percentile kernel takes a floating-point CUDA tensor, not "
                            f"{values.dtype} on {values.device}")
        if mask.dtype != torch.bool or mask.device != values.device or \
                mask.numel() != values.numel():
            raise ValueError("the percentile kernel takes a bool mask of the values' size on "
                             "their device")
        q100 = f32(q / 100.0)
        if not 0.0 <= q100 <= 1.0:
            raise ValueError(f"the percentile kernel takes q in [0, 100], not {q}")
        dev = values.device
        out = torch.zeros(2, dtype=torch.float32, device=dev)
        if values.numel() == 0:
            return out
        lib = self._lib or self.build()
        with self.on_device(dev):
            flat = values.reshape(-1).float()
            m = mask.reshape(-1)
            scratch = torch.empty(lib.masked_percentile_scratch_bytes(), dtype=torch.uint8,
                                  device=dev)
            kernels = ctypes.c_int(0)
            err = lib.masked_percentile(flat.data_ptr(), m.data_ptr(), flat.numel(),
                                        flat.stride(0), m.stride(0), q100, scratch.data_ptr(),
                                        out.data_ptr(), ctypes.byref(kernels),
                                        torch.cuda.current_stream(dev).cuda_stream)
            check_error("masked_percentile launch", err)
            self.count_call(kernels.value, host_reads=0)
        return out


MASKED_PERCENTILE_KERNEL = _MaskedPercentileKernel()


def masked_percentile_forms(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile (linear interpolation) of values[mask] in both forms of
    its last step, ``[A, B]`` (:data:`A`, :data:`B`), zeros when nothing is
    masked in.  A CUDA tensor goes to the hand-written kernel (or raises),
    a CPU tensor to :func:`masked_percentile_plain`."""
    if on_card(values, "masked_percentile"):
        return MASKED_PERCENTILE_KERNEL(values, mask, q)
    return masked_percentile_plain(values, mask, q)


def masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """The percentile in form B, a 0-dim tensor: the reference's
    ``masked_percentile`` jitted alone (capacity's ``_pct_from_sample``)."""
    return masked_percentile_forms(values, mask, q)[B]


def opening_mask(frame: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The opened mask of ``frame > thr`` with each term of the opening in
    the form that its fusion takes in the reference's whole-frame programs
    (:data:`FINALIZE_FORMS`); ``thr`` the pair ``[A, B]``."""
    centre, side = FINALIZE_FORMS[frame.ndim]
    masks = [frame > thr[k].to(frame.dtype) for k in (A, B)]
    return filters.binary_opening_terms(masks, centre, side)


def mask_volume(frangi_frame: torch.Tensor, max_samples: int = int(1e6)) -> torch.Tensor:
    """1st-percentile threshold of the positive sample + binary opening;
    the frame as it is when no sampled value is positive (decided on the
    frame's device, as the reference's ``jnp.where``)."""
    strides = thresholds.sample_strides(tuple(frangi_frame.shape), max_samples)
    sample = thresholds.downsample(frangi_frame, strides)
    pos = sample > 0
    thr = masked_percentile_forms(sample, pos, 1.0)
    mask = opening_mask(frangi_frame, thr)
    return torch.where(pos.any(), frangi_frame * mask, frangi_frame)


def finalize_frame(frangi_frame: torch.Tensor, max_samples: int = int(1e6)) -> torch.Tensor:
    """Percentile-mask refinement, applied only when the frame has signal
    (decided on the frame's device, as the reference's ``lax.cond``)."""
    return torch.where(frangi_frame.sum() > 0, mask_volume(frangi_frame, max_samples),
                       frangi_frame)


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
