"""Separable filters: Gaussian, Laplacian of Gaussian, rank and box filters.

Port of ``nellie_tpu/kernels/filters.py``.  Edges follow scipy: 'reflect'
(numpy 'symmetric') for smoothing and rank filters, zero fill for the box
sum and morphology.  A 1-D correlation is a chain of shifted multiply-adds
in the same tap order as the reference, each contracted as XLA contracts
it (:mod:`nellie_tpu_torch.kernels._fp`), so the results are bitwise those
of the JAX package on the CPU.  On a CUDA tensor the whole chain is one
launch of the hand-written kernel ``csrc/gauss_axis.cu`` (built for
``sm_90a`` with ``nvcc`` on first use, bound through ``ctypes``;
``GAUSS_AXIS_KERNEL.launches`` counts them), which rounds as the plain
versions (``correlate1d_traced_plain``, ``_correlate1d_plain``) do.  Rank
filters are separable chains of shifted min/max, which are exact for any
dtype.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CudaKernel, check_error, on_card
from nellie_tpu_torch.kernels._fp import f32, fma


def gaussian_kernel1d(sigma: float, truncate: float = 3.0, order: int = 0) -> np.ndarray:
    """Sampled Gaussian (or its 1st/2nd derivative), scipy-compatible."""
    sigma = float(sigma)
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    sigma2 = sigma * sigma
    phi = np.exp(-0.5 * x * x / sigma2)
    phi = phi / phi.sum()
    if order == 0:
        return phi
    if order == 1:
        return phi * (-x / sigma2)
    if order == 2:
        return phi * ((x * x - sigma2) / (sigma2 * sigma2))
    raise ValueError(f"Unsupported order {order}")


def gaussian_kernel1d_padded(sigma: float, taps: int, truncate: float = 3.0) -> np.ndarray:
    """Gaussian taps centre-padded with zeros to ``taps``; a delta for sigma<=0."""
    out = np.zeros(taps, np.float64)
    center = taps // 2
    if sigma <= 0:
        out[center] = 1.0
        return out
    k = gaussian_kernel1d(sigma, truncate)
    r = len(k) // 2
    if 2 * r + 1 > taps:
        raise ValueError(f"kernel radius {r} exceeds padded taps {taps}")
    out[center - r: center + r + 1] = k
    return out


def pad_symmetric(x: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """numpy ``mode='symmetric'`` padding (scipy 'reflect') along one axis,
    for any pad width."""
    n = x.shape[axis]
    idx = torch.arange(-before, n + after, device=x.device)
    m = torch.remainder(idx, 2 * n)
    idx = torch.where(m < n, m, 2 * n - 1 - m)
    return torch.index_select(x, axis, idx)


def pad_constant(x: torch.Tensor, axis: int, before: int, after: int, value) -> torch.Tensor:
    shape_b = list(x.shape)
    shape_b[axis] = before
    shape_a = list(x.shape)
    shape_a[axis] = after
    return torch.cat([x.new_full(shape_b, value), x, x.new_full(shape_a, value)], dim=axis)


def _correlate1d_plain(x: torch.Tensor, weights: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with scipy 'reflect' edges; zero taps skipped."""
    radius = len(weights) // 2
    if radius == 0:
        return x * f32(weights[0])
    xp = pad_symmetric(x, axis, radius, radius)
    n = x.shape[axis]
    terms = [(k, f32(w)) for k, w in enumerate(weights) if float(w) != 0.0]
    if not terms:
        return torch.zeros_like(x)
    (k0, w0), rest = terms[0], terms[1:]
    if not rest:
        return xp.narrow(axis, k0, n) * w0
    (k1, w1), rest = rest[0], rest[1:]
    out = fma(xp.narrow(axis, k0, n), w0, xp.narrow(axis, k1, n) * w1)
    for k, w in rest:
        out = fma(xp.narrow(axis, k, n), w, out)
    return out


def correlate1d_traced_plain(x: torch.Tensor, weights: np.ndarray, axis: int) -> torch.Tensor:
    """Correlation with a fixed-length (possibly zero-padded) tap vector.

    The reference traces the taps, so zero taps are not skipped; the
    running sum starts from zero, which XLA folds away."""
    weights = [f32(w) for w in np.asarray(weights, np.float32)]
    taps = len(weights)
    radius = taps // 2
    if radius == 0:
        return x * weights[0]
    xp = pad_symmetric(x, axis, radius, radius)
    n = x.shape[axis]
    out = fma(xp.narrow(axis, 0, n), weights[0], xp.narrow(axis, 1, n) * weights[1])
    for k in range(2, taps):
        out = fma(xp.narrow(axis, k, n), weights[k], out)
    return out


class _GaussAxisKernel(CudaKernel):
    """The compiled 1-D correlation (``csrc/gauss_axis.cu``), built once per
    process, with a launch count."""

    source = "gauss_axis.cu"
    flags = (*BASE_FLAGS, "-fmad=false")
    max_taps = 256
    max_reach = 128  # the largest |offset|: the margin of the kernel's shared tiles

    def bind(self, lib):
        ptr = ctypes.c_void_p
        lib.gauss_axis.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_int, ptr, ptr, ctypes.c_int, ptr]
        lib.gauss_axis.restype = ctypes.c_int

    def __call__(self, x: torch.Tensor, taps, axis: int, round_half: bool = False) -> torch.Tensor:
        """The correlation of the float32 CUDA tensor ``x`` along ``axis``
        over ``taps``, (input offset, float32 weight) pairs in summation
        order, as a new float32 tensor (each value rounded through float16
        with ``round_half``)."""
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise TypeError(f"gauss_axis takes a float32 CUDA tensor, not {x.dtype} on {x.device}")
        if not 1 <= len(taps) <= self.max_taps:
            raise ValueError(f"gauss_axis takes 1 to {self.max_taps} taps, not {len(taps)}")
        if max(abs(int(o)) for o, _ in taps) > self.max_reach:
            raise ValueError(f"gauss_axis taps reach at most {self.max_reach} voxels")
        axis = axis % x.ndim
        x = x.contiguous()
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        n = x.shape[axis]
        inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
        offsets = (ctypes.c_int * len(taps))(*(int(o) for o, _ in taps))
        weights = (ctypes.c_float * len(taps))(*(float(w) for _, w in taps))
        lib = self._lib or self.build()
        with self.on_device(x.device):
            err = lib.gauss_axis(x.data_ptr(), out.data_ptr(), x.numel(), n, inner, len(taps),
                                 offsets, weights, int(bool(round_half)),
                                 torch.cuda.current_stream().cuda_stream)
        check_error("gauss_axis launch", err)
        self.count_launch()
        return out


GAUSS_AXIS_KERNEL = _GaussAxisKernel()


def nonzero_taps(weights: np.ndarray):
    """The kernel's taps for :func:`_correlate1d_plain`: (input offset,
    float32 weight) of each nonzero weight in order, the one weight where
    there is no other; empty where every weight is 0."""
    radius = len(weights) // 2
    if radius == 0:
        return [(0, f32(weights[0]))]
    return [(k - radius, f32(w)) for k, w in enumerate(weights) if float(w) != 0.0]


def traced_taps(weights: np.ndarray):
    """The kernel's taps for :func:`correlate1d_traced_plain`: every weight,
    zeros included, as (input offset, float32 weight)."""
    weights = np.asarray(weights, np.float32)
    radius = len(weights) // 2
    return [(k - radius, f32(w)) for k, w in enumerate(weights)]


def _correlate1d(x: torch.Tensor, weights: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with scipy 'reflect' edges; zero taps
    skipped: ``csrc/gauss_axis.cu`` on a CUDA tensor, or
    :func:`_correlate1d_plain`."""
    if not on_card(x, "_correlate1d"):
        return _correlate1d_plain(x, weights, axis)
    taps = nonzero_taps(weights)
    return GAUSS_AXIS_KERNEL(x, taps, axis) if taps else torch.zeros_like(x)


def correlate1d_traced(x: torch.Tensor, weights: np.ndarray, axis: int,
                       carry: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`correlate1d_traced_plain` of float32 ``x``, each result rounded
    to ``carry`` (float32 or float16) and returned as float32:
    ``csrc/gauss_axis.cu`` on a CUDA tensor, or the plain version."""
    half = carry == torch.float16
    if not on_card(x, "correlate1d_traced"):
        out = correlate1d_traced_plain(x, weights, axis)
        return out.to(carry).float() if half else out
    return GAUSS_AXIS_KERNEL(x, traced_taps(weights), axis, round_half=half)


def gaussian_laplace(x: torch.Tensor, sigma: Sequence[float], truncate: float = 4.0) -> torch.Tensor:
    """Sum over axes of second-derivative Gaussian responses
    (``scipy.ndimage.gaussian_laplace``)."""
    sigma = tuple(float(s) for s in sigma)
    if len(sigma) != x.ndim:
        raise ValueError("sigma must have one entry per axis")
    total = None
    for d2_axis in range(x.ndim):
        term = x
        for axis, s in enumerate(sigma):
            if s <= 0:
                continue
            order = 2 if axis == d2_axis else 0
            term = _correlate1d(term, gaussian_kernel1d(s, truncate, order=order), axis)
        total = term if total is None else total + term
    return total


# --------------------------------------------------------------------------
# Rank / box filters
# --------------------------------------------------------------------------

def _window_dims(x: torch.Tensor, size):
    if isinstance(size, int):
        return (size,) * x.ndim
    return tuple(int(s) for s in size)


def _rank_filter(x, size, mode, cval, op):
    out = x
    for axis, d in enumerate(_window_dims(x, size)):
        r = d // 2
        if r == 0:
            continue
        if mode == "constant":
            xp = pad_constant(out, axis, r, r, cval)
        else:
            xp = pad_symmetric(out, axis, r, r)
        n = out.shape[axis]
        acc = xp.narrow(axis, 0, n)
        for k in range(1, d):
            acc = op(acc, xp.narrow(axis, k, n))
        out = acc
    return out


def maximum_filter(x: torch.Tensor, size=3, mode: str = "reflect", cval=0) -> torch.Tensor:
    """ND maximum filter; mode 'reflect' (scipy default) or 'constant'."""
    return _rank_filter(x, size, mode, cval, torch.maximum)


def minimum_filter(x: torch.Tensor, size=3, mode: str = "reflect", cval=0) -> torch.Tensor:
    return _rank_filter(x, size, mode, cval, torch.minimum)


def _box_sum(x: torch.Tensor, dims, pad) -> torch.Tensor:
    out = x
    for axis, d in enumerate(dims):
        r = d // 2
        xp = pad(out, axis, r)
        n = out.shape[axis]
        acc = xp.narrow(axis, 0, n)
        for k in range(1, d):
            acc = acc + xp.narrow(axis, k, n)
        out = acc
    return out


def uniform_filter(x: torch.Tensor, size=3) -> torch.Tensor:
    """ND box mean with 'reflect' edges.  The port applies it to 0/1 masks,
    whose window sums are exact in any order; XLA divides by the constant
    window size as a multiplication by its float32 reciprocal."""
    dims = _window_dims(x, size)
    summed = _box_sum(x.float(), dims, lambda a, ax, r: pad_symmetric(a, ax, r, r))
    return summed * f32(1.0 / float(np.prod(dims)))


def sum_filter(x: torch.Tensor, size=3) -> torch.Tensor:
    """ND box sum with zero edges (integer inputs)."""
    dims = _window_dims(x, size)
    return _box_sum(x, dims, lambda a, ax, r: pad_constant(a, ax, r, r, 0))


# --------------------------------------------------------------------------
# Binary morphology
# --------------------------------------------------------------------------

def shift_fill(x: torch.Tensor, axis: int, shift: int, fill) -> torch.Tensor:
    """Shift along ``axis`` (positive = take from the higher index), filling
    vacated positions with ``fill``."""
    n = x.shape[axis]
    if shift == 0:
        return x
    s = abs(shift)
    if s >= n:
        return torch.full_like(x, fill)
    if shift > 0:
        return pad_constant(x.narrow(axis, s, n - s), axis, 0, s, fill)
    return pad_constant(x.narrow(axis, 0, n - s), axis, s, 0, fill)


def binary_dilation(mask: torch.Tensor, connectivity=None, size: int = 3) -> torch.Tensor:
    """Cross structuring element for ``connectivity=1``, else a ``size`` box."""
    if connectivity == 1:
        out = mask
        for axis in range(mask.ndim):
            out = out | shift_fill(mask, axis, 1, False) | shift_fill(mask, axis, -1, False)
        return out
    return maximum_filter(mask.to(torch.uint8), size=size).bool()


def binary_opening(mask: torch.Tensor) -> torch.Tensor:
    """Cross-structure erosion (border erodes) then dilation."""
    er = mask
    for axis in range(mask.ndim):
        er = er & shift_fill(mask, axis, 1, False) & shift_fill(mask, axis, -1, False)
    return binary_dilation(er, connectivity=1)
