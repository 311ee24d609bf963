"""Histogram thresholds (Otsu, triangle) over masked values.

Port of ``nellie_tpu/kernels/thresholds.py``.  The histogram is a
``torch.bincount`` in place of the reference's radix-16 one-hot matmul
(``_bincount_tiled``, a TPU workaround); both give exact counts.  The bin
index arithmetic of ``_masked_histogram`` is mirrored operation by
operation in float32, and the cumulative sums follow XLA's blocked order
(:func:`cumsum_f32`), so the chosen bin is the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.kernels._fp import fma, sqrt, sum_of_products

_SCAN_BLOCK = 16


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum along the last axis, one add at a time: the same
    rounding on the card as on the CPU (``torch.cumsum`` scans in another
    order on a CUDA device)."""
    acc = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., k])
    return torch.stack(acc, dim=-1)


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """1-D float32 prefix sum in XLA's order on the CPU: sequential inside
    blocks of 16, block totals prefix-summed the same way (recursively),
    then added to each block."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return _running_sum(x)
    nb = -(-n // _SCAN_BLOCK)
    pad = torch.zeros(nb * _SCAN_BLOCK, dtype=x.dtype, device=x.device)
    pad[:n] = x
    blocks = pad.reshape(nb, _SCAN_BLOCK)
    inner = _running_sum(blocks)
    totals = cumsum_f32(inner[:, -1].contiguous())
    offset = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (inner + offset[:, None]).reshape(-1)[:n]


def _masked_histogram(values: torch.Tensor, mask: torch.Tensor, nbins: int):
    """Histogram of values[mask] over (masked min, masked max): numpy-style
    half-open bins, the last one closed."""
    flat = values.reshape(-1).float()
    mflat = mask.reshape(-1)
    inf = torch.tensor(float("inf"), device=flat.device)
    any_valid = bool(mflat.any())
    if any_valid:
        lo = torch.where(mflat, flat, inf).min()
        hi = torch.where(mflat, flat, -inf).max()
    else:
        lo = torch.zeros((), device=flat.device)
        hi = torch.ones((), device=flat.device)
    span = hi - lo
    safe_span = torch.where(span > 0, span, torch.ones_like(span))
    idx = torch.floor((flat - lo) / safe_span * float(nbins)).to(torch.int64)
    idx = torch.clamp(idx, 0, nbins - 1)
    idx = torch.where(mflat, idx, torch.full_like(idx, nbins))
    counts = torch.bincount(idx, minlength=nbins + 1)[:nbins].float()
    bins = torch.arange(nbins, dtype=torch.float32, device=flat.device)
    edges_lo = fma(bins, span / float(nbins), lo)
    centers = edges_lo + span / float(2 * nbins)
    return counts, centers, any_valid


def _otsu_from_hist(counts, centers, any_valid):
    total = counts.sum()
    p = counts / torch.clamp(total, min=1.0)
    pc = p * centers
    weight1 = cumsum_f32(p)
    mean1 = cumsum_f32(pc) / torch.clamp(weight1, min=1e-30)
    rev_w = cumsum_f32(p.flip(0))
    weight2 = rev_w.flip(0)
    mean2 = (cumsum_f32(pc.flip(0)) / torch.clamp(rev_w, min=1e-30)).flip(0)
    gap = mean1[:-1] - mean2[1:]
    variance12 = weight1[:-1] * weight2[1:] * (gap * gap)
    idx = torch.argmax(variance12)
    threshold = centers[idx] if any_valid else torch.zeros((), device=centers.device)
    return threshold, variance12[idx]


def otsu_threshold(values: torch.Tensor, mask=None, nbins: int = 256):
    """Otsu's threshold of values[mask]. Returns (threshold, criterion)."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    return _otsu_from_hist(*_masked_histogram(values, mask, nbins))


def _triangle_from_hist(counts, centers, any_valid):
    nbins = counts.shape[0]
    dev = counts.device
    hist = counts / torch.clamp(counts.sum(), min=1.0)
    arg_peak = int(torch.argmax(hist))
    peak_height = hist[arg_peak]
    nz = torch.nonzero(hist > 0).reshape(-1)
    arg_low = int(nz.min()) if nz.numel() else nbins
    arg_high = int(nz.max()) if nz.numel() else -1

    flip = (arg_peak - arg_low) < (arg_high - arg_peak)
    hist_f = hist.flip(0) if flip else hist
    arg_low_f = nbins - arg_high - 1 if flip else arg_low
    arg_peak_f = nbins - arg_peak - 1 if flip else arg_peak

    width = torch.tensor(float(arg_peak_f - arg_low_f), device=dev)
    norm = sqrt(sum_of_products([(peak_height, peak_height), (width, width)]))
    ph = peak_height / torch.clamp(norm, min=1e-30)
    wd = width / torch.clamp(norm, min=1e-30)

    bins = torch.arange(nbins, device=dev)
    x1 = (bins - arg_low_f).float()
    valid = (bins >= arg_low_f) & (bins < arg_peak_f)
    length = torch.where(valid, fma(ph, x1, -(wd * hist_f)),
                         torch.tensor(-float("inf"), device=dev))
    arg_level = int(torch.argmax(length)) if bool(valid.any()) else arg_low_f
    if flip:
        arg_level = nbins - arg_level - 1
    if not any_valid:
        return torch.zeros((), device=dev)
    return centers[arg_level]


def triangle_threshold(values: torch.Tensor, mask=None, nbins: int = 256):
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    return _triangle_from_hist(*_masked_histogram(values, mask, nbins))


def min_triangle_otsu(values: torch.Tensor, mask=None, nbins: int = 256):
    """min(triangle, Otsu) from one shared histogram."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    hist = _masked_histogram(values, mask, nbins)
    tri = _triangle_from_hist(*hist)
    ots, _ = _otsu_from_hist(*hist)
    return torch.minimum(tri, ots)


def sample_strides(shape, max_samples: int):
    """Strided-downsampling factors with prod(ceil(s/stride)) <= max_samples."""
    if max_samples is None or max_samples <= 0:
        return (1,) * len(shape)
    total = int(np.prod(shape))
    if total <= max_samples:
        return (1,) * len(shape)
    ndim = len(shape)
    stride = int(np.ceil((total / max_samples) ** (1.0 / ndim)))
    strides = [max(1, stride) for _ in range(ndim)]
    while int(np.prod([int(np.ceil(s / st)) for s, st in zip(shape, strides)])) > max_samples:
        idx = int(np.argmax([s / st for s, st in zip(shape, strides)]))
        strides[idx] += 1
    return tuple(strides)


def downsample(arr: torch.Tensor, strides) -> torch.Tensor:
    if all(s == 1 for s in strides):
        return arr
    return arr[tuple(slice(None, None, s) for s in strides)]


def stride_mask(shape, strides, device) -> torch.Tensor:
    """Boolean mask of exactly the :func:`downsample` positions."""
    m = torch.ones(shape, dtype=torch.bool, device=device)
    for ax, s in enumerate(strides):
        if s <= 1:
            continue
        sel = (torch.arange(shape[ax], device=device) % s) == 0
        view = [1] * len(shape)
        view[ax] = shape[ax]
        m = m & sel.reshape(view)
    return m
