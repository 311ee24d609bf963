"""Histogram thresholds (Otsu, triangle) over masked values.

Port of ``nellie_tpu/kernels/thresholds.py``.  The histogram is a
``torch.bincount`` in place of the reference's radix-16 one-hot matmul
(``_bincount_tiled``, a TPU workaround); both give exact counts.  The bin
index arithmetic of ``_masked_histogram`` is mirrored operation by
operation in float32, the cumulative sums follow XLA's blocked order
(:func:`cumsum_f32`) and the counts' float32 total XLA's reduction order
(:func:`counts_total`), so the chosen bin is the reference's at any number
of masked values.  The counts are exact integers here; the reference's
matmul counts are exact while each bin holds fewer than 2**24 values (its
docstring), and there the two agree.

On a CUDA tensor ``otsu_threshold``, ``triangle_threshold`` and
``min_triangle_otsu`` launch the hand-written kernel
``csrc/hist_threshold.cu`` (built for ``sm_90a`` with ``nvcc`` on first
use, bound through ``ctypes``; one memset and two launches a call, led by
the mask, no host read: the results stay on the device), or raise; on a
CPU tensor they run their plain bodies (``*_plain``).
:func:`triangle_and_otsu` returns both thresholds of one histogram, from
one kernel call.
``HIST_THRESHOLD_KERNEL.launches`` counts the wrapper's calls and
``kernel_launches`` the CUDA kernels they launched.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CountedKernel, check_error, on_card
from nellie_tpu_torch.kernels._fp import REDUCE_WINDOW, fma, sqrt, sum_of_products

_SCAN_BLOCK = 16
_DOT_COLUMNS = 16  # the reference's counts are a (nbins / 16, 16) matmul's rows


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


def counts_total(counts: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` of the reference's float32 counts as XLA's CPU code
    rounds it.  Where ``nbins`` is a multiple of 16 it sums the (nbins / 16,
    16) matmul product, else the 1-D slice of it.  Up to 32 rows (or
    values) it adds them one at a time in row-major order; past that it
    first sums windows of 32 rows (32 values), padded with zeros to a
    multiple of 32, half of the padding (rounded down) before the first
    row, each window one element at a time, and then the window sums the
    same way, until at most 32 remain."""
    x = counts
    n = x.shape[0]
    unit = _DOT_COLUMNS if n % _DOT_COLUMNS == 0 else 1
    rows = n // unit
    while rows > REDUCE_WINDOW:
        pad = -rows % REDUCE_WINDOW
        before = pad // 2
        x = torch.nn.functional.pad(x, (before * unit, (pad - before) * unit))
        x = x.reshape(-1, REDUCE_WINDOW * unit)
        acc = x[:, 0]
        for k in range(1, x.shape[1]):
            acc = acc + x[:, k]
        x, unit, rows = acc, 1, acc.shape[0]
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _masked_histogram(values: torch.Tensor, mask: torch.Tensor, nbins: int):
    """Histogram of values[mask] over (masked min, masked max): numpy-style
    half-open bins, the last one closed."""
    flat = values.reshape(-1).float()
    mflat = mask.reshape(-1)
    inf = torch.full((), float("inf"), device=flat.device)
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
    counts = torch.bincount(idx, minlength=nbins + 1)[:nbins]
    bins = torch.arange(nbins, dtype=torch.float32, device=flat.device)
    # divisors on the device: PyTorch's CUDA division by a number multiplies
    # by its reciprocal, which rounds otherwise
    n, n2 = (torch.full((), float(k), device=flat.device) for k in (nbins, 2 * nbins))
    edges_lo = fma(bins, span / n, lo)
    centers = edges_lo + span / n2
    counts = counts.float()
    return counts, centers, any_valid, counts_total(counts)


def _otsu_from_hist(counts, centers, any_valid, total):
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


def otsu_threshold_plain(values: torch.Tensor, mask=None, nbins: int = 256):
    """:func:`otsu_threshold` in plain torch."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    return _otsu_from_hist(*_masked_histogram(values, mask, nbins))


def _triangle_from_hist(counts, centers, any_valid, total):
    nbins = counts.shape[0]
    dev = counts.device
    hist = counts / torch.clamp(total, min=1.0)
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


def triangle_threshold_plain(values: torch.Tensor, mask=None, nbins: int = 256):
    """:func:`triangle_threshold` in plain torch."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    return _triangle_from_hist(*_masked_histogram(values, mask, nbins))


def triangle_and_otsu_plain(values: torch.Tensor, mask=None, nbins: int = 256):
    """:func:`triangle_and_otsu` in plain torch: one shared histogram."""
    if mask is None:
        mask = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    hist = _masked_histogram(values, mask, nbins)
    return _triangle_from_hist(*hist), _otsu_from_hist(*hist)[0]


def min_triangle_otsu_plain(values: torch.Tensor, mask=None, nbins: int = 256):
    """:func:`min_triangle_otsu` in plain torch: one shared histogram."""
    return torch.minimum(*triangle_and_otsu_plain(values, mask, nbins))


class _HistThresholdKernel(CountedKernel):
    """The compiled histogram thresholds (``csrc/hist_threshold.cu``), built
    once per process, with a launch count and a count of the CUDA kernels
    launched.  A call's scratch (its counters, counts and record of the
    masked values) is kept for the next call on the same device and
    stream, which runs after it there; the lock covers the C call."""

    source = "hist_threshold.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def __init__(self):
        super().__init__()
        self._scratch = {}  # (device index, stream): scratch bytes on that device

    def bind(self, lib):
        ptr = ctypes.c_void_p
        lib.hist_threshold_scratch.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        lib.hist_threshold_scratch.restype = ctypes.c_longlong
        lib.hist_threshold.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr, ptr,
                                       ctypes.POINTER(ctypes.c_int), ptr]
        lib.hist_threshold.restype = ctypes.c_int

    def launch(self, values: torch.Tensor, mask=None, nbins: int = 256, with_any=False):
        """(the four results as one float32 tensor: Otsu, its criterion,
        triangle, min(triangle, Otsu); whether a value is masked in, a
        0-dim bool tensor, or None without ``with_any``) on ``values``' CUDA
        device, by one C call with no host read; ``mask`` bool of
        ``values``' size, or None for all; any ``nbins`` from 2 (the C entry
        point refuses others).  Values of another float type are first
        copied to float32."""
        if values.device.type != "cuda" or not values.dtype.is_floating_point:
            raise TypeError(f"the threshold kernel takes a floating-point CUDA tensor, not "
                            f"{values.dtype} on {values.device}")
        if mask is not None and (mask.dtype != torch.bool or mask.device != values.device
                                 or mask.numel() != values.numel()):
            raise ValueError("the threshold kernel takes a bool mask of the values' size on "
                             "their device")
        dev = values.device
        lib = self._lib or self.build()
        with self.on_device(dev):
            flat = values.reshape(-1).float().contiguous()
            mflat = None if mask is None else mask.reshape(-1).contiguous()
            stream = torch.cuda.current_stream(dev).cuda_stream
            out = torch.empty(4, dtype=torch.float32, device=dev)
            any_valid = torch.empty((), dtype=torch.bool, device=dev) if with_any else None
            nbytes = lib.hist_threshold_scratch(nbins, flat.numel(), int(mflat is not None))
            kernels = ctypes.c_int(0)
            with self._lock:
                key = (dev.index, stream)
                scratch = self._scratch.get(key)
                if scratch is None or scratch.numel() < nbytes:
                    scratch = self._scratch[key] = torch.empty(nbytes, dtype=torch.uint8,
                                                               device=dev)
                err = lib.hist_threshold(flat.data_ptr(),
                                         None if mflat is None else mflat.data_ptr(),
                                         flat.numel(), nbins, scratch.data_ptr(), out.data_ptr(),
                                         None if any_valid is None else any_valid.data_ptr(),
                                         ctypes.byref(kernels), stream)
                check_error("hist_threshold launch", err)
                self.count_call(kernels.value)
            return out, any_valid

    def __call__(self, values: torch.Tensor, mask=None, nbins: int = 256):
        """(Otsu, its criterion, triangle, min(triangle, Otsu), any masked
        value) as 0-dim tensors on ``values``' CUDA device (:meth:`launch`)."""
        out, any_valid = self.launch(values, mask, nbins, with_any=True)
        return out[0], out[1], out[2], out[3], any_valid


HIST_THRESHOLD_KERNEL = _HistThresholdKernel()


def otsu_threshold(values: torch.Tensor, mask=None, nbins: int = 256):
    """Otsu's threshold of values[mask]. Returns (threshold, criterion).
    A CUDA tensor goes to the hand-written kernel (or it raises), a CPU
    tensor to :func:`otsu_threshold_plain`."""
    if on_card(values, "otsu_threshold"):
        out, _ = HIST_THRESHOLD_KERNEL.launch(values, mask, nbins)
        return out[0], out[1]
    return otsu_threshold_plain(values, mask, nbins)


def triangle_threshold(values: torch.Tensor, mask=None, nbins: int = 256):
    """The triangle threshold of values[mask]; on a CUDA tensor the
    hand-written kernel, on a CPU tensor :func:`triangle_threshold_plain`."""
    if on_card(values, "triangle_threshold"):
        return HIST_THRESHOLD_KERNEL.launch(values, mask, nbins)[0][2]
    return triangle_threshold_plain(values, mask, nbins)


def triangle_and_otsu(values: torch.Tensor, mask=None, nbins: int = 256):
    """(triangle, Otsu) of values[mask] from one shared histogram; on a
    CUDA tensor one call of the hand-written kernel, on a CPU tensor
    :func:`triangle_and_otsu_plain`."""
    if on_card(values, "triangle_and_otsu"):
        out, _ = HIST_THRESHOLD_KERNEL.launch(values, mask, nbins)
        return out[2], out[0]
    return triangle_and_otsu_plain(values, mask, nbins)


def min_triangle_otsu(values: torch.Tensor, mask=None, nbins: int = 256):
    """min(triangle, Otsu) from one shared histogram; on a CUDA tensor the
    hand-written kernel, on a CPU tensor :func:`min_triangle_otsu_plain`."""
    if on_card(values, "min_triangle_otsu"):
        return HIST_THRESHOLD_KERNEL.launch(values, mask, nbins)[0][3]
    return min_triangle_otsu_plain(values, mask, nbins)


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
