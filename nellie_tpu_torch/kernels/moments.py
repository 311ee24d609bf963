"""Batched image moments, Hu invariants and ROI statistics.

Port of ``nellie_tpu/kernels/moments.py``: raw moments as two
contractions, central moments by the binomial transform, η normalisation,
the first six Hu invariants, and masked mean/variance of nonzero voxels.

Third-order central moments cancel most of their digits in float32, so
the raw moments are summed in the order XLA's CPU dot sums the
reference's einsums, and the binomial transform fuses its multiply-adds
where XLA does: the Hu features then follow the reference's roundings
instead of amplifying a different summation order's.

``hu_features`` (the whole chain, raw moments to log-Hu, of a chunk of
ROIs) on a CUDA tensor launches the hand-written kernel
``csrc/hu_features.cu`` (one launch a call, a block an ROI) and
``masked_mean_variance`` the kernel ``csrc/roi_stats.cu`` (one launch a
call: a warp a block, a lane an ROI, the ROIs streamed through shared
memory by bulk copies), each built for ``sm_90a`` with ``nvcc`` on first
use and bound through ``ctypes``, or they raise; on a CPU tensor they run
:func:`hu_features_plain` (the composition of the functions below) and
:func:`masked_mean_variance_plain`.  ``HU_FEATURES_KERNEL.launches`` and
``ROI_STATS_KERNEL.launches`` count the wrappers' calls and
``kernel_launches`` the CUDA kernels they launched;
``ROI_STATS_KERNEL.chain_floor`` runs the chain that bounds that kernel
alone, for timing.
"""
from __future__ import annotations

import ctypes
from math import comb

import torch

from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CountedKernel, check_error, on_card
from nellie_tpu_torch.kernels._fp import (
    _TINY, ADD, FMA, MUL, R0, accumulate, contract, flush, fma, log10)
from nellie_tpu_torch.kernels._fp import pow as pow_f32


def raw_moments(images: torch.Tensor, order: int = 3) -> torch.Tensor:
    """M[n, p, q] with p the column (x) power and q the row (y) power."""
    _, h, w = images.shape
    k = order + 1
    # the powers as exact integers (a float pow may round them on the card)
    powers = torch.arange(k, device=images.device)
    row_pow = (torch.arange(h, device=images.device)[:, None] ** powers[None, :]).float()
    col_pow = (torch.arange(w, device=images.device)[:, None] ** powers[None, :]).float()
    tmp = _dot(images, col_pow)                   # (N, H, K)
    return _dot(tmp.transpose(1, 2), row_pow)     # (N, K, K)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...k,kp->...p", x, w)`` as XLA's CPU dot rounds it in the
    tracker's program: the largest multiple of 4 of k in four lanes
    (:func:`_fp.contract`), the rest's products rounded and added left to
    right, and that sum added last."""
    k = x.shape[-1]
    main = k - k % 4
    rest = None
    for j in range(main, k):
        p = x[..., j, None] * w[j]
        rest = p if rest is None else rest + p
    if main == 0:
        return rest
    head = contract(x[..., :main], w[:main])
    return head if rest is None else head + rest


_VOXEL_BLOCK = 4096  # voxels per block of widened terms in masked_mean_variance (and roi_stats.cu)

# (p, q) of the central moments whose first addition XLA's CPU code fuses
# with its right product (the left one elsewhere); read off its output.
# XLA fuses the same expressions differently in different programs: the
# tracker's feature program (``hu_tracking._frame_features_fused``) maps
# its chunks of markers with ``lax.map``, which XLA inlines for one chunk
# and compiles as a loop body for more, and in the loop body μ30 fuses its
# left product.  ``looped`` below selects that program.
_FUSE_RIGHT = frozenset({(0, 3), (1, 2), (1, 3), (2, 1), (2, 3), (3, 0), (3, 1)})
_FUSE_RIGHT_LOOPED = _FUSE_RIGHT - {(3, 0)}


def _sum_terms(terms, fuse_right):
    """``t0 + t1 + ...`` for terms ``(factor, value)`` meaning
    ``factor * value`` (``factor`` None for a bare value), with XLA's fused
    multiply-adds: every later product is fused into the running sum.  One
    chain of multiply-adds (``_fp.accumulate``)."""
    if len(terms) == 1:
        f, v = terms[0]
        return v if f is None else f * v
    (f0, v0), (f1, v1) = terms[0], terms[1]
    if f1 is not None and (f0 is None or fuse_right):
        first = [(R0, FMA, f1, v1, v0)] if f0 is None else [(R0, MUL, f0, v0),
                                                            (R0, FMA, f1, v1, R0)]
    elif f0 is not None:
        first = [(R0, FMA, f0, v0, v1)] if f1 is None else [(R0, MUL, f1, v1),
                                                            (R0, FMA, f0, v0, R0)]
    else:
        first = [(R0, ADD, v0, v1)]
    return accumulate(first, terms[2:])


def _neg_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """(-x) ** k for k in 1..3 as XLA's integer power multiplies it out (and
    PyTorch's CPU pow): x x and (x x) x, written so on every device."""
    v = -x
    return v if k == 1 else v * v if k == 2 else (v * v) * v


def central_moments(m: torch.Tensor, looped: bool = False) -> torch.Tensor:
    k = m.shape[1]
    fuse_right = _FUSE_RIGHT_LOOPED if looped else _FUSE_RIGHT
    m00 = m[:, 0, 0] + 1e-12
    x_bar = m[:, 1, 0] / m00
    y_bar = m[:, 0, 1] / m00
    mu = torch.zeros_like(m)
    for p in range(k):
        for q in range(k):
            # XLA drops the factors equal to 1 and fuses a product into the
            # addition that consumes it
            terms = []
            for i in range(p + 1):
                for j in range(q + 1):
                    factor = None
                    coeff = comb(p, i) * comb(q, j)
                    factors = ([float(coeff)] if coeff != 1 else []) + \
                        ([_neg_pow(x_bar, p - i)] if p != i else []) + \
                        ([_neg_pow(y_bar, q - j)] if q != j else [])
                    for f in factors:
                        factor = f if factor is None else factor * f
                    terms.append((factor, m[:, i, j]))
            mu[:, p, q] = _sum_terms(terms, (p, q) in fuse_right)
    return mu


def normalized_moments(images: torch.Tensor, looped: bool = False) -> torch.Tensor:
    """η moments up to order 3, shape (N, 4, 4)."""
    m = raw_moments(images, order=3)
    mu = central_moments(m, looped)
    # m00 ** ((i + j + 2) / 2) through XLA's CPU pow (glibc's powf; x and
    # x * x at 1 and 2), so that the denominators agree on every device
    m00 = m[:, 0, 0]
    powers = {e: pow_f32(m00, e / 2.0) for e in range(2, 9)}
    denom = torch.stack([torch.stack([powers[i + j + 2] for j in range(4)], dim=-1)
                         for i in range(4)], dim=-2) + 1e-12
    return mu / denom


def hu_moments(eta: torch.Tensor, projections: bool = False) -> torch.Tensor:
    """The first six Hu moments (the 7th is skipped for mirror invariance),
    with the multiply-adds XLA's CPU code fuses: a product used once is
    fused into the addition or subtraction that consumes it (read off
    ``jax.jit`` of the reference).  Where both products of an addition
    could fuse, the reference's 2D program fuses the left one and leaves
    h1 unfused; its program over the three projections of a 3D ROI
    (``projections``) fuses h1 and the right product of h4."""
    eta20, eta02, eta11 = eta[:, 2, 0], eta[:, 0, 2], eta[:, 1, 1]
    eta30, eta12, eta21, eta03 = eta[:, 3, 0], eta[:, 1, 2], eta[:, 2, 1], eta[:, 0, 3]
    a, b = eta30 + eta12, eta21 + eta03
    a2, b2 = a * a, b * b
    s1 = fma(-3.0, eta12, eta30)   # eta30 - 3 eta12
    s2 = fma(3.0, eta21, -eta03)   # 3 eta21 - eta03
    h0 = eta20 + eta02
    d = eta20 - eta02
    e11sq4 = 4 * (eta11 * eta11)
    h2 = fma(s1, s1, s2 * s2)
    h3 = fma(a, a, b2)
    p1, t1 = s1 * a, fma(-3.0, b2, a2)
    p2, t2 = s2 * b, fma(3.0, a2, -b2)
    if projections:
        h1 = fma(d, d, e11sq4)
        h4 = fma(p2, t2, p1 * t1)
    else:
        h1 = d * d + e11sq4
        h4 = fma(p1, t1, p2 * t2)
    h5 = fma((4 * eta11) * a, b, d * fma(a, a, -b2))
    return torch.stack([h0, h1, h2, h3, h4, h5], dim=1)


def log_hu(hu: torch.Tensor) -> torch.Tensor:
    """Sign-stable log10 transform.  A subnormal Hu value counts as 0, as
    XLA's CPU code flushes subnormal results to zero: PyTorch keeps them,
    and -sign(h) * log10(tiny) would then give ±37.9 where the reference
    gives 0 (a Hu moment that cancels to within 1e-38)."""
    tiny = torch.finfo(hu.dtype).tiny
    hu = torch.where(hu.abs() < tiny, torch.zeros_like(hu), hu)
    abs_hu = torch.clamp(hu.abs(), min=tiny)
    out = -torch.sign(hu) * log10(abs_hu)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def hu_2d(images: torch.Tensor, looped: bool = False) -> torch.Tensor:
    return hu_moments(normalized_moments(images, looped))


def hu_3d(volumes: torch.Tensor, looped: bool = False) -> torch.Tensor:
    """(N, Z, Y, X) -> (N, 18): Hu of the three orthogonal max projections."""
    return torch.cat([hu_moments(normalized_moments(volumes.amax(dim=axis), looped),
                                 projections=True)
                      for axis in (1, 2, 3)], dim=1)


def hu_features_plain(cubes: torch.Tensor, looped: bool = False) -> torch.Tensor:
    """:func:`hu_features` in plain torch: ``log_hu(hu_2d(cubes))`` of
    (N, H, W) ROIs or ``log_hu(hu_3d(cubes))`` of (N, Z, Y, X) ones."""
    cubes = cubes.float()
    return log_hu(hu_3d(cubes, looped) if cubes.dim() == 4 else hu_2d(cubes, looped))


class _HuFeaturesKernel(CountedKernel):
    """The compiled log-Hu features (``csrc/hu_features.cu``), built once
    per process, with a launch count, a count of the CUDA kernels launched
    and the last call's ``last_stats`` (CUDA kernels, host reads)."""

    source = "hu_features.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def bind(self, lib):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hu_features.argtypes = [ptr, i64, i32, i32, i32, i32, ptr,
                                    ctypes.POINTER(ctypes.c_int), ptr]
        lib.hu_features.restype = ctypes.c_int

    def __call__(self, cubes: torch.Tensor, looped: bool = False) -> torch.Tensor:
        """(N, 18) float32 of (N, Z, Y, X) ROIs or (N, 6) of (N, H, W) ones
        on a CUDA device, by one launch and no host read (other float types
        are first copied to float32)."""
        if cubes.device.type != "cuda" or cubes.dim() not in (3, 4) or \
                not cubes.dtype.is_floating_point or min(cubes.shape[1:], default=0) < 1:
            raise TypeError(f"hu_features takes floating-point (N, H, W) or (N, Z, Y, X) CUDA "
                            f"ROIs, not {cubes.dtype} {tuple(cubes.shape)} on {cubes.device}")
        dev = cubes.device
        n = cubes.shape[0]
        nz = cubes.shape[1] if cubes.dim() == 4 else 0
        ny, nx = cubes.shape[-2:]
        lib = self._lib or self.build()
        with self.on_device(dev):
            flat = cubes.float().contiguous()
            out = torch.empty(n, 18 if nz else 6, dtype=torch.float32, device=dev)
            kernels = ctypes.c_int(0)
            err = lib.hu_features(flat.data_ptr(), n, nz, ny, nx, int(bool(looped)),
                                  out.data_ptr(), ctypes.byref(kernels),
                                  torch.cuda.current_stream(dev).cuda_stream)
            check_error("hu_features launch", err)
            self.count_call(kernels.value, host_reads=0)
            return out


HU_FEATURES_KERNEL = _HuFeaturesKernel()


def hu_features(cubes: torch.Tensor, looped: bool = False) -> torch.Tensor:
    """The tracker's log-Hu features of a chunk of ROIs: (N, 6) of (N, H, W)
    ROIs, (N, 18) of (N, Z, Y, X) ones (the three max projections), rounded
    as the reference's program over one chunk or, ``looped``, over several
    (:mod:`moments`' module notes).  A CUDA tensor goes to the hand-written
    kernel (or it raises), a CPU tensor to :func:`hu_features_plain`."""
    if on_card(cubes, "hu_features"):
        return HU_FEATURES_KERNEL(cubes, looped)
    return hu_features_plain(cubes, looped)


def masked_mean_variance_plain(images: torch.Tensor) -> torch.Tensor:
    """:func:`masked_mean_variance` in plain torch.

    The variance cancels most of its digits, so the sums are taken in the
    reference's order: XLA's CPU reduction adds the voxels one by one in
    raster order (the squares with fused multiply-adds).  Each step adds
    float64 terms into float32 sums, which rounds once as XLA does, and
    subnormal results are flushed as XLA's CPU code flushes them (the
    voxels are intensities, never negative).  That code also reads a
    subnormal voxel as zero (denormals are zero): it neither counts nor
    adds."""
    n = images.shape[0]
    flat = images.reshape(n, -1).float()
    flat = torch.where(flat.abs() < _TINY, torch.zeros_like(flat), flat)
    count = (flat != 0).sum(dim=1)
    safe = torch.where(count == 0, torch.ones_like(count), count).float()
    sums = torch.zeros(n, 2, dtype=torch.float32, device=images.device)
    for start in range(0, flat.shape[1], _VOXEL_BLOCK):
        wide = flat[:, start:start + _VOXEL_BLOCK].T.double()
        terms = torch.stack([wide, wide * wide], dim=2)   # (voxels, N, 2)
        # XLA flushes a subnormal sum to zero: a sum of non-negative terms
        # stays 0 until a term reaches the smallest normal, and is normal
        # from then on, so the terms before that one are dropped
        normal = torch.cummax((terms.float() >= _TINY).int(), dim=0).values.bool()
        terms = torch.where(normal | (sums != 0), terms, torch.zeros_like(terms))
        for k in range(terms.shape[0]):
            sums.add_(terms[k])
    total, total_sq = sums[:, 0], sums[:, 1]
    mean = flush(total / safe)
    var = flush(flush(total_sq - flush(flush(total ** 2) / safe)) / safe)
    zero = count == 0
    mean = torch.where(zero, torch.zeros_like(mean), mean)
    var = torch.where(zero, torch.zeros_like(var), var)
    return torch.stack([mean, var], dim=1)


class _RoiStatsKernel(CountedKernel):
    """The compiled ROI statistics (``csrc/roi_stats.cu``), built once per
    process, with a launch count and a count of the CUDA kernels
    launched."""

    source = "roi_stats.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def bind(self, lib):
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.roi_stats.argtypes = [ptr, i64, i64, ptr, ctypes.POINTER(ctypes.c_int), ptr]
        lib.roi_stats.restype = ctypes.c_int
        lib.roi_chain_floor.argtypes = [ptr, i64, ptr, ptr]
        lib.roi_chain_floor.restype = ctypes.c_int

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 2) float32 by one C call; images (N, ...) on a CUDA device
        (other float types than float32 are first copied to it)."""
        if images.device.type != "cuda" or images.dim() < 1 or \
                not images.dtype.is_floating_point:
            raise TypeError(f"masked_mean_variance takes a floating-point CUDA tensor of at "
                            f"least one axis, not {images.dtype} on {images.device}")
        dev = images.device
        n = images.shape[0]
        lib = self._lib or self.build()
        with self.on_device(dev):
            flat = images.reshape(n, -1).float().contiguous()
            out = torch.empty(n, 2, dtype=torch.float32, device=dev)
            kernels = ctypes.c_int(0)
            err = lib.roi_stats(flat.data_ptr(), n, flat.shape[1], out.data_ptr(),
                                ctypes.byref(kernels), torch.cuda.current_stream().cuda_stream)
            check_error("roi_stats launch", err)
            self.count_call(kernels.value)
            return out

    def chain_floor(self, roi: torch.Tensor) -> torch.Tensor:
        """The float32 sum of squares of one ROI's voxels (a CUDA tensor,
        at most 12,288 of them) by one thread out of shared memory: the
        chain of dependent steps that bounds the kernel, run alone so that
        it can be timed.  Not a launch of the ROI statistics."""
        if roi.device.type != "cuda" or roi.dtype != torch.float32:
            raise TypeError(f"chain_floor takes a float32 CUDA tensor, not {roi.dtype} on "
                            f"{roi.device}")
        lib = self._lib or self.build()
        with self.on_device(roi.device):
            flat = roi.reshape(-1).contiguous()
            out = torch.empty(1, dtype=torch.float32, device=roi.device)
            check_error("roi_chain_floor launch",
                        lib.roi_chain_floor(flat.data_ptr(), flat.numel(), out.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream))
            return out[0]


ROI_STATS_KERNEL = _RoiStatsKernel()


def masked_mean_variance(images: torch.Tensor) -> torch.Tensor:
    """[mean, variance] of the nonzero voxels of each image, (N, 2), with
    the reference's order of sums and its flushes of subnormal results
    (:func:`masked_mean_variance_plain`).  A CUDA tensor goes to the
    hand-written kernel (or it raises), a CPU tensor to the plain body."""
    if on_card(images, "masked_mean_variance"):
        return ROI_STATS_KERNEL(images)
    return masked_mean_variance_plain(images)
