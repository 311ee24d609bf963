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
import functools
import math
import os
import re
import threading
from typing import Sequence

import numpy as np
import torch

from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CSRC, CudaKernel, check_error, on_card
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


def shared_products(n: int, taps, last_axis: bool = False):
    """Which taps' products XLA's CPU code computes once for two taps.

    A correlation with constant weights is one fused loop; where two taps
    of one output position read the same element (possible only where the
    reflected taps reach past the axis's far end) with weights of the same
    magnitude, LLVM computes their product once, and a product with two
    uses is never contracted into a fused multiply-add.  Along a last axis
    of 2 points the loop over a line is unrolled, so a product is shared
    between the two outputs too.  Returns the (n, len(taps)) bool table of
    such taps for an axis of ``n`` points and ``taps`` as (input offset,
    float32 weight), or None where no position has one; read only."""
    return _shared_products(int(n), tuple((int(o), float(w)) for o, w in taps), bool(last_axis))


@functools.lru_cache(maxsize=256)  # the same axes and taps recur every frame
def _shared_products(n: int, taps: tuple, last_axis: bool):
    offsets = np.array([o for o, _ in taps])
    magnitude = np.abs(np.array([w for _, w in taps], np.float32))
    m = np.remainder(np.arange(n)[:, None] + offsets[None, :], 2 * n)
    source = np.where(m < n, m, 2 * n - 1 - m)
    key = source * len(taps) + np.unique(magnitude, return_inverse=True)[1][None, :]
    if last_axis and n <= 2:
        _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
        shared = counts[inverse.reshape(key.shape)] > 1
    else:
        shared = (key[:, :, None] == key[:, None, :]).sum(axis=2) > 1
    return shared if shared.any() else None


def _tap_chain(reads, weights, shared=None) -> torch.Tensor:
    """``sum(read_k * w_k)`` in XLA's order: the left product of the first
    add contracted, then a fused multiply-add a tap; a product flagged in
    ``shared`` is rounded and added (and for the first add the other one
    is contracted, or neither)."""
    if len(reads) == 1:
        return reads[0] * weights[0]
    shared = [False] * len(reads) if shared is None else list(shared)
    if shared[0] and shared[1]:
        out = reads[0] * weights[0] + reads[1] * weights[1]
    elif shared[0]:
        out = fma(reads[1], weights[1], reads[0] * weights[0])
    else:
        out = fma(reads[0], weights[0], reads[1] * weights[1])
    for r, w, sh in zip(reads[2:], weights[2:], shared[2:]):
        out = out + r * w if sh else fma(r, w, out)
    return out


def _correlate1d_plain(x: torch.Tensor, weights: np.ndarray, axis: int, tap_shared=None,
                       centre: torch.Tensor = None, edge: torch.Tensor = None) -> torch.Tensor:
    """Correlate along ``axis`` with scipy 'reflect' edges; zero taps
    skipped; products shared as :func:`shared_products` finds them, and at
    every position those of the nonzero taps flagged in ``tap_shared``; the
    centre tap reads ``centre`` in place of ``x`` where given, and a tap
    whose index falls outside the axis reads ``edge`` (reflected) in place
    of ``x`` where given."""
    radius = len(weights) // 2
    if radius == 0:
        return (x if centre is None else centre) * f32(weights[0])
    xp = pad_symmetric(x, axis, radius, radius)
    if edge is not None:
        ep = pad_symmetric(edge, axis, radius, radius)
        n_pad = xp.shape[axis]
        xp = torch.cat([ep.narrow(axis, 0, radius), x,
                        ep.narrow(axis, n_pad - radius, radius)], dim=axis)
    n = x.shape[axis]
    terms = [(k, f32(w)) for k, w in enumerate(weights) if float(w) != 0.0]
    if not terms:
        return torch.zeros_like(x)
    ws = [w for _, w in terms]

    def read(k, start, length):
        if k == radius and centre is not None:
            return centre.narrow(axis, start, length)
        return xp.narrow(axis, start + k, length)

    out = _tap_chain([read(k, 0, n) for k, _ in terms], ws, tap_shared)
    shared = shared_products(n, [(k - radius, w) for k, w in terms], axis % x.ndim == x.ndim - 1)
    if shared is not None:
        if tap_shared is not None:
            shared = shared | np.asarray(tap_shared, bool)[None, :]
        for i in np.flatnonzero(shared.any(axis=1)):
            i = int(i)
            out.narrow(axis, i, 1).copy_(_tap_chain([read(k, i, 1) for k, _ in terms], ws,
                                                    shared[i]))
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


@functools.lru_cache(maxsize=512)  # a frame's passes repeat the same few tap lists
def _tap_plan(taps: tuple):
    """(count, C offsets, C weights, reach) of the kernel's taps, built once
    a tap list; raises on what the kernel does not take."""
    count = len(taps)
    if not 1 <= count <= _GaussAxisKernel.max_taps:
        raise ValueError(f"gauss_axis takes 1 to {_GaussAxisKernel.max_taps} taps, not {count}")
    reach = max(abs(int(o)) for o, _ in taps)
    if reach > _GaussAxisKernel.max_reach:
        raise ValueError(f"gauss_axis taps reach at most {_GaussAxisKernel.max_reach} voxels")
    return (count, (ctypes.c_int * count)(*(int(o) for o, _ in taps)),
            (ctypes.c_float * count)(*(float(w) for _, w in taps)), reach)


def pack_flags(table: np.ndarray) -> np.ndarray:
    """An (n, count) bool table of flagged taps as the kernel reads it: per
    position ceil(count / 32) 32-bit words, tap k at bit k % 32 of word
    k // 32 (int32 words)."""
    n, count = table.shape
    words = (count + 31) // 32
    bits = np.zeros((n, words * 32), np.uint64)
    bits[:, :count] = table
    packed = (bits.reshape(n, words, 32) << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return packed.astype(np.uint32).view(np.int32)


def flag_table(n: int, taps, last_axis: bool, tap_flags=None, device="cpu"):
    """The kernel's flag table of one pass, on ``device``: the taps whose
    products are computed once at each position, :func:`shared_products`
    or'd with the flags ``tap_flags`` sets at every position, packed by
    :func:`pack_flags`; None where no tap is flagged.  Cached by (n, taps,
    last axis, tap flags, device), so the passes of every frame after the
    first copy nothing to the card; read only."""
    flags = None if tap_flags is None or not any(tap_flags) else \
        tuple(bool(f) for f in tap_flags)
    return _flag_table(int(n), tuple(taps), bool(last_axis), flags, torch.device(device))


@functools.lru_cache(maxsize=512)
def _flag_table(n: int, taps: tuple, last_axis: bool, tap_flags, device):
    shared = shared_products(n, taps, last_axis)
    if tap_flags is not None:
        flags = np.broadcast_to(np.asarray(tap_flags, bool), (n, len(taps)))
        shared = flags if shared is None else shared | flags
    if shared is None:
        return None
    return torch.from_numpy(pack_flags(np.asarray(shared, bool))).to(device)


def _unrolled_counts() -> tuple:
    """The tap counts that ``csrc/gauss_axis.cu`` unrolls in instances of
    their own (for taps at offsets -r..r), read from its ``GAUSS_COUNTS``
    list, the one place they are written."""
    with open(os.path.join(CSRC, "gauss_axis.cu")) as f:
        listed = re.search(r"^#define GAUSS_COUNTS\(X\)(.*)$", f.read(), re.MULTILINE).group(1)
    return tuple(int(c) for c in re.findall(r"X\((\d+)\)", listed))


GAUSS_UNROLLED_COUNTS = _unrolled_counts()


class _GaussAxisKernel(CudaKernel):
    """The compiled 1-D correlation (``csrc/gauss_axis.cu``), built once per
    process, with a launch count; :attr:`last_used` is what the calling
    thread's last launch took, as the kernel reports it."""

    source = "gauss_axis.cu"
    flags = (*BASE_FLAGS, "-fmad=false")
    max_taps = 256
    max_reach = 128  # the largest |offset|: the kernel's largest tile margin

    def __init__(self):
        super().__init__()
        self._used = threading.local()

    def bind(self, lib):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gauss_axis.argtypes = [ptr, ptr, i64, i64, i64, i32, ptr, ptr, i32, i32, ptr, i32,
                                   ptr, ptr, ctypes.POINTER(i32), ptr]
        lib.gauss_axis.restype = i32

    @property
    def last_used(self):
        """(unrolled tap count, bytes a copy) of this thread's last launch:
        the count of the instance it took (0: the run-time loop) and its
        tiles' copy width (16 or 4); None before the first."""
        return getattr(self._used, "value", None)

    def __call__(self, x: torch.Tensor, taps, axis: int, round_half: bool = False,
                 shared=None, centre: torch.Tensor = None,
                 edge: torch.Tensor = None) -> torch.Tensor:
        """The correlation of the float32 CUDA tensor ``x`` along ``axis``
        over ``taps``, (input offset, float32 weight) pairs in summation
        order, as a new float32 tensor (each value rounded through float16
        with ``round_half``); ``shared``: the taps whose products are
        computed once at each position, as :func:`flag_table` gives them
        on the card, or None; ``centre``: a tensor like ``x`` that the tap
        at offset 0 reads in place of ``x``, or None; ``edge``: a tensor like
        ``x`` that a tap whose index falls outside the axis reads (reflected)
        in place of ``x``, or None."""
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise TypeError(f"gauss_axis takes a float32 CUDA tensor, not {x.dtype} on {x.device}")
        count, offsets, weights, reach = _tap_plan(taps if isinstance(taps, tuple)
                                                   else tuple(taps))
        axis = axis % x.ndim
        if not x.is_contiguous():
            x = x.contiguous()
        for name, other in (("centre", centre), ("edge", edge)):
            if other is not None and (other.shape != x.shape or other.device != x.device or
                                      other.dtype != torch.float32):
                raise ValueError(f"gauss_axis: the {name} tensor must be float32 like x")
        centre = None if centre is None else centre.contiguous()
        edge = None if edge is None else edge.contiguous()
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        n = x.shape[axis]
        words = (count + 31) // 32
        if shared is not None and (shared.shape != (n, words) or shared.dtype != torch.int32
                                   or shared.device != x.device):
            raise ValueError(f"gauss_axis: flags of {tuple(shared.shape)} {shared.dtype} on "
                             f"{shared.device}, not ({n}, {words}) int32 on {x.device}")
        lib = self._lib or self.build()
        used = (ctypes.c_int * 2)()
        with self.on_device(x.device):
            err = lib.gauss_axis(x.data_ptr(), out.data_ptr(), x.numel(), n,
                                 math.prod(x.shape[axis + 1:]), count, offsets, weights, reach,
                                 int(bool(round_half)),
                                 None if shared is None else shared.data_ptr(), words,
                                 None if centre is None else centre.data_ptr(),
                                 None if edge is None else edge.data_ptr(), used,
                                 torch.cuda.current_stream().cuda_stream)
        check_error("gauss_axis launch", err)
        self._used.value = (used[0], used[1])
        self.count_launch()
        return out


GAUSS_AXIS_KERNEL = _GaussAxisKernel()


def nonzero_taps(weights: np.ndarray):
    """The kernel's taps for :func:`_correlate1d_plain`: (input offset,
    float32 weight) of each nonzero weight in order, the one weight where
    there is no other; empty where every weight is 0."""
    return list(_weights_taps(np.asarray(weights).tobytes(), np.asarray(weights).dtype.str,
                              False))


def traced_taps(weights: np.ndarray):
    """The kernel's taps for :func:`correlate1d_traced_plain`: every weight,
    zeros included, as (input offset, float32 weight)."""
    return list(_weights_taps(np.asarray(weights).tobytes(), np.asarray(weights).dtype.str,
                              True))


@functools.lru_cache(maxsize=512)  # the same weights recur every frame
def _weights_taps(raw: bytes, dtype: str, traced: bool) -> tuple:
    weights = np.frombuffer(raw, dtype=np.dtype(dtype))
    radius = len(weights) // 2
    if traced:
        return tuple((k - radius, f32(w)) for k, w in enumerate(weights.astype(np.float32)))
    if radius == 0:
        return ((0, f32(weights[0])),)
    return tuple((k - radius, f32(w)) for k, w in enumerate(weights) if float(w) != 0.0)


def _correlate1d(x: torch.Tensor, weights: np.ndarray, axis: int, tap_shared=None,
                 centre: torch.Tensor = None, edge: torch.Tensor = None) -> torch.Tensor:
    """Correlate along ``axis`` with scipy 'reflect' edges; zero taps
    skipped: ``csrc/gauss_axis.cu`` on a CUDA tensor, or
    :func:`_correlate1d_plain` (``tap_shared``, ``centre`` and ``edge`` as
    there)."""
    if not on_card(x, "_correlate1d"):
        return _correlate1d_plain(x, weights, axis, tap_shared, centre, edge)
    weights = np.asarray(weights)
    taps = _weights_taps(weights.tobytes(), weights.dtype.str, False)
    if not taps:
        return torch.zeros_like(x)
    axis = axis % x.ndim
    flags = flag_table(x.shape[axis], taps, axis == x.ndim - 1, tap_shared, x.device)
    if centre is not None and not any(o == 0 for o, _ in taps):
        centre = None
    return GAUSS_AXIS_KERNEL(x, taps, axis, shared=flags, centre=centre, edge=edge)


def correlate1d_traced(x: torch.Tensor, weights: np.ndarray, axis: int,
                       carry: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`correlate1d_traced_plain` of float32 ``x``, each result rounded
    to ``carry`` (float32 or float16) and returned as float32:
    ``csrc/gauss_axis.cu`` on a CUDA tensor, or the plain version."""
    half = carry == torch.float16
    if not on_card(x, "correlate1d_traced"):
        out = correlate1d_traced_plain(x, weights, axis)
        return out.to(carry).float() if half else out
    weights = np.asarray(weights)
    return GAUSS_AXIS_KERNEL(x, _weights_taps(weights.tobytes(), weights.dtype.str, True), axis,
                             round_half=half)


def gaussian_laplace(x: torch.Tensor, sigma: Sequence[float], truncate: float = 4.0) -> torch.Tensor:
    """Sum over axes of second-derivative Gaussian responses
    (``scipy.ndimage.gaussian_laplace``), rounded as the reference's
    function jitted alone rounds it (:func:`log_program`)."""
    return log_program(x, sigma, truncate)


_VECTOR_LANES = 8  # float32 lanes of XLA's CPU loops (256-bit vectors)


def _select_folds(weights: np.ndarray) -> bool:
    """Whether a sunk pass's first add takes the centre as a select whose
    other arm is -0, the add's identity: three nonzero taps and a negative
    float32 centre weight (``0 * w`` is -0 only for w < 0)."""
    taps = [float(v) for v in np.asarray(weights) if float(v) != 0.0]
    return len(taps) == 3 and f32(np.asarray(weights)[len(weights) // 2]) < 0


def log_program(x: torch.Tensor, sigma: Sequence[float], truncate: float = 4.0,
                sunk_centre: bool = False, peak: bool = False):
    """The LoG as one of XLA's CPU programs computes it.

    In 2D, and in 3D with an axis not filtered, the correlations of each
    term follow one another.  In 3D, XLA's last fusion recomputes each
    term's correlations along axes 0 and 1 inline at the output position
    itself (the centre taps), while the other taps read padded copies that
    other fusions computed.  In that fusion the order-0 and order-2
    correlations that read one input (axis 0 of the terms, and axis 1 of
    the last two terms, which share their axis-0 pass) load each element
    once, and where their weights at a tap have the same magnitude (the
    centre tap at a sigma of exactly 1) LLVM computes the product once and
    never contracts it.  So a term is: ``A`` (axis 0) and ``Y`` (axis 1
    over ``A``) as the padded copies hold them; ``A*`` and ``Y*`` as the
    last fusion computes them (``Y*``'s centre reads ``A*``); the term is
    the axis-2 correlation of ``Y`` whose centre reads ``Y*``.
    ``sunk_centre``: the input is a select that another program computes
    inline (the Markers' clamped distance), which LLVM multiplies inside the
    select where the value has one use, so ``A``'s centre product is
    rounded and added, not contracted (``A*`` reads it twice).  Where that
    centre's weight is negative in a pass of three taps, the select's other
    arm is ``0 * w = -0``, the add's identity, and on AVX-512 LLVM folds the
    select into the first add: the vector loop contracts neither product,
    the scalar loops (the padded copies' reflected rows, the last axis's
    columns past a multiple of 8) contract tap 0, and the passes that read
    ``A`` take each where XLA's code does
    (``scripts/xla_markers_machine_code.py``).  That fold is XLA's code for
    AVX-512, which the port follows; where XLA generates AVX2 code every
    loop contracts tap 0, so the reference on such a CPU differs from the
    port in these passes.

    That last fusion exists only where XLA fuses the padding of the last
    axis into it: a minor-axis concatenation (the axis and the taps'
    radius on one side) of fewer than 128 elements.  From 128 on, each
    term is the plain sequence of the axis-0 (``A``), axis-1 and axis-2
    passes, each over the whole previous pass (``A``'s centre as
    ``sunk_centre`` says); the 3D main frames (a last axis of 256) take
    that form.

    ``peak``: also return the LoG as Markers' peak fusion recomputes it at
    the voxel, as (the program's LoG, the peak fusion's).  That fusion
    computes every scale's last fusion inline and compares it with the
    maximum filter of the program's LoG; there LLVM orders the first add of
    an axis-0 order-0 pass of three taps with the centre's product (the
    voxel's own value) first, and contracts that one: ``A*``'s tap 0 is
    rounded and its centre contracted (``scripts/xla_markers_probe.py``
    lists it).  Elsewhere the two are the same tensor."""
    sigma = tuple(float(s) for s in sigma)
    if len(sigma) != x.ndim:
        raise ValueError("sigma must have one entry per axis")
    if x.ndim != 3 or min(sigma) <= 0:
        total = None
        for d2_axis in range(x.ndim):
            term = x
            for axis, s in enumerate(sigma):
                if s <= 0:
                    continue
                order = 2 if axis == d2_axis else 0
                term = _correlate1d(term, gaussian_kernel1d(s, truncate, order=order), axis)
            total = term if total is None else total + term
        return (total, total) if peak else total
    w = {(a, o): gaussian_kernel1d(sigma[a], truncate, order=o) for a in range(3) for o in (0, 2)}

    def centre_tap(o):
        return [k == len(w[(0, o)]) // 2 for k in range(len(w[(0, o)]))
                if float(w[(0, o)][k]) != 0.0]

    # axis 0: order 2 in term 0, order 0 in terms 1 and 2 (one pass); where a
    # sunk centre's select folds into the first add, the vector loop's pass
    # (a_vec) differs from the scalar loops' (a_edge: the reflected rows of
    # the padded copies, and the last axis's remainder columns)
    a_pad, a_vec, a_edge = {}, {0: None, 2: None}, {0: None, 2: None}
    tail = x.shape[2] % _VECTOR_LANES
    for o in (0, 2):
        a_pad[o] = _correlate1d(x, w[(0, o)], 0, centre_tap(o) if sunk_centre else None)
        if sunk_centre and _select_folds(w[(0, o)]):
            a_edge[o] = a_pad[o]
            a_vec[o] = _correlate1d(x, w[(0, o)], 0, [True, True, False])
            a_pad[o] = a_vec[o].clone() if tail else a_vec[o]
            a_pad[o].narrow(2, x.shape[2] - tail, tail).copy_(
                a_edge[o].narrow(2, x.shape[2] - tail, tail))
    order = [2, 0, 0]  # the axis-0 pass of each term
    y_pad = [_correlate1d(a_pad[order[t]], w[(1, 2 if t == 1 else 0)], 1, edge=a_edge[order[t]])
             for t in range(3)]
    if x.shape[2] + len(w[(2, 0)]) // 2 >= 128:  # the last axis's padding is not fused
        terms = [_correlate1d(y_pad[t], w[(2, 2 if t == 2 else 0)], 2) for t in range(3)]
        total = terms[0] + terms[1] + terms[2]
        return (total, total) if peak else total

    def twin_taps(a):
        """The taps of axis a where the order-0 and order-2 weights have the
        same float32 magnitude, in the order of each kernel's nonzero taps."""
        w0, w2 = (np.abs(w[(a, o)].astype(np.float32)) for o in (0, 2))
        twin = (w0 == w2) & (w0 != 0)
        return {o: [bool(twin[k]) for k in range(len(w[(a, o)])) if float(w[(a, o)][k]) != 0.0]
                for o in (0, 2)}

    twin0, twin1 = twin_taps(0), twin_taps(1)
    a_last = {o: _correlate1d(x, w[(0, o)], 0, twin0[o]) for o in (0, 2)}

    # the axis-1 passes' reflected columns: their centre from the vector loop
    y_edge = [None if a_edge[order[t]] is None or not tail else
              _correlate1d(a_pad[order[t]], w[(1, 2 if t == 1 else 0)], 1,
                           centre=a_vec[order[t]], edge=a_edge[order[t]]) for t in range(3)]

    def term(t, a_star):
        o1 = 2 if t == 1 else 0
        y_last = _correlate1d(a_pad[order[t]], w[(1, o1)], 1, twin1[o1] if t else None,
                              centre=a_star, edge=a_edge[order[t]])
        return _correlate1d(y_pad[t], w[(2, 2 if t == 2 else 0)], 2, centre=y_last,
                            edge=y_edge[t])

    terms = [term(t, a_last[2 if t == 0 else 0]) for t in range(3)]
    total = terms[0] + terms[1] + terms[2]
    if not peak:
        return total
    if len(nonzero_taps(w[(0, 0)])) != 3:
        return total, total
    # the peak fusion's A* of order 0 (terms 1 and 2): centre contracted, tap 0 rounded
    a_star = _correlate1d(x, w[(0, 0)], 0, [True, False, False])
    return total, terms[0] + term(1, a_star) + term(2, a_star)


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


def binary_opening_terms(masks, centre: int, side: int) -> torch.Tensor:
    """:func:`binary_opening` where the erosion's terms read the mask in
    their own forms: ``masks`` the mask's forms (say ``frame > A`` and
    ``frame > B``), ``centre`` the index of the form the unshifted term
    reads at every position of the dilation, ``side`` that of the form the
    side terms read (the mask at index ± 1 along each axis)."""
    er = masks[centre]
    for axis in range(er.ndim):
        er = er & shift_fill(masks[side], axis, 1, False) & shift_fill(masks[side], axis, -1, False)
    return binary_dilation(er, connectivity=1)
