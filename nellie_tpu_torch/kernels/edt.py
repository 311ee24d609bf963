"""Euclidean distance transform and object-constrained nearest seed.

Port of ``nellie_tpu/kernels/edt.py``:

* ``distance_transform`` (``:218``) is exact: the squared EDT factorises
  into per-axis windowed min-plus transforms (Felzenszwalb & Huttenlocher).
  On a CUDA tensor it launches the hand-written kernel
  ``csrc/edt_minplus.cu`` (one launch an axis, no host read;
  ``EDT_MINPLUS_KERNEL.launches`` counts the wrapper's calls and
  ``kernel_launches`` the CUDA kernels), or raises; on a CPU tensor it runs
  :func:`distance_transform_plain`.
* ``nearest_seed`` (``:72``) keeps the reference's jump flooding with the
  same JFA+1 step schedule, offset order and strict-``<`` updates, so that
  its rare approximate answers are the reference's too.  An exact nearest
  seed is later work (ROADMAP).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/nearest_seed.cu`` (built for ``sm_90a`` with
  ``nvcc`` on first use, bound through ``ctypes``; one persistent launch
  runs every step, with no host read), or raises; on a CPU tensor it runs
  :func:`nearest_seed_plain`.  ``NEAREST_SEED_KERNEL.launches`` counts the
  wrapper's calls and ``NEAREST_SEED_KERNEL.kernel_launches`` the CUDA
  kernels those calls launched (one a call).
"""
from __future__ import annotations

import ctypes
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CountedKernel, check_error, on_card
from nellie_tpu_torch.kernels._fp import f32, sqrt, sum_of_products
from nellie_tpu_torch.kernels.ccl import MAX_VOXELS  # int32 indices
from nellie_tpu_torch.kernels.filters import pad_constant


def _offsets(ndim: int):
    return [o for o in itertools.product((-1, 0, 1), repeat=ndim) if any(v != 0 for v in o)]


def jump_steps(shape, max_radius_px: Optional[int] = None):
    """The JFA+1 schedule: 2**(n-1), ..., 2, 1 and one more 1, with
    n = ceil(log2(max(reach, 2))), reach the longest axis or
    ``max_radius_px + 1``, the smaller."""
    reach = max(shape)
    if max_radius_px is not None:
        reach = min(reach, int(max_radius_px) + 1)
    n_steps = max(1, int(math.ceil(math.log2(max(reach, 2)))))
    return [1 << (n_steps - 1 - i) for i in range(n_steps)] + [1]


def nearest_seed_plain(
    seed_labels: torch.Tensor,
    obj_labels: Optional[torch.Tensor] = None,
    sampling: Tuple[float, ...] = None,
    max_radius_px: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nearest_seed` in plain torch: rolled copies of the state, one
    set of torch ops per step and offset."""
    shape = tuple(seed_labels.shape)
    ndim = len(shape)
    dev = seed_labels.device
    if sampling is None:
        sampling = (1.0,) * ndim
    samp = [f32(s) for s in sampling]
    steps = jump_steps(shape, max_radius_px)

    coords = [torch.arange(s, device=dev, dtype=torch.int32).reshape(
        [s if a == ax else 1 for a in range(ndim)]) for ax, s in enumerate(shape)]
    strides = [1] * ndim
    for ax in range(ndim - 2, -1, -1):
        strides[ax] = strides[ax + 1] * shape[ax + 1]
    flat_idx = sum(c * strides[ax] for ax, c in enumerate(coords)).expand(shape).to(torch.int32)

    def seed_dist(idx):
        rem = idx
        diffs = []
        for ax in range(ndim):
            if ax < ndim - 1:
                q = torch.div(rem, strides[ax], rounding_mode="floor")
                rem = rem - q * strides[ax]
            else:
                q = rem
            diff = (coords[ax] - q).float() * samp[ax]
            diffs.append((diff, diff))
        d = sum_of_products(diffs)
        return torch.where(idx >= 0, d, float("inf"))

    is_seed = seed_labels > 0
    idx = torch.where(is_seed, flat_idx, -1).to(torch.int32)
    has_obj = obj_labels is not None
    if has_obj:
        my_obj = obj_labels.to(torch.int32)
        obj = torch.where(is_seed, my_obj, -1).to(torch.int32)

    for step in steps:
        cur_d = seed_dist(idx)
        for off in _offsets(ndim):
            shifts = tuple(-o * step for o in off)
            cand_idx = torch.roll(idx, shifts=shifts, dims=tuple(range(ndim)))
            src_ok = torch.ones(shape, dtype=torch.bool, device=dev)
            for axis, o in enumerate(off):
                if o != 0:
                    src = coords[axis] + o * step
                    src_ok = src_ok & (src >= 0) & (src < shape[axis])
            valid = src_ok & (cand_idx >= 0)
            if has_obj:
                cand_obj = torch.roll(obj, shifts=shifts, dims=tuple(range(ndim)))
                valid = valid & (cand_obj == my_obj)
            cand_d = torch.where(valid, seed_dist(cand_idx), float("inf"))
            take = cand_d < cur_d
            idx = torch.where(take, cand_idx, idx)
            if has_obj:
                obj = torch.where(take, cand_obj, obj)
            cur_d = torch.where(take, cand_d, cur_d)

    return _seed_values(seed_labels, idx), sqrt(seed_dist(idx))


def _seed_values(seed_labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each voxel's seed value at flat index ``idx``, 0 where ``idx < 0``."""
    idx = idx.reshape(seed_labels.shape)
    return torch.where(idx >= 0, seed_labels.reshape(-1)[torch.clamp(idx, min=0).long()], 0)


class _NearestSeedKernel(CountedKernel):
    """The compiled jump flooding (``csrc/nearest_seed.cu``), built once per
    process, with a launch count, a count of the CUDA kernels launched and
    the last call's ``last_stats`` (CUDA kernels, host reads, grid blocks)."""

    source = "nearest_seed.cu"
    flags = (*BASE_FLAGS, "-fmad=false")
    max_voxels = MAX_VOXELS  # int32 voxel indices

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nearest_seed_scratch.argtypes = [i32]
        lib.nearest_seed_scratch.restype = ctypes.c_longlong
        lib.nearest_seed.argtypes = [ptr, ptr, i32, ctypes.POINTER(i32),
                                     ctypes.POINTER(ctypes.c_float), ctypes.POINTER(i32), i32,
                                     ptr, ptr, ptr, ctypes.POINTER(ctypes.c_longlong), ptr]
        lib.nearest_seed.restype = i32

    def __call__(self, seed_labels, obj_labels=None, sampling=None, max_radius_px=None):
        """(int32 labels, float32 distances) by one C call; ``seed_labels``
        int32 (the kernel reads and returns seed values as int32)."""
        shape = tuple(seed_labels.shape)
        ndim = len(shape)
        if seed_labels.device.type != "cuda" or not 1 <= ndim <= 3 or \
                seed_labels.dtype != torch.int32:
            raise TypeError(f"nearest_seed takes an int32 CUDA tensor of 1 to 3 axes, not "
                            f"{ndim} axes of {seed_labels.dtype} on {seed_labels.device}")
        if obj_labels is not None and (obj_labels.shape != seed_labels.shape
                                       or obj_labels.device != seed_labels.device):
            raise ValueError("nearest_seed: obj_labels must match seed_labels' shape and device")
        n = seed_labels.numel()
        if n > self.max_voxels:
            raise ValueError(f"{n} voxels: the nearest-seed kernel takes at most "
                             f"{self.max_voxels}")
        dev = seed_labels.device
        if sampling is None:
            sampling = (1.0,) * ndim
        if n == 0:
            return (torch.zeros_like(seed_labels),
                    torch.empty(shape, dtype=torch.float32, device=dev))
        steps = jump_steps(shape, max_radius_px)
        lib = self._lib or self.build()
        with self.on_device(dev):
            seeds = seed_labels.contiguous()
            obj = None if obj_labels is None else obj_labels.to(torch.int32).contiguous()
            labels = torch.empty(shape, dtype=torch.int32, device=dev)
            dist = torch.empty(shape, dtype=torch.float32, device=dev)
            words = lib.nearest_seed_scratch(n)
            if words < 0:
                raise RuntimeError("nearest_seed: the device takes no cooperative launch")
            scratch = torch.empty(words, dtype=torch.int32, device=dev)
            stats = (ctypes.c_longlong * 3)()
            err = lib.nearest_seed(
                seeds.data_ptr(), None if obj is None else obj.data_ptr(), ndim,
                (ctypes.c_int * 3)(*shape), (ctypes.c_float * 3)(*(f32(s) for s in sampling)),
                (ctypes.c_int * len(steps))(*steps), len(steps), scratch.data_ptr(),
                labels.data_ptr(), dist.data_ptr(), stats,
                torch.cuda.current_stream().cuda_stream)
            check_error("nearest_seed launch", err)
            self.count_call(stats[0], host_reads=stats[1], blocks=stats[2])
            return labels, dist


NEAREST_SEED_KERNEL = _NearestSeedKernel()


def nearest_seed(
    seed_labels: torch.Tensor,
    obj_labels: Optional[torch.Tensor] = None,
    sampling: Tuple[float, ...] = None,
    max_radius_px: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel nearest seed by JFA+1.

    Returns (labels, distances): the nearest seed's value (0 where none is
    reachable) and the physical distance to it (+inf where none).  With
    ``obj_labels`` a voxel only accepts seeds of its own object.  A CUDA
    tensor goes to the hand-written kernel, which takes int32 seeds (or
    raises), a CPU tensor of any type to :func:`nearest_seed_plain`."""
    if on_card(seed_labels, "nearest_seed"):
        return NEAREST_SEED_KERNEL(seed_labels, obj_labels, sampling, max_radius_px)
    return nearest_seed_plain(seed_labels, obj_labels, sampling, max_radius_px)


def window_radii(shape, max_radius_px: Optional[int] = None):
    """Each axis's half window: ``n - 1``, clamped to ``max_radius_px``."""
    if max_radius_px is None:
        return [n - 1 for n in shape]
    return [min(n - 1, int(max_radius_px)) for n in shape]


# the reference unrolls a window of at most this many offsets, its costs
# constants computed in float64 and rounded once; a wider window runs a
# loop whose cost (f32(d) * f32(s))^2 XLA computes as f32(d^2) * f32(s^2)
_UNROLL_MAX = 128


def window_costs(radius: int, s: float):
    """The costs for d = 0..radius as the reference adds them:
    ``f32((d * s)^2)`` (float64, then rounded) in a window of at most
    ``_UNROLL_MAX`` offsets, else ``f32(d^2) * f32(f32(s)^2)`` rounded in
    float32; the kernel takes them as a table."""
    if 2 * radius + 1 <= _UNROLL_MAX:
        return [f32((d * s) ** 2) for d in range(radius + 1)]
    s2 = np.float32(s) * np.float32(s)
    return [float(np.float32(d * d) * s2) for d in range(radius + 1)]


def _minplus_axis(f_sq: torch.Tensor, axis: int, radius: int, s: float) -> torch.Tensor:
    """out[i] = min_{|k|<=radius} f_sq[i+k] + (k*s)^2, out of bounds = +inf."""
    n = f_sq.shape[axis]
    fp = pad_constant(f_sq, axis, radius, radius, float("inf"))
    costs = window_costs(radius, s)
    out = None
    for k in range(2 * radius + 1):
        cand = fp.narrow(axis, k, n) + costs[abs(k - radius)]
        out = cand if out is None else torch.minimum(out, cand)
    return out


def distance_transform_plain(mask: torch.Tensor, sampling: Tuple[float, ...] = None,
                             max_radius_px: Optional[int] = None) -> torch.Tensor:
    """:func:`distance_transform` in plain torch: one narrow, add and
    minimum a window offset an axis."""
    ndim = mask.ndim
    if sampling is None:
        sampling = (1.0,) * ndim
    f = torch.where(mask, float("inf"), 0.0).float()
    for axis, r in enumerate(window_radii(mask.shape, max_radius_px)):
        f = _minplus_axis(f, axis, r, float(sampling[axis]))
    dist = torch.nan_to_num(sqrt(f), posinf=float(max(mask.shape)))
    return torch.where(mask, dist, torch.zeros_like(dist))


class _EdtMinplusKernel(CountedKernel):
    """The compiled min-plus passes (``csrc/edt_minplus.cu``), built once
    per process, with a launch count, a count of the CUDA kernels launched
    and the last call's ``last_stats`` (CUDA kernels, host reads).  The
    cost tables are copied to each device once, from pinned memory with no
    wait, and kept by (device, radius, spacing)."""

    source = "edt_minplus.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def __init__(self):
        super().__init__()
        self._costs = {}  # (device index, radius, spacing): float32 table on that device

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.edt_minplus.argtypes = [ptr, i32, ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.POINTER(i32), ctypes.POINTER(ptr), ptr, ptr,
                                    ctypes.POINTER(i32), ptr]
        lib.edt_minplus.restype = i32

    def costs(self, dev, radius: int, s: float) -> torch.Tensor:
        key = (dev.index, radius, s)
        with self._lock:
            table = self._costs.get(key)
            if table is None:
                host = torch.tensor(window_costs(radius, s), dtype=torch.float32).pin_memory()
                table = self._costs[key] = host.to(dev, non_blocking=True)
            return table

    def __call__(self, mask: torch.Tensor, sampling=None, max_radius_px=None) -> torch.Tensor:
        """The distances (float32, on ``mask``'s device) by one C call, one
        launch an axis, with no host read; ``mask`` a bool CUDA tensor of 1
        to 3 axes."""
        ndim = mask.ndim
        if mask.device.type != "cuda" or not 1 <= ndim <= 3 or mask.dtype != torch.bool:
            raise TypeError(f"edt_minplus takes a bool CUDA tensor of 1 to 3 axes, not {ndim} "
                            f"axes of {mask.dtype} on {mask.device}")
        if mask.numel() > MAX_VOXELS:
            raise ValueError(f"{mask.numel()} voxels: the EDT kernel takes at most {MAX_VOXELS}")
        dev = mask.device
        if sampling is None:
            sampling = (1.0,) * ndim
        out = torch.empty(mask.shape, dtype=torch.float32, device=dev)
        if mask.numel() == 0:
            return out
        lib = self._lib or self.build()
        with self.on_device(dev):
            radii = window_radii(mask.shape, max_radius_px)
            tables = [self.costs(dev, r, float(s)) for r, s in zip(radii, sampling)]
            src = mask.contiguous()
            work = torch.empty_like(out) if ndim > 1 else out
            kernels = ctypes.c_int(0)
            err = lib.edt_minplus(
                src.data_ptr(), ndim, (ctypes.c_longlong * ndim)(*mask.shape),
                (ctypes.c_int * ndim)(*radii),
                (ctypes.c_void_p * ndim)(*(t.data_ptr() for t in tables)), work.data_ptr(),
                out.data_ptr(), ctypes.byref(kernels), torch.cuda.current_stream(dev).cuda_stream)
            check_error("edt_minplus launch", err)
            self.count_call(kernels.value, host_reads=0)
        return out


EDT_MINPLUS_KERNEL = _EdtMinplusKernel()


def distance_transform(mask: torch.Tensor, sampling: Tuple[float, ...] = None,
                       max_radius_px: Optional[int] = None) -> torch.Tensor:
    """Distance from each True voxel to the nearest False voxel
    (``scipy.ndimage.distance_transform_edt``); exact within
    ``max_radius_px``, an over-estimate only beyond it.  A CUDA tensor goes
    to the hand-written kernel, which takes a bool mask (or raises), a CPU
    tensor to :func:`distance_transform_plain`."""
    if on_card(mask, "distance_transform"):
        return EDT_MINPLUS_KERNEL(mask, sampling, max_radius_px)
    return distance_transform_plain(mask, sampling, max_radius_px)
