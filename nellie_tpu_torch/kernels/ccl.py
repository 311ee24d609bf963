"""Connected components, hole filling and the small-component filter.

Port of what ``nellie_tpu/kernels/ccl.py`` computes, not how: the TPU
build avoids gathers (segmented scans, stencil hop chains, sort-based
finishers, ``_hop_chain``/``_stencil_hops``/scan encodings at ``:57-160``).
Every component's root is its minimum linear index, and ranking those
roots gives scipy's raster-order numbering exactly.

:func:`union_find_roots`, through which every caller goes, launches the
hand-written CUDA kernel ``csrc/ccl_union_find.cu`` (a block-based
union-find: runs and unions inside 32-voxel-wide tiles in shared memory,
lock-free ``atomicMin`` unions across tiles; built for ``sm_90a`` with
``nvcc`` on first use, bound through ``ctypes``) on a CUDA tensor, or raises; on a CPU tensor it runs
:func:`union_find_roots_plain`, where every voxel starts with its own
linear index and each round takes the minimum over the neighbourhood (26-
or 6-connected, foreground only) and then jumps pointers
(``label = label[label]``), until nothing changes.  ``CCL_KERNEL.launches``
counts the kernel's launches (one C call: local, border, flatten).
"""
from __future__ import annotations

import ctypes

import torch

from nellie_tpu_torch.kernels._cuda import CudaKernel, check_error
from nellie_tpu_torch.kernels.filters import shift_fill

_JUMPS_PER_ROUND = 4
MAX_VOXELS = 2 ** 31 - 1  # the kernel's int32 indices and sentinel


def _neighbor_min(lbl: torch.Tensor, fg: torch.Tensor, sentinel: int, connectivity: str):
    m = torch.where(fg, lbl, sentinel)
    if connectivity == "full":
        # the 3^3 box min is separable; every foreground value inside a box is
        # 26-adjacent to its centre, so the box min is the 26-neighbour min
        for axis in range(m.ndim):
            m = torch.minimum(m, torch.minimum(shift_fill(m, axis, 1, sentinel),
                                               shift_fill(m, axis, -1, sentinel)))
    else:
        base = m
        for axis in range(m.ndim):
            m = torch.minimum(m, torch.minimum(shift_fill(base, axis, 1, sentinel),
                                               shift_fill(base, axis, -1, sentinel)))
    return torch.where(fg, m, sentinel)


def union_find_roots_plain(mask: torch.Tensor, connectivity: str = "full") -> torch.Tensor:
    """:func:`union_find_roots` by min propagation and pointer jumping, in
    plain torch."""
    n = mask.numel()
    fg = mask.bool()
    lbl = torch.where(fg, torch.arange(n, device=mask.device).reshape(mask.shape), n)
    while True:
        new = _neighbor_min(lbl, fg, n, connectivity).reshape(-1)
        ext = torch.cat([new, new.new_full((1,), n)])
        for _ in range(_JUMPS_PER_ROUND):
            new = ext[new]
            ext[:n] = new
        new = new.reshape(mask.shape)
        if torch.equal(new, lbl):
            return lbl.reshape(-1)
        lbl = new


class _CCLKernel(CudaKernel):
    """The compiled union-find (``csrc/ccl_union_find.cu``), built once per
    process, with a launch count."""

    source = "ccl_union_find.cu"

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ccl_union_find.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.ccl_union_find.restype = i32

    def __call__(self, mask: torch.Tensor, connectivity: str = "full") -> torch.Tensor:
        if connectivity not in ("full", "faces"):
            raise ValueError(f"connectivity {connectivity!r}: expected 'full' or 'faces'")
        if not 1 <= mask.ndim <= 3:
            raise ValueError(f"the union-find kernel takes 1 to 3 axes, not {mask.ndim}")
        n = mask.numel()
        if n > MAX_VOXELS:
            raise ValueError(f"{n} voxels: the union-find kernel's int32 indices take at most "
                             f"{MAX_VOXELS}")
        dev = mask.device
        if n == 0:
            return torch.empty(0, dtype=torch.int64, device=dev)
        lib = self._lib or self.build()
        if mask.dtype != torch.bool or not mask.is_contiguous():
            mask = mask.bool().contiguous()
        depth, height, width = (1,) * (3 - mask.ndim) + tuple(mask.shape)
        words = depth * height * (-(-width // 32))
        with self.on_device(dev):
            parent = torch.empty(n, dtype=torch.int32, device=dev)
            bits = torch.empty(words, dtype=torch.int32, device=dev)
            out = torch.empty(n, dtype=torch.int64, device=dev)
            err = lib.ccl_union_find(mask.data_ptr(), parent.data_ptr(), bits.data_ptr(),
                                     out.data_ptr(), depth, height, width,
                                     int(connectivity == "full"),
                                     torch.cuda.current_stream().cuda_stream)
        check_error("ccl_union_find launch", err)
        self.count_launch()
        return out


CCL_KERNEL = _CCLKernel()


def union_find_roots(mask: torch.Tensor, connectivity: str = "full") -> torch.Tensor:
    """Per-voxel root (the minimum linear index of its component) as a flat
    int64 tensor; ``mask.numel()`` for background.  A CUDA tensor goes to
    the hand-written kernel (or raises), a CPU tensor to
    :func:`union_find_roots_plain`."""
    if mask.device.type == "cuda":
        return CCL_KERNEL(mask, connectivity)
    if mask.device.type == "cpu":
        return union_find_roots_plain(mask, connectivity)
    raise ValueError(f"union_find_roots: unsupported device {mask.device}")


def label(mask: torch.Tensor, connectivity: str = "full"):
    """(int32 labels, number of components), numbered like
    ``scipy.ndimage.label`` with a full (or cross) structuring element."""
    n = mask.numel()
    roots = union_find_roots(mask, connectivity)
    fg = mask.reshape(-1).bool()
    is_root = fg & (roots == torch.arange(n, device=mask.device))
    rank = torch.cumsum(is_root.to(torch.int32), 0)
    labels = torch.where(fg, rank[torch.clamp(roots, max=n - 1)], 0).to(torch.int32)
    return labels.reshape(mask.shape), int(is_root.sum())


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """scipy ``binary_fill_holes`` (cross structure): background components
    that do not touch the volume border are filled."""
    bg = ~mask.bool()
    roots = union_find_roots(bg, "faces")
    n = mask.numel()
    border = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    for axis in range(mask.ndim):
        border.narrow(axis, 0, 1).fill_(True)
        border.narrow(axis, mask.shape[axis] - 1, 1).fill_(True)
    open_root = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    open_root[roots[(border & bg).reshape(-1)]] = True
    reached = open_root[roots].reshape(mask.shape) & bg
    return ~reached


def remove_small_components(mask: torch.Tensor, min_size: int,
                            connectivity: str = "full") -> torch.Tensor:
    """Drop components with fewer than ``min_size`` voxels."""
    if min_size <= 1:
        return mask
    n = mask.numel()
    roots = union_find_roots(mask, connectivity)
    sizes = torch.bincount(roots, minlength=n + 1)
    keep = mask.reshape(-1).bool() & (sizes[roots] >= min_size)
    return keep.reshape(mask.shape)
