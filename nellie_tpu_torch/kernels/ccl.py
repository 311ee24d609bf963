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

:func:`merge_cell_roots` joins the pieces of a volume labelled cell by cell
(capacity's chunked strategy): the hand-written kernel ``csrc/ccl_merge.cu``
on a CUDA tensor (a merge across every internal cell boundary, then a
flatten, in place, no host read; ``MERGE_KERNEL``), or
:func:`merge_cell_roots_plain` on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import itertools

import torch

from nellie_tpu_torch.kernels._cuda import CountedKernel, CudaKernel, check_error, on_card
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


# ---------------------------------------------------------------------------
# the cross-cell merge of capacity's chunked strategy
# ---------------------------------------------------------------------------

def internal_planes(bounds):
    """(axis, position) of every internal boundary of a cell grid given by
    its cut positions per axis."""
    return [(axis, pos) for axis, cuts in enumerate(bounds) for pos in cuts[1:-1]]


def plane_pairs(left: torch.Tensor, right: torch.Tensor, connectivity: str):
    """(a, b): the roots of every voxel pair adjacent across a boundary
    between the planes ``left`` and ``right`` (just before and at it), both
    >= 0 and different: the aligned voxels for ``faces``, every in-plane
    shift in {-1, 0, 1}^ndim for ``full``."""
    shifts = ([(0,) * left.ndim] if connectivity == "faces"
              else list(itertools.product((-1, 0, 1), repeat=left.ndim)))
    pa, pb = [], []
    for off in shifts:
        lsl = tuple(slice(max(0, -o), n - max(0, o)) for o, n in zip(off, left.shape))
        rsl = tuple(slice(max(0, o), n - max(0, -o)) for o, n in zip(off, left.shape))
        lv, rv = left[lsl].reshape(-1), right[rsl].reshape(-1)
        sel = (lv >= 0) & (rv >= 0) & (lv != rv)
        pa.append(lv[sel])
        pb.append(rv[sel])
    return torch.cat(pa), torch.cat(pb)


def _boundary_pairs(roots: torch.Tensor, planes, connectivity: str):
    """(a, b) int64: :func:`plane_pairs` over every boundary ``planes``."""
    pairs = [plane_pairs(roots.select(axis, pos - 1), roots.select(axis, pos), connectivity)
             for axis, pos in planes]
    if not pairs:
        return roots.new_empty(0, dtype=torch.int64), roots.new_empty(0, dtype=torch.int64)
    return torch.cat([a for a, _ in pairs]).long(), torch.cat([b for _, b in pairs]).long()


def merge_cell_roots_plain(roots: torch.Tensor, bounds, connectivity: str = "full"):
    """:func:`merge_cell_roots` in plain torch: until every boundary pair
    has one root, each pair's two roots' minimum goes by ``scatter_reduce``
    (``amin``) to the entry of the larger, and the piece roots jump
    pointers (``roots[roots]``) to their trees' roots; then every member
    takes its piece root's root."""
    flat = roots.view(-1)
    a, b = _boundary_pairs(roots, internal_planes(bounds), connectivity)
    if a.numel():
        nodes = torch.unique(torch.cat([a, b]))
        while True:
            while True:  # pointer jumping at the piece roots
                parent = flat[nodes]
                grand = flat[parent.long()]
                if torch.equal(grand, parent):
                    break
                flat[nodes] = grand
            ra, rb = flat[a], flat[b]
            apart = ra != rb
            if not bool(apart.any()):
                break
            lo, hi = torch.minimum(ra, rb)[apart], torch.maximum(ra, rb)[apart]
            flat.scatter_reduce_(0, hi.long(), lo, "amin")
    member = flat >= 0
    flat[member] = flat[flat[member].long()]
    return roots


class _MergeKernel(CountedKernel):
    """The compiled cross-cell merge (``csrc/ccl_merge.cu``), built once per
    process: a merge launch (one per 64 boundaries) and a flatten a call."""

    source = "ccl_merge.cu"

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ccl_merge.argtypes = [ptr, i32, i32, i32, ptr, ptr, i32, i32, ptr,
                                  ctypes.POINTER(i32)]
        lib.ccl_merge.restype = i32

    def __call__(self, roots: torch.Tensor, bounds, connectivity: str = "full") -> torch.Tensor:
        if connectivity not in ("full", "faces"):
            raise ValueError(f"connectivity {connectivity!r}: expected 'full' or 'faces'")
        if (roots.dtype != torch.int32 or not roots.is_contiguous() or not 1 <= roots.ndim <= 3
                or roots.data_ptr() % 16):
            raise ValueError("the merge kernel takes a contiguous int32 volume of 1 to 3 axes "
                             "on a 16-byte boundary (its flatten reads int4)")
        if roots.numel() > MAX_VOXELS:
            raise ValueError(f"{roots.numel()} voxels: the merge kernel's int32 indices take at "
                             f"most {MAX_VOXELS}")
        planes = internal_planes(bounds)
        if not planes:
            return roots
        lib = self._lib or self.build()
        lead = 3 - roots.ndim
        depth, height, width = (1,) * lead + tuple(roots.shape)
        axes = (ctypes.c_int * len(planes))(*[axis + lead for axis, _ in planes])
        positions = (ctypes.c_int * len(planes))(*[pos for _, pos in planes])
        kernels = ctypes.c_int(0)
        with self.on_device(roots.device):
            err = lib.ccl_merge(roots.data_ptr(), depth, height, width, axes, positions,
                                len(planes), int(connectivity == "full"),
                                torch.cuda.current_stream().cuda_stream, ctypes.byref(kernels))
        check_error("ccl_merge launch", err)
        self.count_call(kernels.value, host_reads=0)
        return roots


MERGE_KERNEL = _MergeKernel()


def merge_cell_roots(roots: torch.Tensor, bounds, connectivity: str = "full") -> torch.Tensor:
    """Join the pieces of a volume labelled cell by cell, in place.

    ``roots`` (int32) holds -1 where a voxel takes no part and otherwise its
    piece's global minimum raveled index, as capacity's ``_cell_roots``
    writes it for the cells of the grid ``bounds`` (cut positions per
    axis).  Afterwards every member holds its merged component's minimum
    raveled index: pieces adjacent across a cell boundary (``faces``: the
    aligned voxel; ``full``: any in-plane shift by at most one) are one
    component.  A CUDA tensor goes to the hand-written kernel (or raises),
    a CPU tensor to :func:`merge_cell_roots_plain`; both give the same
    volume bit for bit."""
    if on_card(roots, "merge_cell_roots"):
        return MERGE_KERNEL(roots, bounds, connectivity)
    return merge_cell_roots_plain(roots, bounds, connectivity)
