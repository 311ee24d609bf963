"""Topology-preserving thinning: 3D with the simple-point lookup table,
2D by Zhang–Suen.

Port of ``nellie_tpu/kernels/skeleton.py``.  ``skeletonize_3d`` has ONE
backend, the LUT (``_deletable``, ``:53``): each voxel's 26 neighbour
occupancies are packed into a 26-bit code and looked up in the 8 MiB
Bertrand–Malandain table (:mod:`nellie_tpu_torch.kernels.simple_point`).  The
reference shows that its three backends agree
(``tests/test_skeleton_backends.py``).  On a CUDA tensor it launches the
hand-written kernel ``csrc/thin26.cu`` (built for ``sm_90a`` with ``nvcc``
on first use, bound through ``ctypes``), or raises; on a CPU tensor it runs
:func:`skeletonize_3d_plain`.  ``THIN26_KERNEL.launches`` counts the
wrapper's calls (one C call runs the whole loop) and
``THIN26_KERNEL.kernel_launches`` the CUDA kernels those calls launched
(one a call: the kernel is persistent and runs every sweep, direction and
round between grid barriers).

The sweep is the reference's exactly: six border directions per outer
iteration; within a direction the candidates are fixed to the border
layer at the start, simplicity is re-checked as deletions land, and each
round commits only candidates with no 26-adjacent candidate of lower
parity index (``:233-279``), so parallel commits equal some sequential
order of simple-point deletions.

``skeletonize_2d`` (``:286-319``) runs Zhang–Suen's two subiterations
until a pass deletes nothing.  On a CUDA tensor it launches the
hand-written kernel ``csrc/thin2d.cu`` (one persistent cooperative launch
runs every pass, with no host read; ``THIN2D_KERNEL.launches`` and
``kernel_launches`` count as ``THIN26_KERNEL``'s do), or raises; on a CPU
tensor it runs :func:`skeletonize_2d_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from nellie_tpu_torch.kernels._cuda import CountedKernel, CudaKernel, check_error, on_card
from nellie_tpu_torch.kernels.ccl import MAX_VOXELS  # int32 indices
from nellie_tpu_torch.kernels.filters import shift_fill
from nellie_tpu_torch.kernels.simple_point import OFFSETS_26, get_simple26_lut

_DIRECTIONS = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def _shift3(x, off, fill):
    out = x
    for axis, o in enumerate(off):
        if o != 0:
            out = shift_fill(out, axis, o, fill)
    return out


def _pack26(fg: torch.Tensor) -> torch.Tensor:
    """26 neighbour occupancies as an int32 code; bit k is the voxel at
    ``v + OFFSETS_26[k]``."""
    code = torch.zeros(fg.shape, dtype=torch.int32, device=fg.device)
    for k, off in enumerate(OFFSETS_26):
        code = code | (_shift3(fg, off, False).to(torch.int32) << k)
    return code


def _deletable(fg: torch.Tensor, lut: torch.Tensor, where=None) -> torch.Tensor:
    """LUT deletability, evaluated at ``where`` voxels only."""
    sel = fg if where is None else (fg & where)
    code = torch.where(sel, _pack26(fg), 0)
    byte = lut[(code >> 3).long()].to(torch.int32)
    return (((byte >> (code & 7)) & 1) != 0) & sel


def simple26_lut(device) -> torch.Tensor:
    """The packed deletability table as a uint8 tensor on ``device``."""
    return torch.from_numpy(get_simple26_lut()).to(device)


def lower_parity(shape, dev):
    """For each of ``OFFSETS_26``: whether the voxel at that offset has a
    lower parity index than the voxel itself, parity = (z%2)*4 + (y%2)*2 +
    x%2 (a neighbour's is the parity xor the offset's odd axes)."""
    iz = torch.arange(shape[0], device=dev).reshape(-1, 1, 1) % 2
    iy = torch.arange(shape[1], device=dev).reshape(1, -1, 1) % 2
    ix = torch.arange(shape[2], device=dev).reshape(1, 1, -1) % 2
    parity = (iz * 4 + iy * 2 + ix).expand(shape).to(torch.int8)
    lower = []
    for off in OFFSETS_26:
        flip = ((abs(off[0]) % 2) << 2) | ((abs(off[1]) % 2) << 1) | (abs(off[2]) % 2)
        lower.append((parity ^ flip) < parity)
    return lower


def border_candidates(fg, d, lut):
    """Direction ``d``'s candidates: deletable voxels of the border
    ``fg & ~fg(v + d)``, outside the volume counting as background."""
    return _deletable(fg, lut, fg & ~_shift3(fg, _DIRECTIONS[d], False))


def thin_round(fg, remaining, lut, lower):
    """One round: (fg, remaining, commit) after committing the deletable
    ``remaining`` voxels that no 26-neighbour of lower parity blocks."""
    del_now = _deletable(fg, lut, remaining)
    blocked = torch.zeros_like(del_now)
    for off, low in zip(OFFSETS_26, lower):
        blocked = blocked | (_shift3(del_now, off, False) & low)
    commit = del_now & ~blocked
    return fg & ~commit, del_now & ~commit, commit


def skeletonize_3d_plain(mask: torch.Tensor, lut: torch.Tensor = None) -> torch.Tensor:
    """:func:`skeletonize_3d` in plain torch: each round packs the codes
    from 26 shifted copies, gathers from the table and reads the commit
    flag on the host."""
    if lut is None:
        lut = simple26_lut(mask.device)
    lower = lower_parity(mask.shape, mask.device)

    def one_direction(fg, d):
        remaining = border_candidates(fg, d, lut)
        go = bool(remaining.any())
        while go:
            fg, remaining, commit = thin_round(fg, remaining, lut, lower)
            go = bool(commit.any())
        return fg

    fg = mask.bool()
    while True:
        new = fg
        for d in range(6):
            new = one_direction(new, d)
        if torch.equal(new, fg):
            return new
        fg = new


class _Thin26Kernel(CudaKernel):
    """The compiled thinning (``csrc/thin26.cu``), built once per process,
    with a launch count, a count of the CUDA kernels launched and the last
    call's (rounds, host reads, sweeps, kernels launched)."""

    source = "thin26.cu"

    def __init__(self):
        super().__init__()
        self.kernel_launches = 0
        self.last_stats = (0, 0, 0, 0)

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.thin26.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32,
                               ctypes.POINTER(ctypes.c_longlong), ptr]
        lib.thin26.restype = i32
        lib.thin26_scratch_bytes.argtypes = [i32]
        lib.thin26_scratch_bytes.restype = ctypes.c_longlong

    def __call__(self, mask: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
        if mask.device.type != "cuda" or mask.ndim != 3:
            raise TypeError(f"thin26 takes a 3D CUDA tensor, not {mask.ndim}D on {mask.device}")
        if lut.device != mask.device or lut.dtype != torch.uint8 or lut.numel() != 1 << 23:
            raise ValueError("thin26 takes the 2**23-byte uint8 table on the mask's device")
        n = mask.numel()
        if n > MAX_VOXELS:
            raise ValueError(f"{n} voxels: the thinning kernel's int32 indices take at most "
                             f"{MAX_VOXELS}")
        dev = mask.device
        lut = lut.contiguous()
        fg = mask.to(torch.bool).contiguous().clone()
        if n == 0:
            return fg
        lib = self._lib or self.build()
        with self.on_device(dev):
            # queued before the list's host sync, so the card is not idle after it
            del_now = torch.zeros(fg.shape, dtype=torch.uint8, device=dev)
            voxels = torch.nonzero(fg.reshape(-1)).reshape(-1).to(torch.int32)
            # flags and counters, the directions' work lists, a byte a voxel
            scratch = torch.empty(lib.thin26_scratch_bytes(voxels.numel()), dtype=torch.uint8,
                                  device=dev)
            stats = (ctypes.c_longlong * 4)()
            err = lib.thin26(fg.data_ptr(), voxels.data_ptr(), voxels.numel(), del_now.data_ptr(),
                             scratch.data_ptr(), lut.data_ptr(), *fg.shape, stats,
                             torch.cuda.current_stream(dev).cuda_stream)
        check_error("thin26 launch", err)
        with self._lock:
            self.count_launch()
            self.kernel_launches += stats[3]
            self.last_stats = tuple(stats)
        return fg


THIN26_KERNEL = _Thin26Kernel()


def skeletonize_3d(mask: torch.Tensor, lut: torch.Tensor = None) -> torch.Tensor:
    """3D curve thinning; preserves 26-connectivity of the foreground and
    6-topology of the background.  ``lut`` is :func:`simple26_lut` on the
    mask's device (loaded here when not given).  A CUDA tensor goes to the
    hand-written kernel (or raises), a CPU tensor to
    :func:`skeletonize_3d_plain`."""
    if lut is None:
        lut = simple26_lut(mask.device)
    if on_card(mask, "skeletonize_3d"):
        return THIN26_KERNEL(mask, lut)
    return skeletonize_3d_plain(mask, lut)


# P2..P9 clockwise from north, offsets (dy, dx)
_P_OFFS = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))


def _zs_pass(fg: torch.Tensor, first: bool) -> torch.Tensor:
    p = [_shift3(fg, off, False).to(torch.int32) for off in _P_OFFS]
    b = sum(p)
    seq = p + [p[0]]
    a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).to(torch.int32) for i in range(8))
    p2, p4, p6, p8 = p[0], p[2], p[4], p[6]
    if first:
        c1 = (p2 * p4 * p6) == 0
        c2 = (p4 * p6 * p8) == 0
    else:
        c1 = (p2 * p4 * p8) == 0
        c2 = (p2 * p6 * p8) == 0
    delete = fg & (b >= 2) & (b <= 6) & (a == 1) & c1 & c2
    return fg & ~delete


def skeletonize_2d_plain(mask: torch.Tensor) -> torch.Tensor:
    """:func:`skeletonize_2d` in plain torch: eight shifted copies of the
    frame a subiteration, and a host read a pass to compare the frame with
    the one before."""
    fg = mask.bool()
    while True:
        new = _zs_pass(_zs_pass(fg, True), False)
        if torch.equal(new, fg):
            return new
        fg = new


class _Thin2dKernel(CountedKernel):
    """The compiled Zhang–Suen thinning (``csrc/thin2d.cu``), built once per
    process, with a launch count, a count of the CUDA kernels launched and
    the last call's ``last_stats`` (CUDA kernels, host reads)."""

    source = "thin2d.cu"

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.thin2d_scratch_bytes.argtypes = [i32, i32]
        lib.thin2d_scratch_bytes.restype = ctypes.c_longlong
        lib.thin2d.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.POINTER(i32), ptr]
        lib.thin2d.restype = i32

    def __call__(self, mask: torch.Tensor) -> torch.Tensor:
        """The thinned frame (bool, on ``mask``'s device) by one C call
        with no host read; ``mask`` a 2D CUDA tensor, bool or uint8 as it
        is, any other type compared with 0."""
        if mask.device.type != "cuda" or mask.ndim != 2:
            raise TypeError(f"thin2d takes a 2D CUDA tensor, not {mask.ndim}D on {mask.device}")
        n = mask.numel()
        if n > MAX_VOXELS:
            raise ValueError(f"{n} pixels: the 2D thinning kernel's int32 indices take at most "
                             f"{MAX_VOXELS}")
        dev = mask.device
        out = torch.empty(mask.shape, dtype=torch.bool, device=dev)
        if n == 0:
            return out
        lib = self._lib or self.build()
        with self.on_device(dev):
            src = mask if mask.dtype in (torch.bool, torch.uint8) else mask != 0
            src = src.contiguous()
            scratch = torch.empty(lib.thin2d_scratch_bytes(*mask.shape), dtype=torch.uint8,
                                  device=dev)
            kernels = ctypes.c_int(0)
            err = lib.thin2d(src.data_ptr(), out.data_ptr(), scratch.data_ptr(), *mask.shape,
                             ctypes.byref(kernels), torch.cuda.current_stream(dev).cuda_stream)
            check_error("thin2d launch", err)
            self.count_call(kernels.value, host_reads=0)
        return out


THIN2D_KERNEL = _Thin2dKernel()


def skeletonize_2d(mask: torch.Tensor) -> torch.Tensor:
    """2D Zhang–Suen thinning of a boolean mask.  A CUDA tensor goes to the
    hand-written kernel (or raises), a CPU tensor to
    :func:`skeletonize_2d_plain`."""
    if on_card(mask, "skeletonize_2d"):
        return THIN2D_KERNEL(mask)
    return skeletonize_2d_plain(mask)


def skeletonize(mask: torch.Tensor, lut: torch.Tensor = None) -> torch.Tensor:
    """Dimension dispatch: Zhang–Suen in 2D, LUT thinning in 3D."""
    if mask.ndim == 2:
        return skeletonize_2d(mask)
    if mask.ndim == 3:
        return skeletonize_3d(mask, lut)
    raise ValueError(f"skeletonize supports 2D/3D, got {mask.ndim}D")
