"""Topology-preserving 3D thinning with the simple-point lookup table.

Port of ``nellie_tpu/kernels/skeleton.py::skeletonize_3d`` with ONE
backend, the LUT (``_deletable``, ``:53``): each voxel's 26 neighbour
occupancies are packed into a 26-bit code and looked up in the 8 MiB
Bertrand–Malandain table (:mod:`nellie_tpu_torch.kernels.simple_point`).  The
reference shows that its three backends agree
(``tests/test_skeleton_backends.py``).

The sweep is the reference's exactly: six border directions per outer
iteration; within a direction the candidates are fixed to the border
layer at the start, simplicity is re-checked as deletions land, and each
round commits only candidates with no 26-adjacent candidate of lower
parity index (``:233-279``), so parallel commits equal some sequential
order of simple-point deletions.
"""
from __future__ import annotations

import torch

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


def skeletonize_3d(mask: torch.Tensor, lut: torch.Tensor = None) -> torch.Tensor:
    """3D curve thinning; preserves 26-connectivity of the foreground and
    6-topology of the background.  ``lut`` is :func:`simple26_lut` on the
    mask's device (loaded here when not given)."""
    if lut is None:
        lut = simple26_lut(mask.device)
    shape = mask.shape
    dev = mask.device
    iz = torch.arange(shape[0], device=dev).reshape(-1, 1, 1) % 2
    iy = torch.arange(shape[1], device=dev).reshape(1, -1, 1) % 2
    ix = torch.arange(shape[2], device=dev).reshape(1, 1, -1) % 2
    parity = (iz * 4 + iy * 2 + ix).expand(shape).to(torch.int8)
    lower = []
    for off in OFFSETS_26:
        flip = ((abs(off[0]) % 2) << 2) | ((abs(off[1]) % 2) << 1) | (abs(off[2]) % 2)
        lower.append((parity ^ flip) < parity)

    def one_direction(fg, d):
        border = fg & ~_shift3(fg, _DIRECTIONS[d], False)
        remaining = _deletable(fg, lut, border)
        go = bool(remaining.any())
        while go:
            del_now = _deletable(fg, lut, remaining)
            blocked = torch.zeros_like(del_now)
            for off, low in zip(OFFSETS_26, lower):
                blocked = blocked | (_shift3(del_now, off, False) & low)
            commit = del_now & ~blocked
            fg = fg & ~commit
            remaining = del_now & ~commit
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
