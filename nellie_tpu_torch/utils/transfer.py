"""The foreground-sparse pull of the capacity path's ``sparse_labels`` emit.

Copy of the bit packing of ``nellie_tpu/utils/transfer.py`` (``packbits``,
``:122``, and ``SPARSE_CAP_DIV``): the support of a mask packed eight
voxels to a byte, least significant bit first, as
``np.unpackbits(..., bitorder="little")`` reads it back, and the capacity
of the compacted values, one sixteenth of the voxels.
"""
from __future__ import annotations

import torch

SPARSE_CAP_DIV = 16  # compacted values hold size / 16 entries (6.25 % foreground)


def packbits(fg: torch.Tensor) -> torch.Tensor:
    """Little-endian bit packing of a flat boolean tensor whose length is a
    multiple of 8 (uint8, one byte per 8 voxels)."""
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8, device=fg.device)
    return (fg.reshape(-1, 8).to(torch.uint8) * weights).sum(dim=1, dtype=torch.uint8)
