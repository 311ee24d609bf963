"""Explicit halo exchange between the shards of a Z-split volume.

Port of ``nellie_tpu/mesh/halo.py``: each shard takes its neighbours'
boundary slabs (zero slabs at the volume's two ends), applies ``fn`` to
the extended block and is cropped back to its own planes.  Exact for any
kernel whose receptive field is at most ``halo`` and whose edges act as
zero padding.  The stages' own sharded path
(:mod:`nellie_tpu_torch.mesh.sharded`) extends blocks by neighbours as
deep as it needs and never past the volume, so the kernels' own edge rules
apply; this helper keeps the reference's contract.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nellie_tpu_torch.mesh.sharded import Mesh


def halo_exchange_apply(fn: Callable[[torch.Tensor], torch.Tensor], volume, mesh: Mesh,
                        halo: int, axis_name: str = "z") -> torch.Tensor:
    """``fn`` on each Z shard of ``volume`` (over the mesh's ``axis_name``
    group) extended by ``halo`` planes from each neighbour, cropped back;
    the whole result on the group's first device (``halo.py:30-74``).
    Raises ``ValueError`` when Z does not divide over the shards or the
    halo is deeper than one shard."""
    devices = mesh.row(0) if axis_name == "z" else list(mesh.devices[:, 0])
    n_shards = len(devices)
    if not isinstance(volume, torch.Tensor):
        volume = torch.from_numpy(np.ascontiguousarray(volume))
    if volume.shape[0] % n_shards != 0:
        raise ValueError(f"Z={volume.shape[0]} must divide evenly over {n_shards} shards")
    local_z = volume.shape[0] // n_shards
    if halo > local_z:
        raise ValueError(f"halo {halo} exceeds local shard depth {local_z}")
    shards = [volume[k * local_z:(k + 1) * local_z].contiguous().to(d)
              for k, d in enumerate(devices)]
    out = []
    for k, (block, dev) in enumerate(zip(shards, devices)):
        zero = torch.zeros_like(block[:halo])
        lo = zero if k == 0 else shards[k - 1][local_z - halo:].to(dev)
        hi = zero if k == n_shards - 1 else shards[k + 1][:halo].to(dev)
        extended = torch.cat([lo, block, hi]) if halo else block
        out.append(fn(extended)[halo:halo + local_z].to(devices[0]))
    return torch.cat(out)
