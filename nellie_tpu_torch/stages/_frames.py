"""Frame transfer between the artifact memmaps and the device."""
from __future__ import annotations

import numpy as np
import torch


def load(memmap, t: int, device: torch.device, dtype=np.float32) -> torch.Tensor:
    """Frame ``t`` of a memmap as a contiguous tensor of ``dtype`` on ``device``."""
    arr = np.ascontiguousarray(np.asarray(memmap[t]), dtype=dtype)
    return torch.from_numpy(arr).to(device)


def store(memmap, t: int, frame: torch.Tensor, dtype) -> None:
    memmap[t] = frame.cpu().numpy().astype(dtype, copy=False)
    memmap.flush()
