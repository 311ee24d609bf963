"""The same-device retry ladder of every stage: the whole frame first,
then the stage's low-memory mode.

Port of the same-device rungs of ``nellie_tpu/utils/adaptive_run.py``
(``should_use_low_memory``, ``mode_candidates``, ``run_with_ladder``).  A
stage starts in low-memory mode when asked to, or when six times a float32
frame exceeds 0.7 of the smaller of the device's free memory and the
host's available memory; a full-frame attempt that runs out of memory is
retried once in low-memory mode on the same device, and an out-of-memory
error there is raised.

Not ported, on purpose: the JAX ladder's CPU rungs and its "accelerator
unavailable" retry.  Nothing moves to the CPU behind the caller's back;
the device is the one the caller chose.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.utils.logger import logger

# peak memory of one frame's working set, in float32 frames (Hessian
# components, eigenvalues, masks), and the share of the budget it may use
PEAK_FRAME_MULTIPLIER = 6.0
MEMORY_HEADROOM = 0.7

OOM_ERRORS = (torch.OutOfMemoryError, MemoryError)


def device_free_bytes(device: torch.device):
    """Free memory of a CUDA device, None for the CPU: the free bytes of
    ``mem_get_info`` plus the blocks PyTorch's caching allocator holds but
    no tensor uses, which ``mem_get_info`` counts as used.  That is the JAX package's
    ``bytes_limit - bytes_in_use``, so what earlier stages left in the
    cache does not push a stage into low-memory mode."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(free) + int(cached)


def host_available_bytes():
    """``MemAvailable`` of ``/proc/meminfo``, None where there is none."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def estimate_frame_bytes(im_info) -> int:
    shape = list(im_info.shape)
    if not im_info.no_t and "T" in im_info.axes:
        shape = shape[1:]
    return int(np.prod(shape)) * 4


def should_use_low_memory(im_info, device: torch.device) -> bool:
    """6 x the float32 frame > 0.7 x min(free device memory, available host
    memory), over the budgets that can be read."""
    peak = estimate_frame_bytes(im_info) * PEAK_FRAME_MULTIPLIER
    budgets = [b for b in (device_free_bytes(device), host_available_bytes()) if b is not None]
    if not budgets:
        return False
    return peak > min(budgets) * MEMORY_HEADROOM


def mode_candidates(start_low_memory: bool):
    """The low-memory flags to try, in order."""
    return [True] if start_low_memory else [False, True]


def run_with_ladder(stage_name, device, low_memory, im_info, attempt_fn):
    """``attempt_fn(device, low_memory)`` on the caller's device: full
    frames, then (on running out of memory) low-memory mode."""
    start_low = bool(low_memory) or should_use_low_memory(im_info, device)
    if start_low and not low_memory:
        logger.info("%s: enabling low-memory mode based on estimated usage.", stage_name)
    candidates = mode_candidates(start_low)
    for i, low in enumerate(candidates):
        logger.info("%s: %s mode on %s", stage_name, "low-memory" if low else "full-frame", device)
        try:
            return attempt_fn(device, low)
        except OOM_ERRORS:
            if i + 1 == len(candidates):
                raise
            logger.warning("%s: out of memory in full-frame mode on %s; retrying in "
                           "low-memory mode on the same device.", stage_name, device)
