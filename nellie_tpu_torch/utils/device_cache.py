"""Budgeted cross-stage cache of per-frame device tensors.

Port of ``nellie_tpu/utils/device_cache.py``.  The fused segmentation
chain (:mod:`nellie_tpu_torch.pipeline.fused`) leaves each frame's raw
image, vesselness, distance and skeleton on the device, and the stages
after it in the same process take them from here instead of uploading
the artifacts again: HuMomentTracking the first three, the Hierarchy the
skeleton.  The artifacts are still written, so a stage run on its own
reads the same values from disk.

* ``put`` is a no-op once the byte budget is reached: the first frames of
  a long series are cached, later ones are read from disk.
* ``take`` pops, so device memory is released as the consumer advances.
* Keys are (artifact key, t), with the keys of ``ImInfo.pipeline_paths``
  and ``"im"`` for the raw frame.
"""
from __future__ import annotations

DEFAULT_BUDGET_BYTES = int(2.5e9)


class DeviceFrameCache:
    """(key, t) -> tensor store with a byte budget; ``peak`` is the most
    bytes it has held."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.budget = int(budget_bytes)
        self.used = 0
        self.peak = 0
        self._store = {}

    @staticmethod
    def _nbytes(tensor) -> int:
        return tensor.numel() * tensor.element_size()

    def put(self, key: str, t: int, tensor) -> bool:
        """Record ``tensor`` for (key, t); False (and drop it) over budget."""
        k = (key, int(t))
        if k in self._store:
            return True
        nb = self._nbytes(tensor)
        if self.used + nb > self.budget:
            return False
        self._store[k] = (tensor, nb)
        self.used += nb
        self.peak = max(self.peak, self.used)
        return True

    def take(self, key: str, t: int):
        """Pop and return the tensor of (key, t), or None."""
        ent = self._store.pop((key, int(t)), None)
        if ent is None:
            return None
        self.used -= ent[1]
        return ent[0]

    def get(self, key: str, t: int):
        ent = self._store.get((key, int(t)))
        return None if ent is None else ent[0]

    def clear(self):
        self._store.clear()
        self.used = 0

    def __len__(self):
        return len(self._store)


def frame_cache(im_info, create: bool = False):
    """The cache attached to ``im_info`` (made on first use when
    ``create``), or None."""
    cache = getattr(im_info, "_device_frame_cache", None)
    if cache is None and create:
        cache = DeviceFrameCache()
        im_info._device_frame_cache = cache
    return cache
