"""Tracing and stage timers.

Port of ``nellie_tpu/utils/profiling.py``: ``StageTimer`` as it is, and
``trace`` on ``torch.profiler`` in place of ``jax.profiler``, with the
CUDA activity when a card is present; the trace is written to the
directory as a Chrome trace (open it in Perfetto or ``chrome://tracing``).
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from nellie_tpu_torch.utils.logger import logger


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of work into ``log_dir/trace.json``; yields the
    ``torch.profiler.profile`` object (``key_averages()`` sums it by op).

    >>> with trace("nellie_trace"):
    ...     Filter(im_info, device="cuda").run()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("torch profiler trace written to %s", path)


class StageTimer:
    """Accumulates named wall-time spans; serialisable for benchmarking."""

    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - start

    @property
    def total(self) -> float:
        return sum(self.spans.values())

    def report(self) -> str:
        lines = [f"{name}: {seconds:.4f}s" for name, seconds in self.spans.items()]
        lines.append(f"total: {self.total:.4f}s")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({**self.spans, "total": self.total}, sort_keys=True)
