"""Tracing and step timing (counterpart of the JAX package's
``utils/profiling.py``):

  * ``trace(logdir)`` — ``torch.profiler`` over the enclosed block (the
    CPU and, on a card, CUDA activities), written as a Chrome trace into
    ``logdir``;
  * ``annotate(name)`` — a named span in that trace
    (``torch.profiler.record_function``), and an NVTX range on a card;
  * ``StepTimer`` — per-step wall clock that synchronises the device
    once every ``sync_every`` ticks.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str = "logs/torch_trace"):
    """Profile the enclosed block; its Chrome trace is written to
    ``logdir/trace_<pid>_<time>.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                f"{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(path)
    logger.info("torch trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """A named span visible in profiler timelines (and in NVTX on a
    card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step statistics with explicit sync points.

    >>> timer = StepTimer(sync_every=10)
    >>> for batch in loader:
    ...     loss = step(batch)
    ...     timer.tick(loss)        # synchronises every 10 steps only
    """

    def __init__(self, sync_every: int = 10):
        self.sync_every = max(1, sync_every)
        self.times: List[float] = []
        self._count = 0
        self._t0 = time.time()

    def tick(self, sync_value=None) -> Optional[float]:
        """Count one step; every ``sync_every``-th, wait for the device
        (``sync_value``'s when it is a CUDA tensor, else the current CUDA
        device once CUDA is in use) and return the mean seconds per step
        since the last sync point."""
        self._count += 1
        if self._count % self.sync_every:
            return None
        if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.time()
        per_step = (now - self._t0) / self.sync_every
        self.times.append(per_step)
        self._t0 = now
        return per_step

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": self._count}
        return {
            "steps": self._count,
            "mean_s": float(np.mean(self.times)),
            "median_s": float(np.median(self.times)),
            "min_s": float(np.min(self.times)),
            "steps_per_sec": float(1.0 / np.median(self.times)),
        }
