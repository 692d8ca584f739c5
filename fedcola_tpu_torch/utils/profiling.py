"""Per-round section timing and per-round traces (port of
``fedcola_tpu/utils/profiling.py``; the reference has no profiling)."""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def round_trace(enabled: bool, log_dir: str, round_idx: int):
    """Trace one round with ``torch.profiler`` when ``enabled``: host
    activity and, where a card is present, its kernels; the Chrome trace
    goes to ``<log_dir>/trace_round{round_idx:04d}/trace.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"trace_round{round_idx:04d}")
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    logger.info("profiler trace written to %s", path)


class Timer:
    """Accumulating section timer for the round loop (host clock).  A
    section that ends in a device readback or a synchronize holds the
    device work it queued."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # partial time is kept when the body raises
            self.sections[name] = self.sections.get(name, 0.0) \
                + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.sections.values())
        parts = " ".join(f"{k}={v:.2f}s" for k, v in self.sections.items())
        return f"{parts} total={total:.2f}s"
