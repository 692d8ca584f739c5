"""Per-round section timing (port of ``Timer`` in
``fedcola_tpu/utils/profiling.py``; the reference has no profiling).
``round_trace`` is not ported: ``profile_round.py`` traces a round with
``torch.profiler``."""

from __future__ import annotations

import contextlib
import time


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
