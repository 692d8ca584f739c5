"""The round's span recorder, its counters and per-round traces (port of
``fedcola_tpu/utils/profiling.py``; the reference has no profiling).

``span(name)`` is the one way the program opens a span.  While a round is
being recorded (``Timer.recording``) it adds the body's host seconds
(``time.perf_counter``) to the round's sections under ``name``; while
``torch.profiler`` is on it also opens the range ``fc_<name>``, so the
span sits on the trace's own clock beside the kernels it issued.  With
neither, it costs a flag check.  Names are dotted: ``train.opt`` lies
inside the top-level section ``train``.  A name that starts with a dot
lies inside the top-level section it is opened in (``round`` outside any):
``.sync`` in ``train`` is ``train.sync``, so a helper shared by several
sections (the optimizer step, a readback) names its span once.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger(__name__)

# the round being recorded, and the top-level section the program is in
_timer: Optional["Timer"] = None
_top = "round"
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "timer", "section", "device", "rf", "t0", "outer")

    def __init__(self, name: str, timer: Optional["Timer"], timed: bool,
                 device: bool):
        self.name = _top + name if name[0] == "." else name
        self.timer = timer
        # a timed undotted span is a top-level section
        self.section = timed and "." not in self.name
        self.device = device
        self.rf = None

    def __enter__(self):
        global _top
        self.outer = _top
        if self.section:
            _top = self.name
        if _profiler._is_profiler_enabled:
            # a host range costs about a tenth of a record_function, whose
            # extra is the range it also draws on the device's timeline
            self.rf = (torch.profiler.record_function if self.device else
                       torch._C._profiler._RecordFunctionFast)(
                "fc_" + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _top
        dt = time.perf_counter() - self.t0
        _top = self.outer
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.timer is not None:
            # partial time is kept when the body raises
            s = self.timer.sections
            s[self.name] = s.get(self.name, 0.0) + dt
        return False


def span(name: str, timed: bool = True, device: bool = False):
    """A span named ``name`` (see the module's docstring).  ``timed=False``:
    on the profiler's trace only, never in the round's sections (spans too
    many for the host clock: the model's sublayers, each kernel launch).
    ``device=True``: the trace's range is a ``record_function``, drawn on
    the device's timeline too over the kernels issued inside it (a kernel
    launch: the rooflines read the device time under it)."""
    timer = _timer if timed else None
    if timer is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, timer, timed, device)


def readback():
    """The span of a readback (``.cpu()``, ``.item()``, ``bool()`` or
    ``float()`` of a device tensor, a synchronize): ``<section>.sync``,
    counted in the round's ``readbacks``."""
    if _timer is not None:
        _timer.counters["readbacks"] += 1
    return span(".sync")


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the round's counter ``key`` while a round is being
    recorded."""
    if _timer is not None:
        _timer.counters[key] = _timer.counters.get(key, 0) + n


def _levels(cuda: bool):
    """The process's kernel launches and the caching allocator's device
    segments allocated so far (None off CUDA)."""
    from fedcola_tpu_torch.ops.kernels import LAUNCHES
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) \
        if cuda else None
    return sum(LAUNCHES.values()), segments


class Timer:
    """One round's spans and counters.  ``sections``: host seconds by span
    name (top-level sections undotted); ``counters``: ``steps`` (stacked
    group steps run), ``opt_fused`` (those of them whose optimizer step
    took the fused kernel), ``launches`` (calls of the kernels' entry points),
    ``readbacks`` (``.sync`` spans entered) and ``device_mallocs`` (device
    segments the caching allocator took from CUDA; None off CUDA), counted
    from the timer's creation.  The server keeps both dicts in the round's
    results, so every recording of the round (its update, its central
    evaluation) adds to them."""

    def __init__(self, sections: Optional[Dict[str, float]] = None,
                 counters: Optional[Dict[str, Optional[int]]] = None,
                 cuda: bool = False):
        self.sections = {} if sections is None else sections
        self.counters = {} if counters is None else counters
        for k in ("steps", "opt_fused", "launches", "readbacks",
                  "device_mallocs"):
            self.counters.setdefault(k, 0)
        self.cuda = cuda
        self._base = _levels(cuda)

    @contextlib.contextmanager
    def recording(self):
        """Record the body's spans and counters into this timer."""
        global _timer
        outer, _timer = _timer, self
        try:
            yield self
        finally:
            _timer = outer
            self.refresh()

    def refresh(self) -> Dict[str, Optional[int]]:
        """The counters, with launches and device segments read now."""
        launches, segments = _levels(self.cuda)
        self.counters["launches"] = launches - self._base[0]
        self.counters["device_mallocs"] = None if segments is None \
            else segments - self._base[1]
        return self.counters

    def summary(self) -> str:
        """The top-level sections and their total."""
        top = {k: v for k, v in self.sections.items() if "." not in k}
        parts = " ".join(f"{k}={v:.2f}s" for k, v in top.items())
        return f"{parts} total={sum(top.values()):.2f}s"


@contextlib.contextmanager
def round_trace(enabled: bool, log_dir: str, round_idx: int):
    """Trace one round with ``torch.profiler`` when ``enabled``: host
    activity, every span as an ``fc_<name>`` range and, where a card is
    present, its kernels; the Chrome trace goes to
    ``<log_dir>/trace_round{round_idx:04d}/trace.json``."""
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
