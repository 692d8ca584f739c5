"""A traced window reduced to what the per-layer metrics read.

``torch.profiler`` traces whole rounds (or passes).  A full trace (the
CPU and the card) gives the device time of every kernel (and copy) by
name, the device time under each of the program's ``fc_*`` ranges (user
annotations spanning their kernels on the device timeline, counted apart
from the kernels) and the longest gaps between device operations, each named by the
innermost host operation running at its middle.  Its host events stretch
the window, so the device's busy seconds over the window (its idle share)
come from a trace of the card alone (``device_only``), run on rounds of
their own.  The raw events are read as they come, without the profiler's
event tree, which takes minutes to build for a population round.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import numpy as np


@contextmanager
def traced(summary: Dict, device_only: bool = False):
    """Trace the body (the card alone with ``device_only``, where there is
    one); fill ``summary`` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if not (device_only and acts):
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    summary.update(reduce(prof, window))


def _kind(e, cuda) -> str:
    """``device`` (a kernel, copy or fill), ``range`` (an annotation on the
    device timeline) or ``host``."""
    if e.device_type() != cuda:
        return "host"
    return "range" if e.is_user_annotation() else "device"


def reduce(prof, window: float) -> Dict:
    """The summary, from the profiler's raw events (the kernels, copies
    and fills on the device; the ``fc_*`` annotations on its timeline;
    the host's operations)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels: Dict[str, float] = defaultdict(float)
    ranges: Dict[str, float] = defaultdict(float)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, cuda)
        name, t0, d = e.name(), e.start_ns(), e.duration_ns()
        if kind == "device":
            kernels[name] += d / 1e9
            dev.append((t0, t0 + d))
        elif kind == "range":
            if name.startswith("fc_"):
                ranges[name] += d / 1e9
        else:
            host.append((t0, t0 + d, name))
    return {"window_s": window, "busy_s": sum(kernels.values()),
            "kernels": dict(kernels), "ranges": dict(ranges),
            "idle_gaps": _gaps(dev, host)}


def _gaps(dev, host, keep: int = 400) -> Dict[str, float]:
    """Idle seconds between device operations, by the innermost host
    operation under the middle of each of the ``keep`` longest gaps."""
    if len(dev) < 2 or not host:
        return {}
    dev.sort()
    starts = np.array([s for s, _ in dev], np.float64)
    ends = np.maximum.accumulate(np.array([e for _, e in dev], np.float64))
    gap = starts[1:] - ends[:-1]
    top = np.argsort(-gap)[:keep]
    hs = np.array([h[0] for h in host], np.float64)
    he = np.array([h[1] for h in host], np.float64)
    dur = he - hs
    out: Dict[str, float] = defaultdict(float)
    for i in top:
        if gap[i] <= 0:
            break
        mid = 0.5 * (ends[i] + starts[i + 1])
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = host[inside[np.argmin(dur[inside])]][2] if len(inside) \
            else "(no host op)"
        out[name] += gap[i] / 1e9
    return dict(out)


def breakdown(summary: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten host operations under the longest gaps."""
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary["kernels"]),
            "idle_gaps": top(summary["idle_gaps"])}
