"""What the per-layer metric readers (``metrics/<name>.py``) share.  Each
reader takes the traced run's context:

* ``trace``: ``trace.reduce``'s summary of the full trace (device
  seconds by kernel and by ``fc_*`` range), and under ``device`` the busy
  seconds and the window of the trace of the card alone;
* ``work``: the traced window's work from the plan (model FLOPs, group
  steps, each route's least seconds);
* ``routes``: each kernel route of the cell's architecture with the
  ``fc_*`` ranges its calls run under (``arch.routes()``);
* ``timed``: as many rounds (or passes) run untraced just before, on the
  host clock: their ``window_s`` and ``model_flops``;
* ``records``: the program's own clocks of those untraced rounds
  (``program.round_record``).

A reader returns None where it finds nothing to read."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from portbench.counts.peaks import BF16_FLOPS


def roofline(ctx, route: str) -> Optional[float]:
    """% : the route's calls' least time (from the plan) over the device
    time under its ranges; None for a route the architecture lacks."""
    if route not in ctx["routes"]:
        return None
    spent = sum(ctx["trace"]["ranges"].get(r, 0.0)
                for r in ctx["routes"][route])
    least = ctx["work"]["least"].get(route, 0.0)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


def route_roofline(ctx, reader: str) -> Optional[float]:
    """The roofline share of the route a reader's file names:
    ``metrics/<route>_roofline.<phase>.py``."""
    return roofline(ctx, Path(reader).name.split("_roofline")[0])


def mfu(ctx) -> Optional[float]:
    """% : model FLOPs of the untraced rounds over their time x bf16
    peak."""
    flops, window = ctx["timed"]["model_flops"], ctx["timed"]["window_s"]
    if flops <= 0 or window <= 0:
        return None
    return 100.0 * flops / (window * BF16_FLOPS)


def idle_share(ctx) -> Optional[float]:
    """% : 1 - device busy seconds / window, of the trace of the card
    alone."""
    t = ctx["trace"]["device"]
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mean_ms(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return 1e3 * sum(values) / len(values) if values else None
