"""What the per-layer metric readers (``metrics/<name>.py``) share.  Each
reader takes the traced run's context:

* ``trace``: ``trace.reduce``'s summary of the full trace (device
  seconds by kernel and by ``fc_*`` range), and under ``device`` the busy
  seconds and the window of the trace of the card alone;
* ``work``: the traced window's work from the plan (model FLOPs, group
  steps, each route's least seconds);
* ``timed``: as many rounds (or passes) run untraced just before, on the
  host clock: their ``window_s`` and ``model_flops``;
* ``records``: the program's own clocks of those untraced rounds
  (``program.round_record``).

A reader returns None where it finds nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench.counts.peaks import BF16_FLOPS

ROUTES = {"fused": ("fc_attn_fwd", "fc_attn_bwd", "fc_mlp_fwd", "fc_mlp_bwd",
                    "fc_attn_bwd_recompute", "fc_mlp_bwd_nores"),
          "flash": ("fc_flash_fwd", "fc_flash_bwd")}


def roofline(ctx, route: str) -> Optional[float]:
    """% : the route's calls' least time (from the plan) over the device
    time under its ranges."""
    spent = sum(ctx["trace"]["ranges"].get(r, 0.0) for r in ROUTES[route])
    least = ctx["work"]["least"].get(route, 0.0)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


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
