"""ms per stacked group step: device time under ``fc_moe.route`` (the
router's scores and top-k), ``fc_moe.dispatch`` (the routing plan and the
gather of token rows into the expert buffer, and its backward) and
``fc_moe.combine`` (the weighted sum back to token order, and its
backward) of the traced round, its central evaluation included, over its
group steps, counted from the plan."""

RANGES = ("fc_moe.route", "fc_moe.dispatch", "fc_moe.combine")


def read(ctx):
    steps = ctx["work"]["steps"]
    spent = sum(ctx["trace"]["ranges"].get(r, 0.0) for r in RANGES)
    if steps <= 0 or spent <= 0:
        return None
    return 1e3 * spent / steps
