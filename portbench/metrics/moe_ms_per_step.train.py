"""ms per stacked group step: device time under the MoE FFNs' ranges
(``fc_moe.route``, ``fc_moe.dispatch``, ``fc_moe.experts``,
``fc_moe.combine`` and ``fc_moe.shared`` of the forwards, which hold the
grouped GEMM's forward; the grouped GEMM's backward ``fc_moe_gemm_bwd``;
the dispatch's and the combine's backwards, under their own names) of the
traced round, its central evaluation included, over its group steps,
counted from the plan.  The autograd backwards of the router and the
shared experts run under no range and are not in it."""

RANGES = ("fc_moe.route", "fc_moe.dispatch", "fc_moe.experts",
          "fc_moe.combine", "fc_moe.shared", "fc_moe_gemm_bwd")


def read(ctx):
    steps = ctx["work"]["steps"]
    spent = sum(ctx["trace"]["ranges"].get(r, 0.0) for r in RANGES)
    if steps <= 0 or spent <= 0:
        return None
    return 1e3 * spent / steps
