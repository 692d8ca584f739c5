"""% of the grouped GEMM's roofline (the routed experts, fc_moe_gemm_fwd
and fc_moe_gemm_bwd): its least time for the plan's calls, the routed rows
at the routing's expectation, over the device time under its ranges."""

from portbench.readers import route_roofline


def read(ctx):
    return route_roofline(ctx, __file__)
