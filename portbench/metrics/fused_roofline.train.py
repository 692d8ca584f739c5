"""% of the fused kernels' roofline (rows 1-4, 1e, 3e): their least time
for the plan's calls over the device time under their ranges."""

from portbench.readers import route_roofline


def read(ctx):
    return route_roofline(ctx, __file__)
