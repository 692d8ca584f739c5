"""% of the fused kernels' roofline (rows 1-4, 1e, 3e): their least time
for the plan's calls over the device time under their ranges."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "fused")
