"""% of the flash kernels' roofline (row 11e in evaluation, 11 and 12 in
training) for the plan's calls over the device time under their ranges."""

from portbench.readers import route_roofline


def read(ctx):
    return route_roofline(ctx, __file__)
