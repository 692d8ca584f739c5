"""% of the flash kernels' roofline (row 11e in evaluation, 11 and 12 in
training) for the plan's calls over the device time under their ranges."""

from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "flash")
