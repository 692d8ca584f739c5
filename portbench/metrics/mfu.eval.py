"""% of the bf16 peak: the model FLOPs (3 forwards a training row, 1 an
evaluated item) of the rounds run untraced beside the traced ones, over
their length on the host clock."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx)
