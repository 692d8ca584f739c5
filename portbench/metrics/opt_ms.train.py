"""ms a round: the local optimizer steps (the program's span
``train.opt``: ``opt_update`` in ``descend``, host clock), the mean over
the untraced rounds."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("train.opt") for r in ctx["records"])
