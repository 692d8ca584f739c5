"""ms a round: the group updates' data (the program's span
``train.data``: the wait for the feeder thread's next chunk, the index
maps' copy, each step's gather and augmentation, host clock), the mean
over the untraced rounds."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("train.data") for r in ctx["records"])
