"""ms a pass: the retrieval ranking (the program's span ``eval.rank``:
the similarities, the two argsorts and their readback, over the crossfolds
and the whole set, host clock), the mean over the untraced passes."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("eval.rank") for r in ctx["records"])
