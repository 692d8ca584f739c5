"""ms a pass: the central evaluation's drains (the program's span
``eval.drain``: each classification batch read back, its cross entropy on
the host, the metrics tracked, host clock), the mean over the untraced
passes."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("eval.drain") for r in ctx["records"])
