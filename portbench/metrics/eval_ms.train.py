"""ms: a round's central evaluation (``eval_seconds``), the mean over the
traced rounds."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r.get("eval_seconds") for r in ctx["records"])
