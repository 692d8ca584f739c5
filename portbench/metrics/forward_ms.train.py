"""ms a round: the model's training forwards (the program's span
``train.forward``: ``_local_loss`` in ``run_chunk``, host clock), the mean
over the untraced rounds."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("train.forward") for r in ctx["records"])
