"""ms: the server's aggregation section of a round (``round_sections``
``aggregate``: the reductions, the aux exchange, the finite check that
reads every leaf back), the mean over the traced rounds."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("aggregate") for r in ctx["records"])
