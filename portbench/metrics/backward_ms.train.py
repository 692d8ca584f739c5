"""ms a round: the training backwards (the program's span
``train.backward``: ``torch.autograd.grad``, the zero fill and the mesh's
sums in ``descend``, host clock), the mean over the untraced rounds."""

from portbench.readers import mean_ms


def read(ctx):
    return mean_ms(r["sections"].get("train.backward")
                   for r in ctx["records"])
