"""ms per stacked group step: device time of PyTorch's own kernels
(names holding ``at::native``: the optimizer's adds and masks, casts,
copies, fills) over the traced window's group steps, counted from the
plan."""


def read(ctx):
    steps = ctx["work"]["steps"]
    spent = sum(s for k, s in ctx["trace"]["kernels"].items()
                if "at::native" in k)
    if steps <= 0 or spent <= 0:
        return None
    return 1e3 * spent / steps
