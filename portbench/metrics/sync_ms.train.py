"""ms a round: the program blocked in readbacks (the sum of its spans
``<section>.sync``: every ``.cpu()``, ``bool()`` of a device tensor and
synchronize of the update and the central evaluation, host clock), the
mean over the untraced rounds."""

from portbench.readers import mean_ms


def _sync(sections):
    spans = [v for k, v in sections.items() if k.endswith(".sync")]
    return sum(spans) if spans else None


def read(ctx):
    return mean_ms(_sync(r["sections"]) for r in ctx["records"])
