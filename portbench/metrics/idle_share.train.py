"""% of a window traced on the card alone (a full trace's host events
stretch the window) in which no kernel ran on the card."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
