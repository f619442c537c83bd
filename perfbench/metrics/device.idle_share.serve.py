"""``device.idle_share.serve``: the card's idle share of the traced
dispatch."""
from perfbench.core.readers import idle_share


def read(ctx):
    return idle_share(ctx)
