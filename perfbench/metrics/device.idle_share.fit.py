"""``device.idle_share.fit``: the card's idle share of the traced fit."""
from perfbench.core.readers import idle_share


def read(ctx):
    return idle_share(ctx)
