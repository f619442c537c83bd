"""``adam.update_host_ms``: the host's work in a step's Adam update (the
span ``mgt.adam.update``) over the traced window's steps, in ms
(:func:`perfbench.core.spans.host_work_ms`)."""
from perfbench.core.spans import host_work_ms


def read(ctx):
    return host_work_ms(ctx, "mgt.adam.update")
