"""``adam.step_host_ms``: the host's work in a step of ``run_adam``'s loop
(the span ``mgt.adam.step``: its length less the time the host waited on
the card inside it), over the traced window's steps, in ms
(:func:`perfbench.core.spans.host_work_ms`)."""
from perfbench.core.spans import host_work_ms


def read(ctx):
    return host_work_ms(ctx, "mgt.adam.step")
