"""``hist.history_ms_per_step``: the device time of the history kernels
(the span ``mgt.hist.history`` around their forward launch, their
backward by its autograd node) inside the steps of the traced window,
over the steps, in ms (:func:`perfbench.core.spans.device_ms_per`)."""
from perfbench.core.spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mgt.hist.history", per="mgt.adam.step")
