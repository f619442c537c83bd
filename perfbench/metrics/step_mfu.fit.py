"""``step_mfu.fit``: the traced fit's float32 operations (its steps and
the loss read at its end) over the traced window times the H100's FP32
peak, in percent (:func:`perfbench.core.readers.step_mfu`)."""
from perfbench.core.readers import step_mfu


def read(ctx):
    return step_mfu(ctx)
