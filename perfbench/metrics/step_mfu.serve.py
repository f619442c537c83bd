"""``step_mfu.serve``: the float32 operations of the rows served in the
traced window (``nsteps + 1`` evaluations a row, as the driver counts
them from its fits, not from the program's launches) over the window
times the H100's FP32 peak, in percent
(:func:`perfbench.core.readers.step_mfu`)."""
from perfbench.core.readers import step_mfu


def read(ctx):
    return step_mfu(ctx)
