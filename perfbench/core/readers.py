"""What several per-layer readers share."""
from __future__ import annotations

from perfbench.costs import erf


def idle_share(ctx):
    """The device's idle share of the traced window, in percent."""
    if not ctx.on_card or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def step_mfu(ctx):
    """The float32 operations of the work that the driver counted in the
    traced window (``traced_evaluations`` loss-and-gradient evaluations
    and ``traced_forwards`` losses alone, costed from the model's
    equations by ``costs/<model>.py``) over the window's length times the
    H100's FP32 peak, in percent."""
    counters = ctx.record.counters
    evaluations = counters.get("traced_evaluations")
    if not ctx.on_card or not evaluations:
        return None
    ops = (evaluations * ctx.costs.step_flops()
           + counters.get("traced_forwards", 0) * ctx.costs.forward_flops())
    return 100.0 * ops / (ctx.trace["window_s"] * erf.FP32_OPS_PER_S)


def roofline(ctx, kernel: str):
    """The share of its roofline that the kernel ``<kernel>_kernel`` (the
    erf kernels: ``erf_fwd``, ``erf_bwd``) reached over its launches in
    the traced window, in percent: the launches' least time at the peaks
    over their device time."""
    if not ctx.on_card:
        return None
    shape = ctx.costs.kernel(kernel)
    seconds, launches = 0.0, 0
    for name, (s, n) in ctx.trace["kernels"].items():
        if f"{kernel}_kernel" in name:
            seconds += s
            launches += n
    if shape is None or not launches or seconds <= 0:
        return None
    n, edges, vec = shape
    ops = getattr(erf, f"{kernel[4:]}_ops")(n, edges, vec)
    nbytes = getattr(erf, f"{kernel[4:]}_bytes")(n, edges, vec)
    return 100.0 * launches * erf.bound_s(ops, nbytes) / seconds
