"""``erf_fwd_roofline``: the dense erf forward kernel's share of its
roofline in the traced window (``core/readers.py``)."""
from perfbench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "erf_fwd")
