"""Operation counts of the CUDA kernels and the H100's peaks: the one
count that the static cost model (:mod:`multigrad_tpu_torch.telemetry
.costmodel`) and ``chip_smoke.py``'s bound of each kernel share.

The counts are float32 operations read off ``csrc/*.cu``, per particle
and edge (or window slot, or pair).  The dense erf forward, one cdf: z
(2), clamp (2), x² (1), P and Q by Horner (6 and 4 FMAs: 20), x·P (1),
/Q (1), 0.5·(1+erf) (2) = 29, plus 2 per bin for the difference and the
sum.  The dense backward: z (2), z² (1), expf (1), dv += h·P (2), ΣP (1),
P·z (1), hpz += h·Pz (2) = 10.  With a per-particle sigma each particle
also forms inv_i (2); the dense backward weights each row term by inv_i
(+1 per edge) and scales dv and dsigma (5).  The fused backward per slot:
h (1), z (2), z² (1), expf (1), h·P (1), dv += (1), hz += h·P·z (2) = 9;
per particle inv and the scaling of dv and dsigma (7, 5 with a scalar
sigma).  The fused window start: the clip, x = v − half·sigma (3), a
compare and a select per step of the search over E edges (2·⌈log2 E⌉),
the clip to [0, E−W] (2).  The pair kernels, per pair: the differences
(3), the minimum image with a box (9: |d|, a compare and a subtract a
coordinate), squares and sums (3 projected, 5 in 3D), the pi cut when
projected (2), the range test (2) — 19 with a box; per pair inside the
bins' range, 3 per bin (two compares and a predicated add); per row, 2
per bin for ``dw = Σ_b g_b R_b`` (the row gradient, the sweep's end).

The pairs in the bins' range depend on the data; a count made without
the data (the cost model's, on meta tensors) leaves them out, so it is a
floor of the kernels' work.
"""
from __future__ import annotations

import math

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "erf_fwd_ops",
           "erf_bwd_ops", "fused_fwd_ops", "fused_bwd_ops",
           "pair_ops_per_pair", "pair_fwd_ops", "pair_rowgrad_ops",
           "pair_bwd_ops", "counting_mode", "declare_kernel"]

#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): device memory
#: bytes a second and FP32 operations a second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

FWD_OPS_PER_CDF, FWD_OPS_PER_BIN, BWD_OPS_PER_EDGE = 29, 2, 10
INV_OPS, VEC_BWD_OPS_PER_EDGE, VEC_BWD_OPS = 2, 11, 5
FUSED_BWD_OPS_PER_SLOT, FUSED_BWD_OPS, FUSED_BWD_OPS_SCALAR = 9, 7, 5
PAIR_OPS, PAIR_OPS_PER_BIN, PAIR_ROW_OPS_PER_BIN = 19, 3, 2


def erf_fwd_ops(n: int, n_edges: int, vec: bool) -> int:
    """The dense forward's operations for ``n`` particles."""
    per = FWD_OPS_PER_CDF * n_edges + FWD_OPS_PER_BIN * (n_edges - 1)
    return n * (per + (INV_OPS if vec else 0))


def erf_bwd_ops(n: int, n_edges: int, vec: bool) -> int:
    """The dense backward's operations for ``n`` particles."""
    if vec:
        return n * (VEC_BWD_OPS_PER_EDGE * n_edges + INV_OPS + VEC_BWD_OPS)
    return n * BWD_OPS_PER_EDGE * n_edges


def window_search_ops(n_edges: int) -> int:
    """A particle's fused window start over ``n_edges`` edges."""
    return 5 + 2 * math.ceil(math.log2(n_edges))


def fused_fwd_ops(n: int, n_edges: int, window: int, vec: bool) -> int:
    """The fused forward's operations: the window start, ``window`` cdfs,
    ``window - 1`` differences and adds into the bins a particle."""
    per = (FWD_OPS_PER_CDF * window + 2 * (window - 1)
           + window_search_ops(n_edges))
    return n * (per + (INV_OPS if vec else 0))


def fused_bwd_ops(n: int, n_edges: int, window: int, vec: bool) -> int:
    """The fused backward's operations for ``n`` particles."""
    return n * (FUSED_BWD_OPS_PER_SLOT * window
                + (FUSED_BWD_OPS if vec else FUSED_BWD_OPS_SCALAR)
                + window_search_ops(n_edges))


def pair_ops_per_pair(box: bool) -> int:
    """A pair's separation and range test: 19 with a box, 10 without
    (projected or 3D, the same count)."""
    return 3 + (9 if box else 0) + 5 + 2


def pair_fwd_ops(n1: int, n2: int, n_bins: int, box: bool = True,
                 in_range: int = 0) -> int:
    """The pair forward's operations: every pair's separation, and the
    bins of the ``in_range`` pairs inside the bins' range."""
    return (n1 * n2 * pair_ops_per_pair(box)
            + in_range * PAIR_OPS_PER_BIN * n_bins)


def pair_rowgrad_ops(n1: int, n_bins: int) -> int:
    """``dw1 = Σ_b g_b R_b`` over ``n1`` rows."""
    return PAIR_ROW_OPS_PER_BIN * n_bins * n1


def pair_bwd_ops(n1: int, n2: int, n_bins: int, box: bool = True,
                 in_range: int = 0) -> int:
    """The sweep over the pairs for ``dw1`` (``n1`` rows)."""
    return (pair_fwd_ops(n1, n2, n_bins, box, in_range)
            + pair_rowgrad_ops(n1, n_bins))


def counting_mode(what: str):
    """The active counting mode of the cost model
    (:func:`~multigrad_tpu_torch.telemetry.costmodel
    .estimate_program_cost`), found on the dispatch-mode stack, which
    autograd carries into the thread that runs a backward pass.  Meta
    tensors reach a kernel or a collective only inside it: ``what``
    raises elsewhere, and never falls through to a plain version."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "declare_kernel"):
            return mode
    raise RuntimeError(
        f"{what}: meta tensors reach a kernel or a collective only inside "
        "the static cost model (telemetry.costmodel.estimate_program_cost "
        "/ model_cost)")


def declare_kernel(name: str, flops: float, **transcendentals):
    """Count one kernel call met with meta tensors: its operations and
    transcendental elements go to the :func:`counting_mode`."""
    counting_mode(name).declare_kernel(name, flops, transcendentals)
