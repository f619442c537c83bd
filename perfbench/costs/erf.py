"""The dense erf-CDF kernels' operations and bytes, and the H100's peaks.

A frozen copy of ``multigrad_tpu_torch/ops/kernel_costs.py``'s counts,
read off ``csrc/erf_counts.cu`` (float32 operations per particle and
edge), so that a change to the program cannot move the yardstick.

The forward, one cdf: z (2), clamp (2), x² (1), P and Q by Horner (6 and
4 FMAs: 20), x·P (1), /Q (1), 0.5·(1 + erf) (2) = 29, plus 2 a bin for
the difference and the sum.  The backward: z (2), z² (1), expf (1),
dv += h·P (2), ΣP (1), P·z (1), hpz += h·Pz (2) = 10 an edge.  With a
per-particle sigma each particle also forms inv_i (2); the backward
weights each row term by inv_i (+1 an edge) and scales dv and dsigma (5).

Bytes count each input read once and each output written once: the
particles' values (and sigmas), the edges and the cotangent in, the
counts (or the particles' gradients and the edges') out.
"""
from __future__ import annotations

#: H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): FP32 operations
#: a second outside the tensor cores, and device memory bytes a second.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

FWD_OPS_PER_CDF, FWD_OPS_PER_BIN, BWD_OPS_PER_EDGE = 29, 2, 10
INV_OPS, VEC_BWD_OPS_PER_EDGE, VEC_BWD_OPS = 2, 11, 5
F32 = 4


def fwd_ops(n: int, edges: int, vec: bool) -> int:
    per = FWD_OPS_PER_CDF * edges + FWD_OPS_PER_BIN * (edges - 1)
    return n * (per + (INV_OPS if vec else 0))


def bwd_ops(n: int, edges: int, vec: bool) -> int:
    if vec:
        return n * (VEC_BWD_OPS_PER_EDGE * edges + INV_OPS + VEC_BWD_OPS)
    return n * BWD_OPS_PER_EDGE * edges


def fwd_bytes(n: int, edges: int, vec: bool) -> int:
    """Values (and sigmas) and edges in, counts out."""
    return F32 * (n * (2 if vec else 1) + edges + (edges - 1))


def bwd_bytes(n: int, edges: int, vec: bool) -> int:
    """Values (and sigmas), edges and the counts' cotangent in; the
    values' (and sigmas') gradients and the edges' out (a scalar sigma's
    gradient is one number)."""
    per = 2 if vec else 1
    return F32 * (2 * n * per + edges + (edges - 1) + edges + 1)


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory's peak."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
