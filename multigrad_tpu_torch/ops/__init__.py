"""Sumstat ops: the dense and fused erf-CDF counts, the pair counts and
their CUDA kernels (``binned_erf_counts`` and ``ring_weighted_pair_counts``
reach the kernels on CUDA tensors and their plain versions on CPU
tensors).

The names are imported at first use: ``parallel/`` imports
:mod:`.kernel_costs`, which runs this file, and :mod:`.pairwise` imports
``parallel/``.
"""
import importlib

_EXPORTS = {
    "binned_density": "binned", "binned_density_jit": "binned",
    "binned_erf_counts": "binned", "fused_bin_window": "binned",
    "norm_cdf": "binned", "analytic_rr_counts": "pairwise",
    "ring_weighted_pair_counts": "pairwise", "wp_from_counts": "pairwise",
    "xi_from_counts": "pairwise",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
