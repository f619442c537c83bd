"""Sumstat ops: the dense erf-CDF counts and their CUDA kernels."""
