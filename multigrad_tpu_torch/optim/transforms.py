"""Parameter-bounds bijections, bounded <-> unbounded space (port of
:mod:`multigrad_tpu.optim.transforms`).

Two-sided bounds use the tan/arctan bijection, one-sided bounds the
shifted-reciprocal/sqrt bijection, and unbounded parameters pass
through.  Bounds are ``(low, high)`` float32 tensors with ±inf for open
ends; every transform is branchless (``torch.where``) and elementwise,
so its Jacobian is diagonal and computed analytically.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.util import resolve_device


def bounds_to_arrays(param_bounds: Optional[Sequence], ndim: int,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize a sequence of ``None | (low, high)`` (``None`` entries
    for open ends) into ``(low, high)`` float32 tensors with ±inf."""
    low = np.full(ndim, -np.inf)
    high = np.full(ndim, np.inf)
    if param_bounds is not None:
        if hasattr(param_bounds, "tolist"):
            param_bounds = param_bounds.tolist()
        if len(param_bounds) != ndim:
            raise ValueError(
                "param_bounds must have one entry per parameter: "
                f"got {len(param_bounds)} bounds for ndim={ndim}")
        for i, b in enumerate(param_bounds):
            if b is None:
                continue
            lo, hi = b
            low[i] = -np.inf if lo is None or not np.isfinite(lo) else lo
            high[i] = np.inf if hi is None or not np.isfinite(hi) else hi
    device = resolve_device(device)
    return (torch.as_tensor(low, dtype=torch.float32, device=device),
            torch.as_tensor(high, dtype=torch.float32, device=device))


def check_strictly_inside(params, low, high, param_bounds) -> None:
    """Reject a guess on or outside its bounds: a boundary point maps to
    ±inf through the bijections."""
    p = np.asarray(torch.as_tensor(params).detach().cpu())
    lo, hi = np.asarray(low.cpu()), np.asarray(high.cpu())
    if not (np.all(p > lo) and np.all(p < hi)):
        raise ValueError(
            f"guess {p.tolist()} must lie strictly inside param_bounds "
            f"{param_bounds} (the bounds bijection maps boundary "
            "points to infinity)")


def _branch_masks(low, high):
    finite_low = torch.isfinite(low)
    finite_high = torch.isfinite(high)
    return (finite_low & finite_high, finite_low & ~finite_high,
            ~finite_low & finite_high)


def _two_sided(low, high, both):
    l2 = torch.where(both, low, 0.0)
    h2 = torch.where(both, high, 1.0)
    return 0.5 * (h2 + l2), (h2 - l2) / math.pi


def transform_array(params, low, high):
    """Map bounded params to unbounded space, elementwise.  Inputs to
    inactive branches are sanitized first so no branch makes a NaN."""
    both, lo_only, hi_only = _branch_masks(low, high)
    mid, scale = _two_sided(low, high, both)
    p2 = torch.where(both, params, 0.5)
    t_both = scale * torch.tan((p2 - mid) / scale)
    lL = torch.where(lo_only, low, 0.0)
    pL = torch.where(lo_only, params, 1.0)
    t_low = pL - lL + 1.0 / (lL - pL)
    hH = torch.where(hi_only, high, 1.0)
    pH = torch.where(hi_only, params, 0.0)
    t_high = pH - hH + 1.0 / (hH - pH)
    return torch.where(both, t_both, torch.where(
        lo_only, t_low, torch.where(hi_only, t_high, params)))


def inverse_transform_array(uparams, low, high):
    """Map unbounded params back into their bounds, elementwise."""
    both, lo_only, hi_only = _branch_masks(low, high)
    mid, scale = _two_sided(low, high, both)
    p_both = mid + scale * torch.atan(uparams / scale)
    root = torch.sqrt(uparams ** 2 + 4.0)
    p_low = 0.5 * (2.0 * torch.where(lo_only, low, 0.0) + uparams + root)
    p_high = 0.5 * (2.0 * torch.where(hi_only, high, 1.0) + uparams - root)
    return torch.where(both, p_both, torch.where(
        lo_only, p_low, torch.where(hi_only, p_high, uparams)))


def inverse_transform_diag_jacobian(uparams, low, high):
    """d(inverse_transform)/d(uparams), elementwise and analytic (the
    bijection is separable, so its Jacobian is diagonal)."""
    both, lo_only, hi_only = _branch_masks(low, high)
    _, scale = _two_sided(low, high, both)
    d_both = 1.0 / (1.0 + (uparams / scale) ** 2)
    slope = uparams / torch.sqrt(uparams ** 2 + 4.0)
    return torch.where(both, d_both, torch.where(
        lo_only, 0.5 * (1.0 + slope),
        torch.where(hi_only, 0.5 * (1.0 - slope),
                    torch.ones_like(uparams))))


# --------------------------------------------------------------------- #
# Scalar parity API (signatures of the reference's adam.py)
# --------------------------------------------------------------------- #
def _as_float(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device_of(x, device):
    return x.device if isinstance(x, torch.Tensor) else device


def apply_transforms(params, bounds, device=None):
    """Vectorized transform over a bounds list."""
    low, high = bounds_to_arrays(bounds, len(params),
                                 _device_of(params, device))
    return transform_array(_as_float(params, low.device), low, high)


def apply_inverse_transforms(uparams, bounds, device=None):
    """Vectorized inverse over a bounds list."""
    low, high = bounds_to_arrays(bounds, len(uparams),
                                 _device_of(uparams, device))
    return inverse_transform_array(_as_float(uparams, low.device), low,
                                   high)


def _scalar_bounds(bounds, device):
    low = -np.inf if bounds[0] is None else bounds[0]
    high = np.inf if bounds[1] is None else bounds[1]
    return _as_float(low, device), _as_float(high, device)


def transform(param, bounds, device=None):
    """Transform one param into unbounded space."""
    device = resolve_device(_device_of(param, device))
    if bounds is None:
        return _as_float(param, device)
    low, high = _scalar_bounds(bounds, device)
    return transform_array(_as_float(param, device), low, high)


def inverse_transform(uparam, bounds, device=None):
    """Transform one unbounded param back into its bounds."""
    device = resolve_device(_device_of(uparam, device))
    if bounds is None:
        return _as_float(uparam, device)
    low, high = _scalar_bounds(bounds, device)
    return inverse_transform_array(_as_float(uparam, device), low, high)
