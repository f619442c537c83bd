"""Optimizers (Adam, L-BFGS-B, L-BFGS) and the bounds bijections."""
from .adam import (gen_new_key, init_randkey, run_adam,  # noqa: F401
                   run_adam_scan, run_adam_unbounded)
from .bfgs import run_bfgs, run_lbfgs_scan  # noqa: F401
from .transforms import (apply_inverse_transforms,  # noqa: F401
                         apply_transforms, bounds_to_arrays,
                         inverse_transform, inverse_transform_array,
                         inverse_transform_diag_jacobian, transform,
                         transform_array)

__all__ = [
    "run_adam", "run_adam_scan", "run_adam_unbounded", "run_bfgs",
    "run_lbfgs_scan", "init_randkey", "gen_new_key",
    "transform", "inverse_transform", "apply_transforms",
    "apply_inverse_transforms", "transform_array",
    "inverse_transform_array", "inverse_transform_diag_jacobian",
    "bounds_to_arrays",
]
