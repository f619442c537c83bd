"""multigrad_tpu_torch — the PyTorch and CUDA port of multigrad_tpu.

Fits differentiable models whose summary statistics add up over data
shards, with communication O(|sumstats| + |params|) whatever the size
of the data, on NVIDIA GPUs.  The JAX package ``multigrad_tpu`` is the
reference; this package keeps its module layout and public names for
what is ported, and imports no JAX.

Its entry points run on the card: ``device=None`` means ``"cuda"``.
The hot op, the dense erf-CDF binned counts, runs as two hand-written
CUDA kernels (``csrc/erf_counts.cu``) on CUDA tensors and as their
plain PyTorch versions on CPU tensors.
"""
from .parallel.mesh import MeshComm, global_comm  # noqa: F401
from .parallel.collectives import reduce_sum, scatter_nd  # noqa: F401
from .core.model import OnePointModel  # noqa: F401
from .optim.adam import gen_new_key, init_randkey, run_adam  # noqa: F401
from .optim.bfgs import run_bfgs  # noqa: F401
from .optim.transforms import (apply_inverse_transforms,  # noqa: F401
                               apply_transforms, inverse_transform,
                               transform)
from .utils import util  # noqa: F401
from .utils.util import (GradDescentResult,  # noqa: F401
                         latin_hypercube_sampler, simple_grad_descent)

__all__ = [
    "OnePointModel", "reduce_sum", "util",
    "MeshComm", "global_comm", "scatter_nd",
    "run_adam", "run_bfgs", "simple_grad_descent", "GradDescentResult",
    "latin_hypercube_sampler",
    "transform", "inverse_transform", "apply_transforms",
    "apply_inverse_transforms", "init_randkey", "gen_new_key",
]
