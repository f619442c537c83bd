"""multigrad_tpu_torch — the PyTorch and CUDA port of multigrad_tpu.

Fits differentiable models whose summary statistics add up over data
shards, with communication O(|sumstats| + |params|) whatever the size
of the data, on NVIDIA GPUs.  The JAX package ``multigrad_tpu`` is the
reference; this package keeps its module layout and public names for
what is ported, and imports no JAX.

Its entry points run on the card: ``device=None`` means ``"cuda"``.
Several models fit jointly through ``OnePointGroup`` (``param_view``
gives each a slice of the joint parameters; ``models.joint`` builds the
joint SMF + wp(rp) fit), and Adam checkpoints and resumes
(``checkpoint_dir``).  ``data`` streams catalogs larger than the card
through a fit in chunks (``StreamingOnePointModel``, exact two-pass
loss and gradient, a double-buffered prefetcher over pinned memory and
a copy stream); ``inference`` gives Fisher matrices, resident or
streamed, multi-start Adam ensembles with their L-BFGS polish
(``run_lbfgs_scan``: optax's L-BFGS and zoom line search, written out)
and multi-chain HMC, through a model's ``(K, ndim)`` batched loss and
gradient.  ``parallel.distributed.initialize`` brings the process group
up from a launcher's environment, each process on its card.
``telemetry`` watches the fits: records every ``log_every`` steps copied
off the card without a wait, a NaN sentinel and postmortem bundles,
comm bytes counted, a live HTTP endpoint, alert rules and
``torch.profiler`` fit profiles.  ``serve`` serves fits: a
``FitScheduler`` packs many tenants' requests into batched buckets on
the card, ``python -m multigrad_tpu_torch.serve.worker`` puts one
behind the JAX package's wire, a ``FleetRouter`` routes over several
such workers with requeue on a lost one, and a ``JobRunner`` runs a
whole posterior pipeline (scan, ensemble, Laplace, HMC, check) as one
job.  ``tune`` sets the perf knobs (``bin_mode``, chunk sizes, the
bucket ladder) from short trials on the card, pruned by the static cost
model, and keeps the winners in a table beside the kernel libraries:
``"auto"`` resolves to them.  The hot
op, the erf-CDF binned counts of the SMF and galaxy–halo models, runs as
hand-written CUDA kernels on CUDA tensors and as their plain PyTorch
versions on CPU tensors: the dense counts with a scalar or a
per-particle sigma (``csrc/erf_counts.cu``) and the fused windowed
counts (``csrc/fused_counts.cu``: window start, masses and their scatter
into bins in one launch), forward and backward.  The history model's
integration is PyTorch ops on either device.
"""
from ._version import __version__  # noqa: F401
from .parallel.mesh import (MeshComm, global_comm,  # noqa: F401
                            hybrid_comm, split_subcomms,
                            split_subcomms_by_node)
from .parallel.collectives import (all_gather, reduce_sum,  # noqa: F401
                                   scatter_from_local, scatter_nd)
from .parallel import distributed  # noqa: F401
from .core.model import OnePointModel  # noqa: F401
from .core.group import OnePointGroup, param_view  # noqa: F401
from .optim.adam import (gen_new_key, init_randkey,  # noqa: F401
                         run_adam, run_adam_scan, run_adam_unbounded)
from .optim.bfgs import run_bfgs, run_lbfgs_scan  # noqa: F401
from .optim.transforms import (apply_inverse_transforms,  # noqa: F401
                               apply_transforms, inverse_transform,
                               transform)
from .utils import diffdesi, util  # noqa: F401
from .utils.util import (GradDescentResult,  # noqa: F401
                         latin_hypercube_sampler, simple_grad_descent,
                         simple_grad_descent_scan)
from . import data  # noqa: F401
from .data import (ArraySource, CatalogSource,  # noqa: F401
                   ChunkPrefetcher, MemmapSource, NpzSource,
                   StreamingOnePointModel)
from . import inference  # noqa: F401
from .inference import (EnsembleResult, FisherResult,  # noqa: F401
                        HMCResult, ensemble_memory_model,
                        fisher_information, hmc_init_from_ensemble,
                        laplace_covariance, max_k_for_budget, run_hmc,
                        run_multistart_adam, run_multistart_lbfgs,
                        sumstats_jacobian)
from . import telemetry  # noqa: F401
from .telemetry import (AlertEngine, CommCounter, FlightRecorder,  # noqa
                        FlightRecorderTripped, Heartbeat, JsonlSink,
                        LiveMetrics, LiveServer, MemorySink,
                        MetricsLogger, ScalarTap, measure_model_comm,
                        profiled_fit, run_record)
from . import serve  # noqa: F401
from .serve import *  # noqa: F401,F403  (serve.__all__)
from . import tune  # noqa: F401
from .tune import (TuneResult, TuningTable, tune_buckets,  # noqa: F401
                   tune_model, tune_streaming)

__all__ = [
    "OnePointModel", "OnePointGroup", "param_view", "reduce_sum", "util",
    "MeshComm", "global_comm", "hybrid_comm", "split_subcomms",
    "split_subcomms_by_node", "all_gather", "scatter_nd",
    "scatter_from_local", "distributed", "diffdesi",
    "run_adam", "run_adam_scan", "run_adam_unbounded", "run_bfgs",
    "run_lbfgs_scan", "simple_grad_descent",
    "simple_grad_descent_scan", "GradDescentResult",
    "latin_hypercube_sampler",
    "transform", "inverse_transform", "apply_transforms",
    "apply_inverse_transforms", "init_randkey", "gen_new_key",
    "data", "StreamingOnePointModel", "CatalogSource", "ArraySource",
    "NpzSource", "MemmapSource", "ChunkPrefetcher",
    "inference", "FisherResult", "fisher_information",
    "laplace_covariance", "sumstats_jacobian", "HMCResult", "run_hmc",
    "EnsembleResult", "run_multistart_adam", "run_multistart_lbfgs",
    "hmc_init_from_ensemble", "ensemble_memory_model", "max_k_for_budget",
    "telemetry", "MetricsLogger", "JsonlSink", "MemorySink", "ScalarTap",
    "CommCounter", "Heartbeat", "measure_model_comm", "run_record",
    "FlightRecorder", "FlightRecorderTripped", "profiled_fit",
    "LiveMetrics", "LiveServer", "AlertEngine",
    "serve", *serve.__all__,
    "tune", "TuneResult", "TuningTable", "tune_model", "tune_buckets",
    "tune_streaming",
    "__version__",
]
