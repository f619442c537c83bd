"""Kernel-library cache + bucket warmup (port of
:mod:`multigrad_tpu.serve.compile_cache`).

The JAX package's cold start is an XLA compile of each bucket program,
which its persistent compilation cache and AOT warmup take off the
first request.  The port has no XLA program.  Its cold start is:

* building the kernel libraries with ``nvcc`` (once a machine, into the
  build directory of :mod:`multigrad_tpu_torch.ops.cuda_build`);
* loading them;
* growing the CUDA caching allocator to a bucket's size.

So the two halves here are:

* :func:`enable_compile_cache` makes a directory the one the kernel
  libraries are built into and loaded from, process-wide.  A directory
  that already holds libraries built from the same sources runs no
  ``nvcc``: a fleet shares one warm directory.
* :func:`warmup_buckets` builds and loads the libraries, then **runs**
  one Adam step and one finalize evaluation of each ``(FitConfig,
  bucket K)`` pair through the very wrapper the scheduler dispatches
  through (:func:`~multigrad_tpu_torch.inference.ensemble
  .batched_fit_wrapper`), on the model's real data, and discards the
  results.  The JAX package's warmup lowers and compiles without
  running; the port's executes, since there is nothing to compile but
  the libraries and nothing to grow but the allocator (ROADMAP.md,
  Queue 3's differences by design).

Typical service start::

    from multigrad_tpu_torch.serve import (FitScheduler, FitConfig,
                                           enable_compile_cache)

    enable_compile_cache("/var/cache/multigrad_kernels")  # process-wide
    sched = FitScheduler(model)
    sched.warmup(FitConfig(nsteps=500), ndim=2)
    ...serve...
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import torch

from .queue import FitConfig

__all__ = ["enable_compile_cache", "cache_entries", "warmup_buckets",
           "DEFAULT_BUCKETS"]

#: Quantized batch sizes the scheduler packs requests into: the
#: distinct ``(K, ndim)`` dispatches (and so the warm-up work) are
#: bounded by ``len(DEFAULT_BUCKETS)`` per fit config, not by the number
#: of requests served.
DEFAULT_BUCKETS = (1, 4, 16, 64)


def enable_compile_cache(cache_dir: Optional[str] = None,
                         min_compile_time_s: float = 0.0
                         ) -> Optional[str]:
    """Make ``cache_dir`` the directory the kernel libraries are built
    into and loaded from (process-wide; see
    :func:`multigrad_tpu_torch.ops.cuda_build.set_build_dir`), and
    return it.  With ``None``, return the current directory unchanged
    (by default ``build/multigrad_tpu_torch/`` beside the package).
    ``min_compile_time_s`` keeps the JAX package's signature and has no
    effect: every library is kept."""
    del min_compile_time_s
    from ..ops import cuda_build
    if cache_dir is None:
        return str(cuda_build.build_dir())
    return str(cuda_build.set_build_dir(cache_dir))


def cache_entries(cache_dir: Optional[str] = None) -> int:
    """Number of kernel libraries in ``cache_dir`` (default: the current
    build directory); 0 when it does not exist yet."""
    from ..ops import cuda_build
    path = cuda_build.build_dir() if cache_dir is None else Path(cache_dir)
    if not path.is_dir():
        return 0
    return len(list(path.glob("lib*.so")))


def _config_ndim(config: FitConfig, ndim: Optional[int]) -> int:
    if config.param_bounds is not None:
        return len(config.param_bounds)
    if ndim is None:
        raise ValueError(
            "warmup of an unbounded FitConfig needs ndim= (bounded "
            "configs derive it from their bounds)")
    return int(ndim)


def _warm_start(config: FitConfig, nd: int, device) -> torch.Tensor:
    """A ``(nd,)`` start strictly inside ``config``'s bounds: the image
    of the unbounded origin (the midpoint of two-sided bounds), zeros
    for an unbounded config."""
    from ..optim.transforms import bounds_to_arrays, inverse_transform_array
    zeros = torch.zeros(nd, dtype=torch.float32, device=device)
    if not config.bounded:
        return zeros
    low, high = bounds_to_arrays(config.bounds_list(), nd, device)
    return inverse_transform_array(zeros, low, high)


def warmup_buckets(model, configs, buckets=DEFAULT_BUCKETS,
                   ndim: Optional[int] = None,
                   donate_carry=None, k_sharded: bool = False) -> list:
    """Warm every ``(config, bucket)`` pair by running it.

    On a CUDA model, build (or find built) every kernel library first.
    Then, for each :class:`~multigrad_tpu_torch.serve.queue.FitConfig`
    and each bucket size K: one Adam step of a ``(K, ndim)`` batch
    through :func:`~multigrad_tpu_torch.optim.adam.run_adam_scan` and
    the cached :func:`~multigrad_tpu_torch.inference.ensemble
    .batched_fit_wrapper` (what a bucket dispatch runs), and one
    evaluation of the model's batched loss and gradient (the
    dispatch's finalize), on the model's real ``aux_leaves()``, from
    the bounds' midpoint (zeros for an unbounded config).  The results
    are discarded: nothing reaches a scheduler's stats, the model's
    state or a future.  This loads the libraries and grows the caching
    allocator to the bucket's size before the first request.

    Returns one ``{"nsteps", "learning_rate", "bucket", "k_sharded",
    "compile_s"}`` entry per pair, ``compile_s`` the wall seconds of
    that pair's run (the card's work included).  ``donate_carry`` is
    accepted and has no effect (a host loop has no carry to donate).
    ``k_sharded`` resolves as the scheduler's does: on an
    :func:`~multigrad_tpu_torch.parallel.ensemble_comm` a bucket the
    replica count divides warms the K-partitioned program and carry (a
    collective run: every process of the comm makes the call), and
    ``True`` raises ``ValueError`` without a replica axis.
    """
    from ..inference.ensemble import (batched_fit_wrapper,
                                      k_shards_bucket,
                                      resolve_k_shard_topology)
    from ..optim import adam as _adam
    from ..optim.adam import init_randkey

    del donate_carry
    k_sharded, n_replicas = resolve_k_shard_topology(model, k_sharded)
    if isinstance(configs, FitConfig):
        configs = [configs]
    device = model.device
    if device.type == "cuda":
        from ..ops import cuda_build
        cuda_build.build()
    dynamic = model.aux_leaves()
    entries = []
    for config in configs:
        nd = _config_ndim(config, ndim)
        start = _warm_start(config, nd, device)
        key = init_randkey(config.randkey) if config.with_key else 0
        for bucket in sorted(set(int(b) for b in buckets)):
            sharded = k_shards_bucket(bucket, k_sharded, n_replicas)
            ks = model.k_sharding(2) if sharded else None
            wrapper = batched_fit_wrapper(model, config.with_key,
                                          k_sharded=sharded)
            loss_program = model.batched_loss_and_grad_fn(
                config.with_key, k_sharded=sharded)
            t0 = time.perf_counter()
            with torch.no_grad():
                inits = start.expand(bucket, nd).clone()
                traj = _adam.run_adam_scan(
                    wrapper, inits, nsteps=1,
                    param_bounds=config.bounds_list(),
                    learning_rate=config.learning_rate,
                    randkey=config.randkey,
                    const_randkey=config.const_randkey, progress=False,
                    fn_args=(dynamic,), carry_sharding=ks)
                finals = traj[-1] if ks is None else ks.local(traj[-1])
                losses, _ = loss_program(finals, dynamic, key)
                # One read back: the pair's time includes the card's
                # work, and the run is complete before the next.
                losses.cpu()
            entries.append({
                "nsteps": config.nsteps,
                "learning_rate": config.learning_rate,
                "bucket": bucket,
                "k_sharded": sharded,
                "compile_s": round(time.perf_counter() - t0, 4),
            })
    return entries
