"""Cost-model-driven autotuner: make the fast path the default path (port
of :mod:`multigrad_tpu.tune`).

The perf knobs — ``bin_mode``/``bin_window`` (fused scatter-into-bins),
chunk size, ``remat_policy``, the serve bucket ladder — depend on the
data and the hardware, and the JAX package's verdicts are a TPU's; only
a tuner that measures on the card can set them here.  The loop, over the
static cost model (:func:`~multigrad_tpu_torch.telemetry.costmodel
.model_cost` + :data:`~multigrad_tpu_torch.telemetry.costmodel
.DEVICE_SPECS` + :func:`~multigrad_tpu_torch.telemetry.costmodel
.roofline_record`):

* :mod:`.space` — enumerate the knob space for a model or workload;
* :mod:`.tuner` — **prune statically** (per-candidate roofline
  prediction on meta tensors, zero device work), **confirm the
  survivors with short measured trials** on the card (warmed, best of
  N, the launch-and-read floor subtracted, noise-aware ranking), and
  emit every decision as a ``tune`` telemetry record;
* :mod:`.table` — persist the winner per **(model class, catalog-shape
  bucket, backend, device kind)** in an on-disk :class:`TuningTable`
  beside the kernel-library directory, so a fresh process (or a fleet
  worker sharing the directory) starts tuned — a warm table resolves
  every knob with zero measured trials;
* :mod:`.resolve` — the ``"auto"`` hooks consumers call:
  ``bin_mode="auto"`` / ``chunk_size="auto"`` on the models,
  ``chunk_rows="auto"`` / ``remat_policy="auto"`` on streaming,
  ``buckets="auto"`` on the serve scheduler.  Cold-table resolution is
  exactly the hand-set default.

One-shot::

    python -m multigrad_tpu_torch.tune            # the SMF workload on
                                                  # the card, TUNE OK
    python -m multigrad_tpu_torch.tune --device cpu

or in process::

    from multigrad_tpu_torch.tune import tune_model
    res = tune_model(model, params, sigma_max=0.32)
    model = model.replace_aux(bin_mode="auto")   # now resolves tuned

Pin any knob to a concrete value to opt out — ``"auto"`` is the only
value resolution touches.
"""
from .table import (TuningTable, default_table_path,  # noqa: F401
                    make_key, model_shape_key, rows_bucket)
from .space import (bucket_candidates,  # noqa: F401
                    model_candidates, streaming_candidates,
                    DEFAULT_BUCKET_CANDIDATES,
                    SHARDED_BUCKET_CANDIDATES)
from .tuner import (TuneResult, tune_model, tune_buckets,  # noqa
                    tune_streaming, within_noise, measure_rtt)
from .resolve import (resolve_auto_aux,  # noqa: F401
                      resolve_buckets, resolve_donate_carry,
                      resolve_op_bin_mode, resolve_stream_knobs)

__all__ = [
    "TuningTable", "default_table_path", "make_key",
    "model_shape_key", "rows_bucket",
    "model_candidates", "streaming_candidates",
    "bucket_candidates", "DEFAULT_BUCKET_CANDIDATES",
    "SHARDED_BUCKET_CANDIDATES",
    "TuneResult", "tune_model", "tune_buckets", "tune_streaming",
    "within_noise", "measure_rtt",
    "resolve_auto_aux", "resolve_buckets", "resolve_donate_carry",
    "resolve_op_bin_mode", "resolve_stream_knobs",
]
