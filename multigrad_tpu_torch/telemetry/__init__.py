"""Telemetry: taps, run records, comm accounting, liveness, postmortems,
the live endpoint, alerts and fit profiles (port of the compute-facing
part of :mod:`multigrad_tpu.telemetry`).

One record stream, many sinks:

* :mod:`.metrics` — :class:`MetricsLogger` with pluggable sinks
  (:class:`JsonlSink`, :class:`CsvSink`, :class:`MemorySink`) and the
  :func:`run_record` provenance header (torch and CUDA versions, the
  card).
* :mod:`.taps` — :class:`ScalarTap`: throttled scalars out of the fit
  loops (``optim/adam``, ``inference/hmc``) through deferred copies
  into pinned host memory, so the host never waits for the card inside
  a step.
* :mod:`.comm` — :class:`CommCounter`: the payload of every collective
  the port runs, counted where it runs; the measured check of the
  paper's O(|sumstats| + |params|) claim (:func:`measure_model_comm`).
* :mod:`.spans` — nestable wall-clock :func:`span` records plus the
  :class:`Heartbeat` liveness/stall detector for long host loops.
* :mod:`.flight` — :class:`FlightRecorder`: a bounded record ring that
  dumps self-contained postmortem bundles on NaN/Inf (a latch on the
  device, :class:`NonFiniteSentinel`), heartbeat stalls or divergence
  spikes; fits raise :class:`FlightRecorderTripped` with the bundle
  path.
* :mod:`.live` — :class:`LiveMetrics`, :class:`LiveSink` and
  :class:`LiveServer` (``/metrics``, ``/status``, ``/healthz``); pass
  ``live=`` to any fit entry point.
* :mod:`.alerts` — declarative non-fatal alert rules
  (:class:`AlertEngine`, ``alerts=``).
* :mod:`.report` — ``python -m multigrad_tpu_torch.telemetry.report
  run.jsonl``.
* :mod:`.costmodel` — :func:`model_cost` / :func:`estimate_program_cost`:
  operations, transcendentals and bytes of a program counted on meta
  tensors (the kernels declare their own counts), folded against the
  card's roofline (:func:`predicted_time_s`, :func:`roofline_record`).
* :mod:`.profile` — :func:`profiled_fit`: ``torch.profiler`` capture
  scoped to a fit, parsed into per-kernel device time.

The serving layer's telemetry (:mod:`multigrad_tpu_torch.serve`):

* :mod:`.tracing` — :class:`TraceContext` (W3C ``traceparent``) and
  :class:`Tracer`: every served request's hops as ``trace_span``
  records under one trace id.
* :mod:`.resources` — :class:`ResourceMonitor`: host RSS, the CUDA
  caching allocator's device memory (never initialising CUDA), the
  dispatch duty cycle and kernel-build accounting, exported as
  ``multigrad_resource_*`` gauges; :func:`autoscaler_inputs`,
  :func:`measured_vs_modeled`.
* :mod:`.rollup` — :class:`RollupStore`: windowed history fed from the
  scheduler's settle paths and the ``multigrad_rollup_*`` signals.
* :mod:`.budget` — :class:`SloBudget` error budgets over the declared
  SLOs and the :class:`BurnRateAlert` rule.

The fleet-watching CLIs (stdlib copies of the JAX package's):

* :mod:`.aggregate` — cross-rank JSONL merge, span skew and stragglers
  (``python -m multigrad_tpu_torch.telemetry.aggregate rank*.jsonl``,
  the ``/fleet`` view of :class:`LiveServer` ``rank_paths=``);
  :func:`~.aggregate.gather_to_rank0` over ``torch.distributed``.
* :mod:`.trace` — request waterfalls from per-process trace JSONLs.
* :mod:`.dashboard` — the streaming terminal dashboard of a JSONL.
* :mod:`.regress` — the noise-aware bench regression gate.
* :mod:`.top` — per-worker resource columns of a fleet.

Not ported yet: the cost model (ROADMAP Queue 1 item 10, with
``analysis/``).

The stdlib-only modules of the JAX package are copied, not imported:
``import multigrad_tpu.<anything>`` runs ``multigrad_tpu/__init__``,
which imports jax.  This package imports only numpy and the standard
library at module level (torch, the process index and the rest of
``multigrad_tpu_torch`` inside functions), so every other layer can
depend on it without cycles.
"""
from .metrics import (CsvSink, JsonlSink, MemorySink,  # noqa: F401
                      MetricsLogger, config_digest, run_record)
from .taps import ScalarTap, batch_norm, make_tap  # noqa: F401
from .comm import (CommCounter, leaf_nbytes, measure_model_comm,  # noqa: F401
                   record_collective, traced_comm)
from .spans import Heartbeat, span  # noqa: F401
from .profile import profiled_fit, summarize_device_trace  # noqa: F401
from .costmodel import (ProgramCost, estimate_program_cost,  # noqa: F401
                        model_cost, predicted_time_s,
                        roofline_record)
from .flight import (FlightRecorder, FlightRecorderTripped,  # noqa: F401
                     NonFiniteSentinel)
from .live import (LiveMetrics, LiveServer, LiveSink,  # noqa: F401
                   wire_monitoring)
from .alerts import (AlertEngine, AlertRule, DivergenceRate,  # noqa: F401
                     GradExplosion, HeartbeatStall, LossPlateau,
                     ThroughputDrop, default_rules)
from .tracing import (TraceContext, Tracer, new_trace,  # noqa: F401
                      parse_traceparent)
from .resources import (ResourceMonitor, autoscaler_inputs,  # noqa: F401
                        measured_vs_modeled)
from .rollup import RollupStore  # noqa: F401
from .budget import BurnRateAlert, SloBudget  # noqa: F401

__all__ = [
    "MetricsLogger", "JsonlSink", "CsvSink", "MemorySink",
    "run_record", "config_digest",
    "ScalarTap", "make_tap", "batch_norm",
    "CommCounter", "record_collective", "traced_comm",
    "measure_model_comm", "leaf_nbytes",
    "span", "Heartbeat",
    "profiled_fit", "summarize_device_trace",
    "ProgramCost", "estimate_program_cost", "model_cost",
    "predicted_time_s", "roofline_record",
    "FlightRecorder", "FlightRecorderTripped", "NonFiniteSentinel",
    "LiveMetrics", "LiveSink", "LiveServer", "wire_monitoring",
    "AlertEngine", "AlertRule", "LossPlateau", "GradExplosion",
    "ThroughputDrop", "DivergenceRate", "HeartbeatStall",
    "default_rules",
    "TraceContext", "Tracer", "new_trace", "parse_traceparent",
    "ResourceMonitor", "autoscaler_inputs", "measured_vs_modeled",
    "RollupStore", "SloBudget", "BurnRateAlert",
]
