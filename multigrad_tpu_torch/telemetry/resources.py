"""Per-process resource monitor: memory, duty cycle, kernel-build truth
(port of :mod:`multigrad_tpu.telemetry.resources`).

The paper's claim is that comm cost is O(|sumstats|+|params|)
independent of data size, which makes *device residency* the binding
resource for a serve fleet: how full the card's memory is, how busy
the dispatch loop is, and how much wall time disappears into kernel
builds.  :class:`ResourceMonitor` measures them with one sampler thread
per process:

* **host RSS**: ``/proc/self/statm`` resident pages × page size
  (``None`` off Linux: the monitor degrades, never raises);
* **device memory**: ``torch.cuda.memory_stats(d)`` of the caching
  allocator (``allocated_bytes.all.current`` / ``.peak``, the card's
  ``total_memory``).  A process that has not initialised CUDA, or runs
  on the CPU, yields ``None`` fields plus a one-shot
  ``resource_monitor_degraded`` telemetry note: the sampler never
  initialises CUDA and never calls anything that waits on the card;
* **busy/idle duty cycle**: the serve scheduler brackets every bucket
  dispatch with :meth:`dispatch_enter` / :meth:`dispatch_exit` (or the
  :meth:`dispatching` context manager); each sample folds the busy
  seconds accumulated since the previous sample into a window
  ``busy_frac``, the "sustained idle occupancy" signal an elastic
  autoscaler scales in on;
* **kernel-build accounting** (the JAX package's compile accounting):
  the port has no XLA program; its cold start is the ``nvcc`` build of
  the kernel libraries.  :func:`multigrad_tpu_torch.ops.cuda_build
  .build` reports every library through
  :func:`~multigrad_tpu_torch.utils.util.add_compile_observer`: a miss
  is an ``nvcc`` build with its wall seconds, a hit a library found
  already built.  The totals are process-global: builds before the
  monitor started still count.

Samples land in a bounded ring (:meth:`ring`, what flight/postmortem
bundles capture), export as ``multigrad_resource_*`` gauges through a
:class:`~multigrad_tpu_torch.telemetry.LiveMetrics` registry, and every
``emit_every``-th sample is written as a ``resource_sample`` record
through the logger, so a :class:`~multigrad_tpu_torch.telemetry
.FlightRecorder` sink's ring holds the recent resource history at dump
time without any extra wiring.

:func:`autoscaler_inputs` publishes the documented scale-out/scale-in
contract in one place: ``busy_frac``, ``queue_wait_p95_s`` (from the
hop histograms the tracing layer already records) and measured
``headroom_bytes`` (device limit minus measured peak; host RSS is
reported but deliberately not a headroom input: the host is not the
binding resource).

Memory truth closes the loop in the serve scheduler: after each bucket
dispatch it compares the measured device peak against the ensemble
memory model (:func:`measured_vs_modeled`) and emits the record, so
the model can never silently drift from the hardware.  The port's
model counts the Adam carry only, not each row's autograd graph, so
on the card the ratio reads far above 1 (ROADMAP.md Queue 1).

This module imports only the standard library at module level (torch
lazily inside the device probe), per the telemetry package contract.
"""
from __future__ import annotations


import collections
import os
import threading
import time
from typing import Optional

from .._lockdep import make_lock

__all__ = ["ResourceMonitor", "read_rss_bytes", "device_memory",
           "compile_totals", "reset_compile_totals",
           "autoscaler_inputs", "measured_vs_modeled",
           "SNAPSHOT_KEYS"]

#: The compact over-the-wire snapshot schema (the heartbeat payload
#: and the known-keys contract of ``serve.wire.resources_from_wire``).
SNAPSHOT_KEYS = ("t", "uptime_s", "rss_bytes", "device_bytes_in_use",
                 "device_peak_bytes", "device_bytes_limit",
                 "busy_frac", "busy_s_total", "compile_count",
                 "compile_s_total", "compile_hits", "compile_misses")


# ------------------------------------------------------------------ #
# process-global kernel-build accounting (fed by ops.cuda_build.build
# through utils.util's observers; plain-lock guarded, registered
# lazily so a process that never monitors pays nothing)
# ------------------------------------------------------------------ #
_COMPILE_LOCK = threading.Lock()
_COMPILE = {"count": 0, "seconds": 0.0, "hits": 0, "misses": 0}
_observer_installed = False


def _compile_observer(key, seconds, hit):
    with _COMPILE_LOCK:
        if hit:
            _COMPILE["hits"] += 1
        else:
            _COMPILE["misses"] += 1
            _COMPILE["count"] += 1
            _COMPILE["seconds"] += float(seconds)


def _install_observer():
    global _observer_installed
    with _COMPILE_LOCK:
        if _observer_installed:
            return
        _observer_installed = True
    from ..utils.util import add_compile_observer
    add_compile_observer(_compile_observer)


def compile_totals() -> dict:
    """Process-global kernel-build accounting:
    ``{"count", "seconds", "hits", "misses"}`` (zeros until the first
    :class:`ResourceMonitor` installs the observer)."""
    with _COMPILE_LOCK:
        return dict(_COMPILE)


def reset_compile_totals():
    """Zero the process-global build counters (tests)."""
    with _COMPILE_LOCK:
        for k in _COMPILE:
            _COMPILE[k] = 0.0 if k == "seconds" else 0


# ------------------------------------------------------------------ #
# probes
# ------------------------------------------------------------------ #
def read_rss_bytes() -> Optional[int]:
    """Resident set size of this process from ``/proc/self/statm``
    (``None`` where procfs is absent: macOS, exotic containers)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def device_memory(device=None) -> dict:
    """Device-memory fields of the CUDA caching allocator, summed across
    the process's cards (or for one ``device``).

    ``bytes_in_use`` is ``allocated_bytes.all.current`` of
    ``torch.cuda.memory_stats(d)``, ``peak_bytes`` its ``.peak``
    (``torch.cuda.max_memory_allocated``), ``bytes_limit`` the card's
    ``total_memory``.  All three ``None`` and ``supported`` ``False``
    for a CPU ``device``, or in a process that has not initialised CUDA:
    the probe never initialises it, and reads host-side allocator
    counters only (nothing here waits on the card).  Never raises.
    """
    out = {"bytes_in_use": None, "peak_bytes": None,
           "bytes_limit": None, "supported": False}
    try:
        import torch
        if not torch.cuda.is_initialized():
            return out
        if device is None:
            devices = range(torch.cuda.device_count())
        else:
            device = torch.device(device)
            if device.type != "cuda":
                return out
            devices = [device.index if device.index is not None
                       else torch.cuda.current_device()]
    except Exception:
        return out
    for d in devices:
        try:
            stats = torch.cuda.memory_stats(d)
            limit = torch.cuda.get_device_properties(d).total_memory
        except Exception:
            continue
        for field, v in (
                ("bytes_in_use", stats.get("allocated_bytes.all.current")),
                ("peak_bytes", stats.get("allocated_bytes.all.peak")),
                ("bytes_limit", limit)):
            if isinstance(v, (int, float)):
                out[field] = (out[field] or 0) + int(v)
                out["supported"] = True
    return out


def measured_vs_modeled(measured_peak_bytes, modeled_bytes) -> dict:
    """The memory-truth comparison the serve scheduler records per
    bucket dispatch: measured device peak against the memory model.

    ``measured_ratio`` is measured/modeled (``None`` when the backend
    cannot measure — the regress gate treats nulls as warn-only, so a
    CPU round never flakes while a card's round gates drift), and
    ``accuracy_frac`` is ``1 - |measured - modeled| / modeled`` —
    higher-better, so monotone regression gates catch drift in
    EITHER direction.
    """
    modeled = int(modeled_bytes) if modeled_bytes else None
    measured = int(measured_peak_bytes) \
        if isinstance(measured_peak_bytes, (int, float)) else None
    ratio = accuracy = None
    if measured is not None and modeled:
        ratio = round(measured / modeled, 4)
        accuracy = round(1.0 - abs(measured - modeled) / modeled, 4)
    return {"measured_peak_bytes": measured,
            "modeled_bytes": modeled,
            "measured_ratio": ratio,
            "accuracy_frac": accuracy}


class ResourceMonitor:
    """Per-process resource sampler (see the module docstring).

    Parameters
    ----------
    live : LiveMetrics or LiveServer, optional
        Registry to export ``multigrad_resource_*`` gauges into
        (a ``LiveMetrics``, or anything carrying one as
        ``.metrics`` — a ``LiveSink``/``LiveServer``).
    logger : MetricsLogger, optional
        Record stream for the periodic ``resource_sample`` records
        and the one-shot ``resource_monitor_degraded`` note.
    interval_s : float
        Sampling period.
    capacity : int
        Ring size (the "last K samples" a postmortem preserves).
    emit_every : int
        Every Nth sample is also logged as a ``resource_sample``
        record (0 disables record emission; the ring and gauges
        still update every sample).

    ``start()`` launches the daemon sampler thread; ``close()`` stops
    it and takes one final sample so the ring always holds the
    process's last known state.  All probe failures degrade to
    ``None`` fields — the monitor must never take down the fit it is
    watching.
    """

    def __init__(self, live=None, logger=None, interval_s: float = 0.5,
                 capacity: int = 256, emit_every: int = 20):
        self.live = getattr(live, "metrics", live)
        self.logger = logger
        self.interval_s = float(interval_s)
        self.emit_every = int(emit_every)
        self._ring = collections.deque(maxlen=int(capacity))
        # Sample assembly happens under the lock; gauge export and
        # record emission happen outside it (the registry and sinks
        # have their own locks).
        self._lock = make_lock(
            "telemetry.resources.ResourceMonitor._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_start = time.time()
        self._busy_total = 0.0        # cumulative dispatch seconds
        self._busy_depth = 0          # nested dispatch_enter count
        self._busy_since: Optional[float] = None
        self._prev_busy = 0.0         # busy_now at the previous sample
        self._prev_t: Optional[float] = None
        self._busy_frac: Optional[float] = None
        self._degraded_reported = False
        self._device_supported: Optional[bool] = None
        self._n_samples = 0
        _install_observer()

    # -- duty-cycle hooks (the serve scheduler brackets dispatches) --
    def dispatch_enter(self):
        """Mark device work started (re-entrant)."""
        now = time.monotonic()
        with self._lock:
            if self._busy_depth == 0:
                self._busy_since = now
            self._busy_depth += 1

    def dispatch_exit(self):
        """Mark device work finished."""
        now = time.monotonic()
        with self._lock:
            if self._busy_depth > 0:
                self._busy_depth -= 1
                if self._busy_depth == 0 and self._busy_since is not None:
                    self._busy_total += now - self._busy_since
                    self._busy_since = None

    class _Dispatching:
        __slots__ = ("monitor",)

        def __init__(self, monitor):
            self.monitor = monitor

        def __enter__(self):
            self.monitor.dispatch_enter()
            return self

        def __exit__(self, *exc):
            self.monitor.dispatch_exit()
            return False

    def dispatching(self):
        """Context manager bracketing one dispatch's device work."""
        return self._Dispatching(self)

    def _busy_now(self, now) -> float:
        # caller holds the lock
        busy = self._busy_total
        if self._busy_depth > 0 and self._busy_since is not None:
            busy += now - self._busy_since
        return busy

    @property
    def busy_seconds(self) -> float:
        """Cumulative dispatch-busy seconds so far."""
        with self._lock:
            return self._busy_now(time.monotonic())

    # -- sampling -----------------------------------------------------------
    def sample(self) -> dict:
        """Take one sample: probe, fold the busy window, append to
        the ring, export gauges, maybe emit a record.  Returns the
        sample dict.  Never raises."""
        try:
            return self._sample()
        except Exception as e:                       # degrade, never die
            self._note_degraded(f"sampler: {type(e).__name__}: {e}")
            return {}

    def _sample(self) -> dict:
        now_wall = time.time()
        now = time.monotonic()
        rss = read_rss_bytes()
        dev = device_memory()
        compile_ = compile_totals()
        first_unsupported = False
        with self._lock:
            if self._device_supported is None:
                self._device_supported = dev["supported"]
                first_unsupported = not dev["supported"]
            busy_now = self._busy_now(now)
            if self._prev_t is not None and now > self._prev_t:
                frac = (busy_now - self._prev_busy) \
                    / (now - self._prev_t)
                self._busy_frac = round(min(max(frac, 0.0), 1.0), 4)
            self._prev_t = now
            self._prev_busy = busy_now
            self._n_samples += 1
            n = self._n_samples
            sample = {
                "event": "resource_sample",
                "t": now_wall,
                "uptime_s": round(now_wall - self._t_start, 3),
                "rss_bytes": rss,
                "device_bytes_in_use": dev["bytes_in_use"],
                "device_peak_bytes": dev["peak_bytes"],
                "device_bytes_limit": dev["bytes_limit"],
                "busy_frac": self._busy_frac,
                "busy_s_total": round(busy_now, 4),
                "compile_count": compile_["count"],
                "compile_s_total": round(compile_["seconds"], 4),
                "compile_hits": compile_["hits"],
                "compile_misses": compile_["misses"],
            }
            self._ring.append(sample)
        if first_unsupported:
            # Outside the lock: _note_degraded takes it again.
            self._note_degraded("device memory_stats unavailable "
                                "(CPU or exotic backend); device "
                                "fields will be null")
        self._export(sample)
        if self.logger is not None and self.emit_every \
                and (n - 1) % self.emit_every == 0:
            try:
                self.logger.log("resource_sample",
                                **{k: v for k, v in sample.items()
                                   if k not in ("event", "t")})
            except Exception:
                pass
        return sample

    def _export(self, sample: dict):
        lm = self.live
        if lm is None:
            return
        gauges = (
            ("multigrad_resource_rss_bytes",
             sample["rss_bytes"], "Host resident set size (bytes)."),
            ("multigrad_resource_device_bytes_in_use",
             sample["device_bytes_in_use"],
             "Device memory in use, summed over local devices."),
            ("multigrad_resource_device_peak_bytes",
             sample["device_peak_bytes"],
             "Peak device memory (high-water), summed over local "
             "devices."),
            ("multigrad_resource_device_bytes_limit",
             sample["device_bytes_limit"],
             "Device memory capacity, summed over local devices."),
            ("multigrad_resource_busy_frac",
             sample["busy_frac"],
             "Fraction of the last sample window spent inside "
             "bucket dispatches."),
            ("multigrad_resource_busy_seconds_total",
             sample["busy_s_total"],
             "Cumulative dispatch-busy seconds."),
            ("multigrad_resource_compile_count",
             sample["compile_count"],
             "Kernel libraries built (nvcc runs)."),
            ("multigrad_resource_compile_seconds_total",
             sample["compile_s_total"],
             "Cumulative kernel-build wall seconds."),
            ("multigrad_resource_compile_cache_hits",
             sample["compile_hits"], "Kernel libraries found built."),
            ("multigrad_resource_compile_cache_misses",
             sample["compile_misses"], "Kernel libraries built (misses)."),
            ("multigrad_resource_uptime_seconds",
             sample["uptime_s"], "Monitor uptime (seconds)."),
        )
        try:
            for name, value, help_ in gauges:
                if value is not None:
                    lm.set(name, float(value), help=help_)
        except Exception:
            pass

    def _note_degraded(self, reason: str):
        with self._lock:
            if self._degraded_reported:
                return
            self._degraded_reported = True
        if self.logger is not None:
            try:
                self.logger.log("resource_monitor_degraded",
                                reason=reason)
            except Exception:
                pass

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded_reported

    # -- views --------------------------------------------------------------
    def snapshot(self) -> Optional[dict]:
        """The latest sample reduced to the compact wire schema
        (:data:`SNAPSHOT_KEYS`); ``None`` before the first sample."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
        if last is None:
            return None
        snap = {k: last[k] for k in SNAPSHOT_KEYS if k in last}
        snap["t"] = last["t"]
        return snap

    def ring(self) -> list:
        """The bounded sample ring, oldest first (what postmortem
        bundles capture)."""
        with self._lock:
            return list(self._ring)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ResourceMonitor":
        """Launch the daemon sampler thread (idempotent); takes an
        immediate first sample so snapshots exist right away."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.sample()
        self._thread = threading.Thread(
            target=self._loop, name="mgt-resource-monitor", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.sample()

    def close(self):
        """Stop the sampler and take one final sample (the ring's
        last entry is the process's last known state)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self.sample()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False


def autoscaler_inputs(live, monitor: Optional[ResourceMonitor] = None,
                      hop: str = "queue_wait", rollup=None,
                      window_s: float = 300.0) -> dict:
    """The documented autoscaler input contract, in one place (v2:
    windowed + trend-aware).

    ``{"busy_frac", "queue_wait_p95_s", "headroom_bytes",
    "queue_wait_p95_trend", "busy_frac_sustained",
    "slo_burn_rate"}``, each ``None`` when unmeasured:

    * ``busy_frac`` — the monitor's latest window duty cycle (scale
      OUT on sustained high values, IN on sustained idle);
    * ``queue_wait_p95_s`` — **windowed** p95 of the queue-wait
      latency over the trailing ``window_s``, from the rollup
      store's per-window samples.  Falls back to the cumulative
      ``queue_wait`` hop histogram when no history plane exists —
      the history-less value, which can never *fall* once a burst has
      inflated it;
    * ``headroom_bytes`` — device capacity minus MEASURED peak (how
      much bigger a bucket the worker could take; feeds bucket
      sizing, and a near-zero value vetoes scale-in consolidation);
    * ``queue_wait_p95_trend`` — least-squares slope (s/s) of the
      windowed queue wait: the ROADMAP's "queue_wait p95 *rising* →
      scale out" signal, positive while latency climbs;
    * ``busy_frac_sustained`` — windowed mean duty cycle: the
      "*sustained* idle → scale in" signal one instantaneous sample
      cannot provide;
    * ``slo_burn_rate`` — the worst per-class error-budget burn rate
      (``multigrad_slo_budget_burn_rate`` gauges): above ~1.0 the
      fleet is eating budget faster than sustainable, the strongest
      scale-out signal of the three.

    ``live`` is a :class:`~multigrad_tpu_torch.telemetry.LiveMetrics` (or
    anything with a ``metrics`` attribute); values fall back to the
    exported gauges when no ``monitor`` is passed.  ``rollup`` is a
    :class:`~multigrad_tpu_torch.telemetry.RollupStore`; without one the
    windowed fields read the ``multigrad_rollup_*`` gauges an
    attached store exports (:meth:`~multigrad_tpu_torch.telemetry.rollup
    .RollupStore.export`), so a scheduler built with ``history=True``
    feeds v2 through the registry with no extra plumbing.
    """
    lm = getattr(live, "metrics", live)
    busy = headroom = None
    snap = monitor.snapshot() if monitor is not None else None
    if snap is not None:
        busy = snap.get("busy_frac")
        limit, peak = snap.get("device_bytes_limit"), \
            snap.get("device_peak_bytes")
        if limit is not None and peak is not None:
            headroom = int(limit - peak)
    elif lm is not None:
        busy = lm.value("multigrad_resource_busy_frac")
        limit = lm.value("multigrad_resource_device_bytes_limit")
        peak = lm.value("multigrad_resource_device_peak_bytes")
        if limit is not None and peak is not None:
            headroom = int(limit - peak)
    p95 = trend = sustained = None
    if rollup is not None:
        from .rollup import BUSY_FRAC, QUEUE_WAIT_S
        p95 = rollup.quantile_over(QUEUE_WAIT_S, 0.95, window_s)
        trend = rollup.trend(QUEUE_WAIT_S, window_s)
        sustained = rollup.mean_over(BUSY_FRAC, window_s)
    elif lm is not None:
        p95 = lm.value("multigrad_rollup_queue_wait_p95_s")
        trend = lm.value("multigrad_rollup_queue_wait_trend")
        sustained = lm.value(
            "multigrad_rollup_busy_frac_sustained")
    if p95 is None and lm is not None:
        # Cumulative-histogram fallback: the v1 estimator, kept so a
        # history-less process still reports *something* — with the
        # documented caveat that it cannot see a trend.
        for name in ("multigrad_serve_hop_seconds",
                     "multigrad_fleet_hop_seconds"):
            for labels in lm.label_sets(name):
                if labels.get("hop") == hop:
                    p95 = lm.quantile(name, 0.95, labels=labels)
                    break
            if p95 is not None:
                break
    burn = None
    if lm is not None:
        for labels in lm.label_sets(
                "multigrad_slo_budget_burn_rate"):
            v = lm.value("multigrad_slo_budget_burn_rate",
                         labels=labels)
            if v is not None and (burn is None or v > burn):
                burn = v
    return {"busy_frac": busy, "queue_wait_p95_s": p95,
            "headroom_bytes": headroom,
            "queue_wait_p95_trend": trend,
            "busy_frac_sustained": sustained,
            "slo_burn_rate": burn}
