"""Windowed telemetry history: the tiered rollup store (a copy of
:mod:`multigrad_tpu.telemetry.rollup`).

Everything the stack exported before this module is either
*instantaneous* (the ``multigrad_resource_*`` gauges) or
*cumulative-since-process-start* (hop histograms, shed counters).
Neither can answer the questions the ROADMAP's elastic-fleet contract
actually asks — "is queue_wait p95 **rising**?", "has the device been
**sustainedly** idle?" — because both need a time axis.

:class:`RollupStore` is that axis: a bounded, tiered, windowed
time-series store, pure stdlib.  Samples land in fixed-width base
windows (default 10 s) and are simultaneously folded into coarser
tiers (default 1 m and 10 m); each tier keeps a fixed-size ring of
closed windows, so total memory is O(series × windows) forever —
retention is by construction, not by compaction jobs.  Per window the
store keeps ``count / sum / min / max / last`` plus (for sample
series) a capped, deterministically-decimated sample buffer, which is
what makes **windowed quantiles** possible where a cumulative
histogram can only ever answer "p95 since boot".

Feeding happens three ways, all concurrently safe:

* **direct** — :meth:`RollupStore.inc` / :meth:`~RollupStore.set` /
  :meth:`~RollupStore.observe` calls from instrumented code (the
  serve scheduler's settle path);
* **as a MetricsLogger sink** — :meth:`RollupStore.write` folds the
  record stream (``fit_summary`` → fits/queue-wait/per-tenant usage,
  ``resource_sample`` → busy-fraction gauge series), so
  ``logger.add_sink(store)`` gives any existing pipeline a history
  plane with zero call-site changes;
* **by scraping** — :meth:`RollupStore.attach_live` starts a daemon
  thread that periodically samples a :class:`~multigrad_tpu_torch.telemetry
  .live.LiveMetrics` registry's gauges into gauge series and
  re-exports the windowed signals (`multigrad_rollup_*` gauges) back
  into the registry for ``/status`` and ``autoscaler_inputs`` v2.

Queries — :meth:`~RollupStore.delta`, :meth:`~RollupStore.rate`,
:meth:`~RollupStore.mean_over`, :meth:`~RollupStore.quantile_over`,
and :meth:`~RollupStore.trend` (least-squares slope with a
window-count floor) — pick the finest tier whose retention covers the
asked window.

Fleet history rides heartbeats: a worker calls
:meth:`~RollupStore.take_delta` to cut a compact since-last-heartbeat
delta (fixed known keys — see :data:`DELTA_KEYS`), ships it through
the ``rollup_to_wire``/``rollup_from_wire`` codecs in
:mod:`multigrad_tpu_torch.serve.wire`, and the router folds it with
:meth:`~RollupStore.merge_delta` into fleet-level series that
**survive the worker** — a SIGKILL'd worker's already-shipped history
stays queryable at the router.

Pure stdlib at module level, per the telemetry package contract.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .._lockdep import make_lock

__all__ = [
    "RollupStore", "DELTA_KEYS",
    "FITS", "SHEDS", "DEVICE_BUSY_S", "QUEUE_WAIT_S", "BUSY_FRAC",
]

# ------------------------------------------------------------------ #
# canonical series names (the scheduler/router vocabulary — shared
# with serve/wire.py's heartbeat codec and the usage reporters)
# ------------------------------------------------------------------ #
#: Served-fit completions (counter).
FITS = "fits"
#: Class-aware queue sheds (counter).
SHEDS = "sheds"
#: Device-busy seconds from the dispatch duty-cycle bracket (counter).
DEVICE_BUSY_S = "device_busy_s"
#: Per-request queue-wait latency (sample series — windowed p95).
QUEUE_WAIT_S = "queue_wait_s"
#: Scraped instantaneous dispatch duty cycle (gauge series).
BUSY_FRAC = "busy_frac"

#: Fixed key set of a heartbeat rollup delta (:meth:`RollupStore
#: .take_delta`) — the known-keys contract ``serve/wire.py``'s
#: ``rollup_to_wire``/``rollup_from_wire`` codecs enforce.
DELTA_KEYS = ("t", "span_s", "fits", "sheds", "device_busy_s",
              "queue_wait_count", "queue_wait_sum_s",
              "queue_wait_max_s")

#: Default registry gauges the scrape loop samples into gauge series
#: (gauge name -> series name).
DEFAULT_SCRAPE = {
    "multigrad_resource_busy_frac": BUSY_FRAC,
    "multigrad_serve_queue_depth": "queue_depth",
    "multigrad_resource_rss_bytes": "rss_bytes",
}

_COUNTER, _GAUGE, _SAMPLE = "counter", "gauge", "sample"


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Exact linear-interpolation quantile over a sorted list (the
    same estimator :mod:`multigrad_tpu_torch.serve.slo` uses, local copy so
    telemetry never imports serve)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class _Window:
    """One fixed-width aggregation window."""

    __slots__ = ("start", "count", "sum", "min", "max", "last",
                 "samples")

    def __init__(self, start: float):
        self.start = start
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last: Optional[float] = None
        self.samples: Optional[List[float]] = None

    def fold(self, value: float, keep_sample: bool,
             max_samples: int):
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self.last = value
        if keep_sample:
            if self.samples is None:
                self.samples = []
            self.samples.append(value)
            if len(self.samples) > max_samples:
                # Deterministic decimation (the SloMonitor buffer
                # idiom): drop every other sample, oldest-biased, so
                # the quantile stays representative under flood.
                del self.samples[::2]

    def fold_stats(self, count: int, total: float,
                   vmax: Optional[float]):
        """Fold a pre-aggregated contribution (a peer's heartbeat
        delta) — counts and sums merge exactly; samples are gone, so
        windowed quantiles on merged series degrade to mean/max."""
        self.count += int(count)
        self.sum += float(total)
        if vmax is not None:
            self.max = vmax if self.max is None \
                else max(self.max, vmax)
            if self.min is None:
                self.min = vmax


class _Series:
    """One named series: a ring of closed+current windows per tier,
    plus lifetime totals (what heartbeat deltas are cut from)."""

    __slots__ = ("kind", "tiers", "total_count", "total_sum",
                 "take_count", "take_sum", "take_max")

    def __init__(self, kind: str,
                 tiers: Tuple[Tuple[float, int], ...]):
        self.kind = kind
        # [(width_s, ring)] finest first; each ring holds _Windows.
        self.tiers = [(width, collections.deque(maxlen=keep))
                      for width, keep in tiers]
        self.total_count = 0
        self.total_sum = 0.0
        # since-last-take aggregates for heartbeat deltas
        self.take_count = 0
        self.take_sum = 0.0
        self.take_max: Optional[float] = None

    def _window(self, ring, width: float, t: float) -> _Window:
        start = (t // width) * width
        if ring and ring[-1].start == start:
            return ring[-1]
        w = _Window(start)
        ring.append(w)
        return w

    def fold(self, value: float, t: float, max_samples: int):
        keep = self.kind == _SAMPLE
        for i, (width, ring) in enumerate(self.tiers):
            # Samples only in the finest tier: coarser tiers answer
            # rate/trend questions, the fine tier answers quantiles,
            # and memory stays O(base windows × cap).
            self._window(ring, width, t).fold(
                value, keep and i == 0, max_samples)
        self.total_count += 1
        self.total_sum += value
        self.take_count += 1
        self.take_sum += value
        self.take_max = value if self.take_max is None \
            else max(self.take_max, value)

    def fold_stats(self, count: int, total: float,
                   vmax: Optional[float], t: float):
        for width, ring in self.tiers:
            self._window(ring, width, t).fold_stats(count, total,
                                                    vmax)
        self.total_count += int(count)
        self.total_sum += float(total)

    def windows_over(self, window_s: float,
                     now: float) -> List[_Window]:
        """Windows intersecting ``[now - window_s, now]`` from the
        finest tier whose retention covers the span."""
        for width, ring in self.tiers:
            if width * ring.maxlen >= window_s:
                break
        else:
            width, ring = self.tiers[-1]
        cutoff = now - window_s
        # a window intersects the span if it ends after the cutoff
        return [w for w in ring if w.start + width > cutoff]


class RollupStore:
    """Bounded tiered windowed time-series store (module docstring).

    Parameters
    ----------
    base_s : float
        Base window width in seconds.
    tiers : tuple of (width_s, keep)
        Window tiers, finest first; ``keep`` is the ring length per
        tier.  Defaults retain 15 min at 10 s, 1.5 h at 1 m, and 8 h
        at 10 m — enough for the 1 h/6 h slow burn-rate pair.
    max_samples : int
        Per-base-window sample cap for quantile series (decimated
        beyond it).
    max_series : int
        Hard cap on distinct series; further names are dropped
        silently (a misbehaving caller must not OOM the store).
    clock : callable
        Injected time source (tests drive a fake clock).
    """

    def __init__(self, base_s: float = 10.0,
                 tiers: Tuple[Tuple[float, int], ...] = (
                     (10.0, 90), (60.0, 90), (600.0, 48)),
                 max_samples: int = 512, max_series: int = 1024,
                 clock=time.time):
        if base_s is not None and (not tiers
                                   or tiers[0][0] != base_s):
            tiers = ((float(base_s), 90),) + tuple(
                t for t in tiers if t[0] != base_s)
        self.tiers = tuple((float(w), int(k)) for w, k in tiers)
        self.base_s = self.tiers[0][0]
        self.max_samples = int(max_samples)
        self.max_series = int(max_series)
        self._clock = clock
        self._series: Dict = {}
        self._lock = make_lock("telemetry.rollup.RollupStore._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._live = None
        self._scrape_names = dict(DEFAULT_SCRAPE)
        self._interval = 10.0
        self._closed = False
        self._last_take_t: Optional[float] = None

    # ---------------------------------------------------------- #
    # feeding: direct
    # ---------------------------------------------------------- #
    def _get(self, name, kind: str) -> Optional[_Series]:
        s = self._series.get(name)
        if s is None:
            if len(self._series) >= self.max_series:
                return None
            s = self._series[name] = _Series(kind, self.tiers)
        return s

    def inc(self, name, delta: float = 1.0,
            t: Optional[float] = None):
        """Counter increment: window value = increments landing in
        that window, so :meth:`delta`/:meth:`rate` come for free."""
        t = self._clock() if t is None else t
        with self._lock:
            s = self._get(name, _COUNTER)
            if s is not None:
                s.fold(float(delta), t, self.max_samples)

    def set(self, name, value: float, t: Optional[float] = None):
        """Gauge sample: the window keeps last/min/max/mean of the
        scraped values."""
        t = self._clock() if t is None else t
        with self._lock:
            s = self._get(name, _GAUGE)
            if s is not None:
                s.fold(float(value), t, self.max_samples)

    def observe(self, name, value: float,
                t: Optional[float] = None):
        """Latency-style sample: like :meth:`set` but the base tier
        additionally keeps (capped) raw samples for
        :meth:`quantile_over`."""
        t = self._clock() if t is None else t
        with self._lock:
            s = self._get(name, _SAMPLE)
            if s is not None:
                s.fold(float(value), t, self.max_samples)

    def merge_stats(self, name, count: int, total: float,
                    vmax: Optional[float] = None,
                    t: Optional[float] = None):
        """Fold a pre-aggregated contribution into the current
        window (the router's heartbeat-merge path)."""
        if count is None or total is None or count <= 0:
            return
        t = self._clock() if t is None else t
        with self._lock:
            s = self._get(name, _SAMPLE)
            if s is not None:
                s.fold_stats(count, total, vmax, t)

    # ---------------------------------------------------------- #
    # feeding: MetricsLogger sink protocol
    # ---------------------------------------------------------- #
    def write(self, record: dict):
        """Sink entry point: fold the record stream.  Unknown events
        count into per-event counters; ``fit_summary`` feeds the
        fit/queue-wait/usage series; ``resource_sample`` feeds the
        busy-fraction gauge.  Must never raise — a history store is
        not allowed to kill the fit."""
        try:
            event = record.get("event")
            if not isinstance(event, str) or event in (
                    "alert", "tenant_usage", "slo_budget"):
                return
            t = record.get("t")
            t = float(t) if isinstance(t, (int, float)) else None
            self.inc(("events", event), 1.0, t=t)
            if event == "fit_summary":
                self._fold_fit_summary(record, t)
            elif event == "resource_sample":
                bf = record.get("busy_frac")
                if isinstance(bf, (int, float)):
                    self.set(BUSY_FRAC, bf, t=t)
        except Exception:
            # Sink backstop: a malformed record drops on the floor;
            # the logger's other sinks still see it.
            pass

    def _fold_fit_summary(self, record: dict, t: Optional[float]):
        self.inc(FITS, 1.0, t=t)
        hops = record.get("hops")
        qw = hops.get("queue_wait") if isinstance(hops, dict) \
            else None
        if isinstance(qw, (int, float)):
            self.observe(QUEUE_WAIT_S, qw, t=t)
        # Per-request device-busy share: fit_s is the whole bucket's
        # device time; occupancy*bucket is the live-row count, so
        # fit_s/rows is this request's share and the series sums to
        # true device seconds (modulo padded rows, which belong to
        # nobody).
        fit_s = record.get("fit_s")
        occ = record.get("occupancy")
        bucket = record.get("bucket")
        share = None
        if isinstance(fit_s, (int, float)) \
                and isinstance(occ, (int, float)) \
                and isinstance(bucket, (int, float)) \
                and occ * bucket >= 1:
            share = float(fit_s) / max(1.0, round(occ * bucket))
            self.inc(DEVICE_BUSY_S, share, t=t)
        tenant = record.get("tenant")
        cls = record.get("priority_class")
        if isinstance(tenant, str) and isinstance(cls, str):
            self.note_usage(tenant, cls, fits=1,
                            busy_s=share or 0.0, t=t)

    def close(self):
        """Sink protocol + lifecycle: stop the scrape thread."""
        self._closed = True
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None

    # ---------------------------------------------------------- #
    # feeding: registry scrape loop
    # ---------------------------------------------------------- #
    def attach_live(self, live, interval_s: float = 10.0,
                    names: Optional[dict] = None) -> "RollupStore":
        """Start the scrape thread against a ``LiveMetrics``
        registry: every ``interval_s`` it samples the gauges in
        ``names`` (default :data:`DEFAULT_SCRAPE`) into gauge series
        and calls :meth:`export` to publish the windowed signals
        back.  Idempotent per store; :meth:`close` stops it."""
        self._live = live
        self._interval = float(interval_s)
        if names is not None:
            self._scrape_names = dict(names)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._scrape_loop, daemon=True,
                name="mgt-rollup-scrape")
            self._thread.start()
        return self

    def _scrape_loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.scrape()
                self.export()
            except Exception:
                # Loop crash backstop: one bad scrape must not end
                # the history plane; the next tick retries.
                pass

    def scrape(self, live=None):
        """One scrape pass: sample the configured registry gauges
        into gauge series (values read OUTSIDE the store lock — the
        registry has its own)."""
        live = self._live if live is None else live
        if live is None:
            return
        t = self._clock()
        for gauge, series in self._scrape_names.items():
            v = live.value(gauge)
            if v is not None:
                self.set(series, v, t=t)

    def export(self, live=None, window_s: float = 300.0):
        """Publish the windowed autoscaler signals as
        ``multigrad_rollup_*`` gauges so ``/status`` and
        :func:`~multigrad_tpu_torch.telemetry.resources.autoscaler_inputs`
        read them with no extra plumbing."""
        live = self._live if live is None else live
        if live is None:
            return
        p95 = self.quantile_over(QUEUE_WAIT_S, 0.95, window_s)
        if p95 is not None:
            live.set("multigrad_rollup_queue_wait_p95_s", p95,
                     help=f"windowed ({window_s:.0f}s) queue-wait "
                          "p95 from the rollup store")
        slope = self.trend(QUEUE_WAIT_S, window_s)
        if slope is not None:
            live.set("multigrad_rollup_queue_wait_trend", slope,
                     help="least-squares queue-wait slope (s/s) "
                          "over the rollup window")
        busy = self.mean_over(BUSY_FRAC, window_s)
        if busy is not None:
            live.set("multigrad_rollup_busy_frac_sustained", busy,
                     help="windowed mean dispatch duty cycle")

    # ---------------------------------------------------------- #
    # queries
    # ---------------------------------------------------------- #
    def _windows(self, name, window_s: float,
                 now: Optional[float]) -> List[_Window]:
        now = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            return list(s.windows_over(float(window_s), now))

    def delta(self, name, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """Sum of a counter's increments over the trailing window
        (``None`` when no window has data)."""
        wins = self._windows(name, window_s, now)
        if not wins:
            return None
        return sum(w.sum for w in wins)

    def rate(self, name, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Windowed increment rate per second."""
        d = self.delta(name, window_s, now)
        return None if d is None else d / float(window_s)

    def mean_over(self, name, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        """Count-weighted mean of a series' values over the window —
        the ``busy_frac_sustained`` estimator."""
        wins = self._windows(name, window_s, now)
        count = sum(w.count for w in wins)
        if count <= 0:
            return None
        return sum(w.sum for w in wins) / count

    def max_over(self, name, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        wins = [w for w in self._windows(name, window_s, now)
                if w.max is not None]
        if not wins:
            return None
        return max(w.max for w in wins)

    def quantile_over(self, name, q: float, window_s: float,
                      now: Optional[float] = None
                      ) -> Optional[float]:
        """Exact (interpolated) quantile over the raw samples kept in
        the trailing window — the per-window p95 a cumulative
        histogram cannot produce.  ``None`` when the window holds no
        samples (including merged-stats-only fleet series)."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            width, ring = s.tiers[0]
            cutoff = now - float(window_s)
            samples: List[float] = []
            for w in ring:
                if w.start + width > cutoff and w.samples:
                    samples.extend(w.samples)
        if not samples:
            return None
        samples.sort()
        return _quantile(samples, float(q))

    def trend(self, name, window_s: float,
              min_windows: int = 4,
              now: Optional[float] = None) -> Optional[float]:
        """Least-squares slope (value units per second) of per-window
        means over the trailing window.  ``None`` below the
        ``min_windows`` floor — two noisy points are not a trend."""
        wins = [w for w in self._windows(name, window_s, now)
                if w.count > 0]
        if len(wins) < max(2, int(min_windows)):
            return None
        xs = [w.start for w in wins]
        ys = [w.sum / w.count for w in wins]
        n = len(xs)
        mx = sum(xs) / n
        my = sum(ys) / n
        denom = sum((x - mx) ** 2 for x in xs)
        if denom <= 0.0:
            return None
        return sum((x - mx) * (y - my)
                   for x, y in zip(xs, ys)) / denom

    def names(self) -> list:
        with self._lock:
            return list(self._series)

    # ---------------------------------------------------------- #
    # heartbeat deltas + fleet merge
    # ---------------------------------------------------------- #
    def take_delta(self, now: Optional[float] = None
                   ) -> Optional[dict]:
        """Cut the compact since-last-take delta a worker ships on
        its heartbeat: the :data:`DELTA_KEYS` dict, or ``None`` when
        nothing happened (the heartbeat key stays off the wire, a
        legacy router sees the old protocol verbatim).  Resets the
        take cursors."""
        now = self._clock() if now is None else now
        with self._lock:
            span = (now - self._last_take_t
                    if self._last_take_t is not None else None)
            self._last_take_t = now
            out = {"t": now, "span_s": span}
            any_data = False
            for key, name in ((FITS, FITS), (SHEDS, SHEDS),
                              (DEVICE_BUSY_S, DEVICE_BUSY_S)):
                s = self._series.get(name)
                v = s.take_sum if s is not None else 0.0
                out[key] = v
                any_data = any_data or v > 0
                if s is not None:
                    s.take_count = 0
                    s.take_sum = 0.0
                    s.take_max = None
            s = self._series.get(QUEUE_WAIT_S)
            if s is not None and s.take_count > 0:
                out["queue_wait_count"] = s.take_count
                out["queue_wait_sum_s"] = s.take_sum
                out["queue_wait_max_s"] = s.take_max
                s.take_count = 0
                s.take_sum = 0.0
                s.take_max = None
                any_data = True
            else:
                out["queue_wait_count"] = 0
                out["queue_wait_sum_s"] = 0.0
                out["queue_wait_max_s"] = None
        if not any_data:
            return None
        out["fits"] = int(out["fits"])
        out["sheds"] = int(out["sheds"])
        return out

    def merge_delta(self, delta: dict, worker: Optional[str] = None,
                    prefix: str = "fleet."):
        """Fold a peer's heartbeat delta (a :meth:`take_delta` /
        ``rollup_from_wire`` dict) into fleet-level series.  The
        contribution is timestamped *now* at the merger — worker
        clocks never steer the router's windows — and persists after
        the worker dies, which is the whole point."""
        if not isinstance(delta, dict):
            return
        t = self._clock()
        for key in (FITS, SHEDS, DEVICE_BUSY_S):
            v = delta.get(key)
            if isinstance(v, (int, float)) and v > 0:
                self.inc(prefix + key, v, t=t)
                if worker is not None and key == FITS:
                    self.inc(("worker_fits", worker), v, t=t)
        self.merge_stats(prefix + QUEUE_WAIT_S,
                         delta.get("queue_wait_count"),
                         delta.get("queue_wait_sum_s"),
                         delta.get("queue_wait_max_s"), t=t)

    # ---------------------------------------------------------- #
    # per-tenant usage accounting
    # ---------------------------------------------------------- #
    def note_usage(self, tenant: str, priority_class: str,
                   fits: int = 0, busy_s: float = 0.0,
                   sheds: int = 0, violations: int = 0,
                   t: Optional[float] = None):
        """Account usage to a ``(tenant, priority_class)`` pair —
        the rollup series behind ``tenant_usage`` records, the
        report's ``usage:`` section and ``telemetry.top
        --tenants``."""
        key = (tenant, priority_class)
        if fits:
            self.inc(("tenant_fits",) + key, fits, t=t)
        if busy_s:
            self.inc(("tenant_busy_s",) + key, busy_s, t=t)
        if sheds:
            self.inc(("tenant_sheds",) + key, sheds, t=t)
        if violations:
            self.inc(("tenant_viol",) + key, violations, t=t)

    def usage_records(self, window_s: float = 600.0,
                      now: Optional[float] = None) -> List[dict]:
        """One ``tenant_usage`` record dict per (tenant, class) pair:
        lifetime totals plus the trailing-window fit count, ready for
        ``telemetry.log("tenant_usage", **rec)``."""
        now = self._clock() if now is None else now
        with self._lock:
            pairs = sorted({name[1:] for name in self._series
                            if isinstance(name, tuple)
                            and name[0] in ("tenant_fits",
                                            "tenant_busy_s",
                                            "tenant_sheds",
                                            "tenant_viol")})

            def total(kind, pair):
                s = self._series.get((kind,) + pair)
                return s.total_sum if s is not None else 0.0

            out = []
            for pair in pairs:
                tenant, cls = pair
                out.append({
                    "tenant": tenant, "priority_class": cls,
                    "fits": int(total("tenant_fits", pair)),
                    "busy_s": round(total("tenant_busy_s", pair), 6),
                    "sheds": int(total("tenant_sheds", pair)),
                    "violations": int(total("tenant_viol", pair)),
                    "window_s": float(window_s),
                })
        for rec in out:
            pair = (rec["tenant"], rec["priority_class"])
            d = self.delta(("tenant_fits",) + pair, window_s,
                           now=now)
            rec["fits_windowed"] = int(d) if d is not None else 0
        return out
