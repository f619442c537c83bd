"""Live observability: in-process metrics registry + HTTP endpoint (a
copy of :mod:`multigrad_tpu.telemetry.live`).

Everything telemetry did before this module is *offline*: JSONL files
read back by :mod:`.report` after the fact, postmortems dumped after a
fit died.  This module is the online half — the fleet-readable runtime
view pod-scale operations lean on to catch stragglers and divergence
while a job is still salvageable:

* :class:`LiveMetrics` — a tiny in-process registry of counters,
  gauges and histograms, rendered in the Prometheus text exposition
  format (version 0.0.4) so any standard scraper/agent can consume it.
* :class:`LiveSink` — the :class:`~multigrad_tpu_torch.telemetry
  .MetricsLogger` **sink adapter**: give it to the logger (or pass
  ``live=`` to a fit entry point, which does it for you) and every
  record the fit emits is folded into the registry plus a rolling
  status view (current step, loss, steps/s, ETA from the fit plan,
  comm bytes/step, last-heartbeat age).
* :class:`LiveServer` — a daemon-thread stdlib ``http.server``
  exposing ``/metrics`` (Prometheus text), ``/status`` (JSON) and
  ``/healthz``.  It is itself a sink (it owns a :class:`LiveSink`),
  so ``live=LiveServer()`` is the whole wiring.

Several processes: taps write on process 0 only, but spans, heartbeats
and stream counters are per-process facts — each process that
constructs a :class:`LiveServer` serves its *own* stream (a non-zero
``port`` is offset by the process index of
:mod:`multigrad_tpu_torch.parallel.distributed` so processes on one
host never collide), and rank 0 can additionally serve the cross-rank
fleet view (``/fleet``) by pointing ``rank_paths=`` at the per-rank JSONL
files; the aggregation itself is
:func:`multigrad_tpu_torch.telemetry.aggregate.aggregate` (merge, span
skew, stragglers).

Wiring::

    from multigrad_tpu_torch.telemetry import JsonlSink, LiveServer, MetricsLogger

    live = LiveServer(port=9100)          # port 0 = pick a free one
    log = MetricsLogger(JsonlSink("run.jsonl"))
    model.run_adam(guess, nsteps, telemetry=log, log_every=20,
                   live=live)
    # while the fit runs:
    #   curl localhost:9100/metrics   -> Prometheus exposition
    #   curl localhost:9100/status    -> {"step": ..., "eta_s": ...}

This module is stdlib-only at module level (the process index is
imported lazily), per the telemetry package contract.
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Optional, Sequence

__all__ = ["LiveMetrics", "LiveSink", "LiveServer",
           "LatencyObserver", "wire_monitoring"]

# Histogram bucket defaults: seconds-per-step on anything from a
# sub-ms CPU toy fit to a multi-second streamed pass.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                   10.0, 60.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _fmt_value(v) -> str:
    """Prometheus sample-value formatting (floats as %g, non-finite
    as the spec's NaN/+Inf/-Inf tokens)."""
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return f"{v:.10g}"


def _label_key(labels: Optional[dict]) -> str:
    """Deterministic `{k="v",...}` rendering (sorted; '' when None)."""
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace(
            '"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


_LABEL_PAIR_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _parse_label_key(key: str) -> dict:
    """Inverse of :func:`_label_key` — recover the label dict from a
    rendered series key (counters/gauges store bare floats, so their
    labels survive only in the key)."""
    if not key:
        return {}
    return {k: v.replace(r"\n", "\n").replace(r"\"", '"')
               .replace("\\\\", "\\")
            for k, v in _LABEL_PAIR_RE.findall(key)}


class LiveMetrics:
    """Thread-safe counter/gauge/histogram registry.

    Names must match the Prometheus metric-name grammar
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``); an optional ``labels`` dict per
    sample keys independent series under one name.  A name's type is
    fixed by its first use — re-registering it as a different type
    raises (the exposition format forbids mixed types).
    """

    def __init__(self):
        from .._lockdep import make_lock
        self._lock = make_lock("telemetry.live.LiveMetrics._lock")
        self._metrics: dict = {}        # name -> metric dict

    def _metric(self, name: str, mtype: str, help: Optional[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        cur = self._metrics.get(name)
        if cur is None:
            cur = self._metrics[name] = {
                "type": mtype, "help": help or "", "samples": {}}
        elif cur["type"] != mtype:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{cur['type']}, not {mtype}")
        elif help and not cur["help"]:
            cur["help"] = help
        return cur

    # -- write side ---------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, help: str = None,
            labels: Optional[dict] = None):
        """Increment a counter (monotonic by contract)."""
        with self._lock:
            m = self._metric(name, "counter", help)
            key = _label_key(labels)
            m["samples"][key] = m["samples"].get(key, 0.0) + float(value)

    def set(self, name: str, value: float, help: str = None,
            labels: Optional[dict] = None, replace: bool = False):
        """Set a gauge to its current value.  ``replace=True`` drops
        the name's other label series first — for gauges whose label
        IS the payload (e.g. the slowest-fit exemplar gauge carries
        the offending ``trace_id`` as a label, and keeping every
        superseded trace's series would grow the exposition without
        bound)."""
        with self._lock:
            m = self._metric(name, "gauge", help)
            if replace:
                m["samples"].clear()
            m["samples"][_label_key(labels)] = float(value)

    def observe(self, name: str, value: float, help: str = None,
                buckets: Sequence[float] = DEFAULT_BUCKETS,
                labels: Optional[dict] = None,
                exemplar: Optional[str] = None):
        """Add one observation to a histogram (bucket edges are
        fixed by each label series' first observation).

        ``labels`` keys independent series under one name (the hop
        dimension of the serve-latency histograms); ``exemplar``
        attaches an identifier — a trace id — to the bucket the
        observation lands in (last write wins per bucket) and to the
        series maximum, so a tail-latency reading links straight to
        an offending trace (:meth:`exemplar`).  Exemplars surface
        through :meth:`snapshot`/:meth:`exemplar` and the ``/status``
        JSON, not the text exposition (0.0.4 predates OpenMetrics
        exemplar syntax).
        """
        with self._lock:
            m = self._metric(name, "histogram", help)
            key = _label_key(labels)
            h = m["samples"].get(key)
            if h is None:
                edges = tuple(sorted(float(b) for b in buckets))
                h = m["samples"][key] = {
                    "labels": dict(labels) if labels else None,
                    "buckets": edges,
                    "counts": [0] * len(edges),
                    "sum": 0.0, "count": 0,
                    "exemplars": {},
                }
            v = float(value)
            landed = None           # index of the bucket v falls in
            for i, edge in enumerate(h["buckets"]):
                if v <= edge:
                    h["counts"][i] += 1     # cumulative by contract
                    if landed is None:
                        landed = i
            if landed is None:
                landed = len(h["buckets"])      # +Inf overflow
            h["sum"] += v
            h["count"] += 1
            if v >= h.get("max", float("-inf")):
                h["max"] = v
                # An un-exemplared new maximum CLEARS the slot (the
                # field is documented as the worst observation's id;
                # a stale smaller observation's id must not pose as
                # it — exemplar() falls back to bucket exemplars).
                h["max_exemplar"] = (str(exemplar)
                                     if exemplar is not None
                                     else None)
            if exemplar is not None:
                h["exemplars"][landed] = str(exemplar)

    # -- read side ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able copy of the registry (tests, /status debugging)."""
        with self._lock:
            return json.loads(json.dumps(
                self._metrics, default=lambda o: list(o)))

    def quantile(self, name: str, q: float,
                 labels: Optional[dict] = None) -> Optional[float]:
        """Estimated q-quantile of a histogram series (linear
        interpolation inside the bucket the quantile falls in — the
        standard ``histogram_quantile`` estimate, clamped to the
        true observed maximum so the +Inf bucket never inflates a
        p99).  ``None`` for an absent or empty series."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m["type"] != "histogram":
                return None
            h = m["samples"].get(_label_key(labels))
            if h is None or not h["count"]:
                return None
            buckets = h["buckets"]
            counts = list(h["counts"])
            count = h["count"]
            vmax = h.get("max")
        target = float(q) * count
        prev_edge, prev_cum = 0.0, 0
        for edge, cum in zip(buckets, counts):
            if cum >= target:
                step = cum - prev_cum
                frac = 1.0 if step <= 0 else \
                    (target - prev_cum) / step
                est = prev_edge + frac * (edge - prev_edge)
                return min(est, vmax) if vmax is not None else est
            prev_edge, prev_cum = edge, cum
        # target lands in the +Inf overflow bucket
        return vmax if vmax is not None else buckets[-1]

    def exemplar(self, name: str,
                 labels: Optional[dict] = None) -> Optional[str]:
        """The exemplar attached to the slowest populated bucket of
        a histogram series — i.e. the trace id of (one of) the
        worst observations, the hook a tail-latency alarm follows
        straight into the waterfall."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m["type"] != "histogram":
                return None
            h = m["samples"].get(_label_key(labels))
            if h is None:
                return None
            if h.get("max_exemplar") is not None:
                return h["max_exemplar"]
            ex = h.get("exemplars") or {}
            return ex[max(ex)] if ex else None

    def histogram_stats(self, name: str,
                        labels: Optional[dict] = None
                        ) -> Optional[dict]:
        """``{count, sum, max}`` of a histogram series (``None`` if
        absent)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m["type"] != "histogram":
                return None
            h = m["samples"].get(_label_key(labels))
            if h is None:
                return None
            return {"count": h["count"], "sum": h["sum"],
                    "max": h.get("max")}

    def value(self, name: str,
              labels: Optional[dict] = None) -> Optional[float]:
        """Current value of a counter/gauge series (``None`` when
        the name or label series is absent, or the name is a
        histogram — use :meth:`quantile`/:meth:`histogram_stats`)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m["type"] == "histogram":
                return None
            v = m["samples"].get(_label_key(labels))
            return float(v) if v is not None else None

    def label_sets(self, name: str) -> list:
        """The label dicts a metric has series for (``{}`` for the
        unlabeled series) — how ``/status`` discovers which hops
        have latency histograms (and which tenants/classes the QoS
        counters track).  Histograms carry their label dicts;
        counter/gauge series are recovered from the rendered label
        key (exact inverse of :func:`_label_key` for the
        identifier-style label values this registry uses)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return []
            out = []
            for key, h in m["samples"].items():
                if isinstance(h, dict):
                    out.append(dict(h.get("labels") or {}))
                else:
                    out.append(_parse_label_key(key))
            return out

    def render(self) -> str:
        """The registry in Prometheus text exposition format 0.0.4."""
        with self._lock:
            lines = []
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m["help"]:
                    lines.append(f"# HELP {name} {m['help']}")
                lines.append(f"# TYPE {name} {m['type']}")
                if m["type"] == "histogram":
                    for key in sorted(m["samples"]):
                        h = m["samples"][key]
                        base = dict(h.get("labels") or {})
                        for edge, n in zip(h["buckets"],
                                           h["counts"]):
                            lk = _label_key(
                                {**base, "le": _fmt_value(edge)})
                            lines.append(f"{name}_bucket{lk} {n}")
                        lk = _label_key({**base, "le": "+Inf"})
                        lines.append(
                            f'{name}_bucket{lk} {h["count"]}')
                        lines.append(
                            f"{name}_sum{key} "
                            f"{_fmt_value(h['sum'])}")
                        lines.append(f"{name}_count{key} "
                                     f"{h['count']}")
                else:
                    for key, value in sorted(m["samples"].items()):
                        lines.append(f"{name}{key} {_fmt_value(value)}")
            return "\n".join(lines) + "\n"


class LatencyObserver:
    """Feed one serve layer's fit-latency histograms.

    The shared write side behind ``/status``'s ``latency`` section
    (:meth:`LiveSink.latency_summary`): end-to-end and per-hop
    observations land in ``<prefix>_fit_latency_seconds`` /
    ``<prefix>_hop_seconds{hop=...}`` with the trace id as the
    exemplar, and the slowest fit seen keeps a
    ``<prefix>_fit_latency_max_seconds`` gauge whose label IS the
    offending trace id.  The max latch is taken under a lock and the
    gauge is replaced inside it — the fleet router observes from one
    reader thread per worker, and an unsynchronized check-then-act
    would let a smaller concurrent latency clobber the true maximum's
    exemplar.

    ``metrics=None`` makes every call a no-op, so callers wire the
    observer unconditionally and let the ``live=`` flag decide.
    """

    def __init__(self, metrics: Optional[LiveMetrics],
                 prefix: str, noun: str):
        self.metrics = metrics
        self.prefix = prefix
        self.noun = noun
        # The max-latch gauge write happens inside the latch's
        # critical section (check-then-act on the maximum), an
        # ordering hidden behind the `self.metrics` indirection:
        # declared for the lockdep cross-check.
        from .._lockdep import make_lock
        self._lock = make_lock(
            "telemetry.live.LatencyObserver._lock",
            may_precede=("telemetry.live.LiveMetrics._lock",))
        self._max_s = 0.0

    def observe(self, e2e_s: float, hops: Optional[dict],
                trace_id: Optional[str]):
        m = self.metrics
        if m is None:
            return
        e2e_s = max(0.0, float(e2e_s))
        m.observe(f"{self.prefix}_fit_latency_seconds", e2e_s,
                  help=f"end-to-end {self.noun} latency "
                       "(submit -> result)",
                  exemplar=trace_id)
        for hop, v in (hops or {}).items():
            if isinstance(v, (int, float)):
                m.observe(f"{self.prefix}_hop_seconds", float(v),
                          help=f"{self.noun} latency by hop",
                          labels={"hop": hop}, exemplar=trace_id)
        if trace_id is None:
            return
        with self._lock:
            if e2e_s < self._max_s:
                return
            self._max_s = e2e_s
            m.set(f"{self.prefix}_fit_latency_max_seconds", e2e_s,
                  help=f"slowest {self.noun}; the offending trace "
                       "id is the label",
                  labels={"trace_id": trace_id}, replace=True)


class LiveSink:
    """The MetricsLogger sink adapter feeding a :class:`LiveMetrics`.

    Folds the record stream into the registry (prefix
    ``multigrad_``) and keeps the rolling :meth:`status` view the
    ``/status`` endpoint serves: current step, loss, steps/s over a
    trailing window of tap records, ETA against the fit plan
    (``fit_plan`` records carry ``nsteps`` — every wired fit driver
    emits one up front), comm bytes/step, last-heartbeat age, stall
    state and alert count.  Safe to reuse across fits: a new
    ``fit_plan`` (or ``run``) record resets the per-fit state.
    """

    def __init__(self, metrics: Optional[LiveMetrics] = None,
                 rate_window: int = 32):
        self.metrics = metrics or LiveMetrics()
        # Registry updates happen inside the fold's critical section
        # (the status view and the gauges must agree record-by-
        # record); the `self.metrics` indirection hides the edge
        # from the AST, so it is declared.
        from .._lockdep import make_lock
        self._lock = make_lock(
            "telemetry.live.LiveSink._lock",
            may_precede=("telemetry.live.LiveMetrics._lock",))
        self._rate_window = int(rate_window)
        self._run: Optional[dict] = None
        self._comm_bytes_per_step = None
        self._reset_fit()
        self._alerts = 0
        self._stalls = 0
        self._last_record_t: Optional[float] = None

    def _reset_fit(self):
        # NB: comm accounting deliberately survives a fit_plan — the
        # model drivers log it immediately BEFORE announcing the plan.
        self._plan: Optional[dict] = None
        self._ticks: list = []          # (t, step) of tap records
        self._step: Optional[int] = None
        self._loss = None
        self._grad_norm = None
        self._summary: Optional[dict] = None
        self._hmc: Optional[dict] = None
        # A fit aborted mid-stall must not leave the NEXT fit's
        # /status reporting stalled=true forever (the cumulative
        # _stalls counter survives; the episode flag does not).
        self._stalled = False
        self._last_heartbeat_t = None

    @staticmethod
    def _scalar(v):
        """First member of a batched tap value (report's convention)."""
        if isinstance(v, (list, tuple)):
            return float(v[0]) if v else None
        return float(v) if isinstance(v, (int, float)) else None

    # -- sink protocol ------------------------------------------------------
    def write(self, record: dict):
        event = record.get("event")
        t = record.get("t")
        m = self.metrics
        m.inc("multigrad_records_total", 1.0,
              help="telemetry records seen, by event",
              labels={"event": str(event)})
        with self._lock:
            self._last_record_t = t or time.time()
            if event == "run":
                self._run = dict(record)
                self._comm_bytes_per_step = None
                self._reset_fit()
            elif event == "fit_plan":
                self._reset_fit()
                self._plan = dict(record)
                if record.get("nsteps") is not None:
                    m.set("multigrad_nsteps", record["nsteps"],
                          help="planned steps of the current fit")
            elif event in ("adam", "hmc"):
                step = record.get("step")
                if step is not None and t is not None:
                    self._ticks.append((float(t), int(step)))
                    if len(self._ticks) > self._rate_window:
                        del self._ticks[0]
                    if len(self._ticks) >= 2:
                        (t0, s0), (t1, s1) = self._ticks[-2], \
                            self._ticks[-1]
                        if s1 > s0 and t1 > t0:
                            m.observe("multigrad_step_seconds",
                                      (t1 - t0) / (s1 - s0),
                                      help="wall seconds per step "
                                           "(from tap record spacing)")
                if step is not None:
                    self._step = int(step)
                    m.set("multigrad_step", step,
                          help="last step/draw seen from the fit")
                if event == "adam":
                    loss = self._scalar(record.get("loss"))
                    if loss is not None:
                        self._loss = loss
                        m.set("multigrad_loss", loss,
                              help="last tapped loss")
                    g = self._scalar(record.get("grad_norm"))
                    if g is not None:
                        self._grad_norm = g
                        m.set("multigrad_grad_norm", g,
                              help="last tapped |grad|")
                    for extra in ("loss_ema", "loss_ema_slope",
                                  "grad_noise_scale",
                                  "grad_norm_shard"):
                        v = self._scalar(record.get(extra))
                        if v is not None and v == v:
                            m.set(f"multigrad_{extra}", v)
                else:
                    self._hmc = {k: record.get(k) for k in
                                 ("step", "accept", "divergences",
                                  "step_size")}
                    a = self._scalar(record.get("accept"))
                    if a is not None:
                        m.set("multigrad_hmc_accept", a,
                              help="windowed HMC acceptance")
                    d = record.get("divergences")
                    if isinstance(d, (list, tuple)):
                        d = sum(d)
                    if isinstance(d, (int, float)):
                        m.set("multigrad_hmc_divergences", d,
                              help="cumulative HMC divergences")
            elif event == "comm":
                b = record.get("bytes_per_step")
                if b is not None:
                    self._comm_bytes_per_step = b
                    m.set("multigrad_comm_bytes_per_step", b,
                          help="collective payload per step")
            elif event == "heartbeat":
                self._last_heartbeat_t = t or time.time()
            elif event == "stall":
                self._stalls += 1
                self._stalled = True
                m.inc("multigrad_stalls_total",
                      help="heartbeat stall episodes")
            elif event == "stall_recovered":
                self._stalled = False
            elif event == "alert":
                self._alerts += 1
                m.inc("multigrad_alerts_total",
                      help="alert-rule firings, by rule",
                      labels={"rule": str(record.get("rule", "?"))})
            elif event == "bench":
                val = record.get("value")
                if isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    m.set("multigrad_bench_value", val,
                          help="bench dossier config values",
                          labels={"config": str(record.get("config"))})
            elif event == "fit_summary":
                self._summary = dict(record)
                sps = record.get("steps_per_sec")
                if sps is not None:
                    m.set("multigrad_steps_per_sec", sps)
                fl = self._scalar(record.get("final_loss"))
                if fl is not None:
                    m.set("multigrad_loss", fl)

    def close(self):
        # Sinks attached per-fit outlive their logger by design: the
        # status/metrics view must stay scrapeable after the fit's
        # logger closes.  Nothing to release.
        pass

    # -- read side ----------------------------------------------------------
    def rate(self) -> Optional[float]:
        """Steps/s over the trailing tap-record window."""
        with self._lock:
            if len(self._ticks) < 2:
                return None
            (t0, s0), (t1, s1) = self._ticks[0], self._ticks[-1]
        if t1 <= t0 or s1 <= s0:
            return None
        return (s1 - s0) / (t1 - t0)

    def latency_summary(self) -> Optional[dict]:
        """Request-latency quantiles + exemplar traces for the
        ``/status`` ``latency`` section.

        Reads the serve layers' latency histograms out of the shared
        registry — ``multigrad_fleet_fit_latency_seconds`` (the
        router's end-to-end view, preferred) falling back to
        ``multigrad_serve_fit_latency_seconds`` (single-process
        scheduler) — and summarizes p50/p95/p99/max with the
        exemplar trace id of the slowest bucket, plus the same per
        hop (``*_hop_seconds{hop=...}``), so a tail-latency alarm
        links straight to the offending trace's waterfall.  ``None``
        when no fits have been served.
        """
        m = self.metrics
        for prefix in ("multigrad_fleet", "multigrad_serve"):
            name = f"{prefix}_fit_latency_seconds"
            stats = m.histogram_stats(name)
            if not stats or not stats["count"]:
                continue
            out = {
                "source": name,
                "count": stats["count"],
                "p50_s": m.quantile(name, 0.5),
                "p95_s": m.quantile(name, 0.95),
                "p99_s": m.quantile(name, 0.99),
                "max_s": stats["max"],
                "exemplar_trace": m.exemplar(name),
            }
            hop_name = f"{prefix}_hop_seconds"
            hops = {}
            for ls in m.label_sets(hop_name):
                hop = ls.get("hop")
                if hop is None:
                    continue
                hstats = m.histogram_stats(hop_name, labels=ls)
                hops[hop] = {
                    "count": hstats["count"],
                    "p50_s": m.quantile(hop_name, 0.5, labels=ls),
                    "p95_s": m.quantile(hop_name, 0.95,
                                        labels=ls),
                    "p99_s": m.quantile(hop_name, 0.99,
                                        labels=ls),
                    "max_s": hstats["max"],
                    "exemplar_trace": m.exemplar(hop_name,
                                                 labels=ls),
                }
            if hops:
                out["hops"] = hops
            return out
        return None

    def qos_summary(self) -> Optional[dict]:
        """Per-priority-class QoS health for the ``/status`` ``qos``
        section, recomputed from the shared registry on every scrape.

        Reads the ``multigrad_qos_*`` family the
        :class:`~multigrad_tpu.serve.slo.SloMonitor` exports: the
        per-class latency histograms
        (``multigrad_qos_fit_latency_seconds{priority_class=}``),
        the declared-SLO gauges (threshold + quantile), and the shed
        counters — and judges *measured vs declared* per class, so
        an operator (or the qos demo's receipt) can read a class's
        verdict from the endpoint alone.  ``None`` when no QoS
        metrics have landed (QoS off)."""
        m = self.metrics
        hist = "multigrad_qos_fit_latency_seconds"
        classes = sorted(
            ({ls.get("priority_class")
              for ls in m.label_sets(hist)} |
             {ls.get("priority_class")
              for ls in m.label_sets(
                  "multigrad_qos_slo_threshold_seconds")})
            - {None})
        if not classes:
            return None
        out: dict = {"classes": {}}
        for cls in classes:
            labels = {"priority_class": cls}
            stats = m.histogram_stats(hist, labels=labels) or {}
            entry: dict = {
                "count": stats.get("count", 0),
                "p50_s": m.quantile(hist, 0.5, labels=labels),
                "p95_s": m.quantile(hist, 0.95, labels=labels),
                "p99_s": m.quantile(hist, 0.99, labels=labels),
                "max_s": stats.get("max"),
                "exemplar_trace": m.exemplar(hist, labels=labels),
                "shed": int(m.value("multigrad_qos_shed_total",
                                    labels=labels) or 0),
            }
            threshold = m.value("multigrad_qos_slo_threshold_seconds",
                                labels=labels)
            if threshold is not None:
                q = m.value("multigrad_qos_slo_quantile",
                            labels=labels) or 0.95
                measured = m.quantile(hist, q, labels=labels)
                entry["slo"] = {
                    "threshold_s": threshold,
                    "quantile": q,
                    "measured_s": measured,
                    "ok": (None if measured is None
                           else bool(measured <= threshold)),
                }
            # Error-budget view: the multigrad_slo_budget_*
            # gauges a SloBudget ledger exports — absent for classes
            # without a declared budget, so a pre-budget process's
            # qos section is unchanged.
            remaining = m.value(
                "multigrad_slo_budget_remaining_frac",
                labels=labels)
            if remaining is not None:
                burning = m.value(
                    "multigrad_slo_budget_fast_burning",
                    labels=labels)
                entry["budget"] = {
                    "remaining_frac": remaining,
                    "burn_rate": m.value(
                        "multigrad_slo_budget_burn_rate",
                        labels=labels),
                    "exhaustion_eta_s": m.value(
                        "multigrad_slo_budget_exhaustion_eta_s",
                        labels=labels),
                    "fast_burning": (bool(burning)
                                     if burning is not None
                                     else None),
                    "exemplar_trace": m.exemplar(
                        "multigrad_slo_budget_violation_seconds",
                        labels=labels),
                }
            out["classes"][cls] = entry
        shed_tenants = {
            ls["tenant"]: int(m.value(
                "multigrad_qos_shed_tenant_total", labels=ls) or 0)
            for ls in m.label_sets("multigrad_qos_shed_tenant_total")
            if ls.get("tenant")}
        if shed_tenants:
            out["shed_by_tenant"] = shed_tenants
        return out

    def resources_summary(self) -> Optional[dict]:
        """Process-resource health for the ``/status`` ``resources``
        section, read from the ``multigrad_resource_*`` gauges a
        :class:`~multigrad_tpu_torch.telemetry.ResourceMonitor` exports.

        Also folds in the :func:`~multigrad_tpu_torch.telemetry
        .autoscaler_inputs` contract (``busy_frac``, queue-wait p95,
        measured memory headroom) so the one documented place an
        autoscaler reads is the same endpoint operators look at.
        ``None`` when no monitor has exported (monitoring off) —
        the section stays off the JSON entirely, like ``qos``."""
        m = self.metrics
        if m.value("multigrad_resource_uptime_seconds") is None \
                and m.value("multigrad_resource_rss_bytes") is None:
            return None
        out = {
            "uptime_s": m.value("multigrad_resource_uptime_seconds"),
            "rss_bytes": m.value("multigrad_resource_rss_bytes"),
            "device_bytes_in_use": m.value(
                "multigrad_resource_device_bytes_in_use"),
            "device_peak_bytes": m.value(
                "multigrad_resource_device_peak_bytes"),
            "device_bytes_limit": m.value(
                "multigrad_resource_device_bytes_limit"),
            "busy_frac": m.value("multigrad_resource_busy_frac"),
            "busy_s_total": m.value(
                "multigrad_resource_busy_seconds_total"),
            "compile": {
                "count": m.value("multigrad_resource_compile_count"),
                "seconds_total": m.value(
                    "multigrad_resource_compile_seconds_total"),
                "cache_hits": m.value(
                    "multigrad_resource_compile_cache_hits"),
                "cache_misses": m.value(
                    "multigrad_resource_compile_cache_misses"),
            },
        }
        acc = m.value(
            "multigrad_resource_memory_model_accuracy_frac")
        if acc is not None:
            out["memory_model_accuracy_frac"] = acc
        # Serve-layer load context rides along when this process runs
        # a scheduler — the fleet-top's queue column reads it from
        # the same section instead of scraping /metrics.
        qd = m.value("multigrad_serve_queue_depth")
        if qd is not None:
            out["queue_depth"] = int(qd)
        fph = m.value("multigrad_serve_fits_per_hour")
        if fph is not None:
            out["fits_per_hour"] = fph
        from .resources import autoscaler_inputs
        out["autoscaler"] = autoscaler_inputs(m)
        # int-valued gauges come back as floats from the registry;
        # re-coerce byte/count fields so the JSON reads naturally.
        for key in ("rss_bytes", "device_bytes_in_use",
                    "device_peak_bytes", "device_bytes_limit"):
            if out[key] is not None:
                out[key] = int(out[key])
        for key in ("count", "cache_hits", "cache_misses"):
            if out["compile"][key] is not None:
                out["compile"][key] = int(out["compile"][key])
        return out

    def status(self, now: Optional[float] = None) -> dict:
        """The ``/status`` JSON: step/loss/steps-per-sec/ETA + liveness.

        ETA counts remaining planned steps (the ``fit_plan`` record's
        ``nsteps``, i.e. the segment schedule every driver announces
        up front) against the trailing steps/s.
        """
        now = time.time() if now is None else now
        rate = self.rate()
        with self._lock:
            done = self._summary is not None
            eta_s = None
            if (not done and rate and self._plan is not None
                    and self._plan.get("nsteps") is not None
                    and self._step is not None):
                remaining = max(
                    0, int(self._plan["nsteps"]) - 1 - self._step)
                eta_s = remaining / rate
            out = {
                "phase": ("done" if done else
                          "fitting" if self._step is not None else
                          "idle"),
                "step": self._step,
                "nsteps": (self._plan or {}).get("nsteps"),
                "fit_kind": (self._plan or {}).get("kind"),
                "loss": self._loss,
                "grad_norm": self._grad_norm,
                "steps_per_sec": rate,
                "eta_s": 0.0 if done else eta_s,
                "comm_bytes_per_step": self._comm_bytes_per_step,
                "last_record_age_s": (
                    round(now - self._last_record_t, 3)
                    if self._last_record_t else None),
                "last_heartbeat_age_s": (
                    round(now - self._last_heartbeat_t, 3)
                    if self._last_heartbeat_t else None),
                "stalled": self._stalled,
                "stalls": self._stalls,
                "alerts": self._alerts,
            }
            if self._hmc is not None:
                out["hmc"] = self._hmc
            if self._summary is not None:
                out["fit_summary"] = {
                    k: v for k, v in self._summary.items()
                    if k not in ("event", "t")}
            if self._run is not None:
                out["run"] = {k: self._run.get(k) for k in
                              ("backend", "device_kind", "device_count",
                               "process_index", "process_count",
                               "config_digest")}
        latency = self.latency_summary()
        if latency is not None:
            out["latency"] = latency
        qos = self.qos_summary()
        if qos is not None:
            out["qos"] = qos
        resources = self.resources_summary()
        if resources is not None:
            out["resources"] = resources
        # refresh derived gauges at read time (ages drift between
        # records; a scrape should see the current value)
        if out["last_heartbeat_age_s"] is not None:
            self.metrics.set("multigrad_heartbeat_age_seconds",
                             out["last_heartbeat_age_s"],
                             help="seconds since the last heartbeat")
        if out["steps_per_sec"] is not None:
            self.metrics.set("multigrad_steps_per_sec",
                             out["steps_per_sec"],
                             help="trailing-window fit rate")
        if out["eta_s"] is not None:
            self.metrics.set("multigrad_eta_seconds", out["eta_s"],
                             help="remaining planned steps / rate")
        return out


class LiveServer:
    """Daemon-thread HTTP endpoint over a :class:`LiveSink`.

    Also a sink itself (delegates to its :class:`LiveSink`), so the
    whole live stack wires as ``live=LiveServer()`` on any fit entry
    point — or explicitly as an extra sink of a
    :class:`~multigrad_tpu_torch.telemetry.MetricsLogger`.

    Endpoints: ``/metrics`` (Prometheus text exposition 0.0.4),
    ``/status`` (JSON, see :meth:`LiveSink.status`), ``/healthz``
    (200 "ok"), and — when ``rank_paths`` names the per-rank JSONL
    files of a run of several processes, or a fleet's workers — ``/fleet``
    (the :func:`~multigrad_tpu_torch.telemetry.aggregate.aggregate`
    summary: per-rank accounting, span skew, stragglers).

    ``port=0`` (default) binds a free ephemeral port (read it back
    from ``.port``/``.url``); a fixed nonzero port is offset by the
    process index so the processes of one job on one machine never
    collide.  Separate single-process jobs sharing a host are a case
    the offset cannot cover (each has ``process_index() == 0``), so
    they all resolve the same fixed port.  On ``EADDRINUSE`` the server
    therefore probes forward up to ``port_probe`` consecutive ports
    instead of crashing the worker at startup; the port actually
    bound is readable from ``.port`` and surfaced in the ``/status``
    JSON (``"port"``).  The serving thread is a daemon: it dies with
    the process, or earlier via :meth:`stop`.  ``close()`` (the sink
    protocol) deliberately does NOT stop the server — the endpoint
    outlives any single fit's logger.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 sink: Optional[LiveSink] = None,
                 rank_paths: Optional[Sequence[str]] = None,
                 port_probe: int = 16,
                 start: bool = True):
        self.sink = sink or LiveSink()
        self.metrics = self.sink.metrics
        self.rank_paths = list(rank_paths) if rank_paths else None
        if port:
            from ..parallel.distributed import process_index
            port = int(port) + process_index()
        self._host = host
        self._port_requested = port
        self._port_probe = max(1, int(port_probe))
        self._httpd = None
        self._thread = None
        if start:
            self.start()

    # -- sink protocol (delegated) ------------------------------------------
    def write(self, record: dict):
        self.sink.write(record)

    def close(self):
        pass

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):    # silence per-request noise
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        server.sink.status()   # refresh derived gauges
                        self._send(
                            200, server.metrics.render().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/status":
                        status = server.sink.status()
                        # The bound port, not the requested one: with
                        # bind-retry active (fleet workers sharing a
                        # host) the two can differ, and operators
                        # resolve "which worker is this?" from here.
                        status["port"] = server.port
                        self._send(
                            200,
                            json.dumps(status, default=str).encode(),
                            "application/json")
                    elif path == "/healthz":
                        self._send(200, b"ok\n", "text/plain")
                    elif path == "/fleet" and server.rank_paths:
                        from .aggregate import aggregate
                        self._send(
                            200,
                            json.dumps(aggregate(server.rank_paths),
                                       default=str).encode(),
                            "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:        # client went away
                    pass
                except Exception as e:         # never kill the thread
                    try:
                        self._send(500, f"{e}\n".encode(), "text/plain")
                    except Exception:
                        pass

        # Fixed ports collide when several single-process jobs share a
        # host (the process_index offset above is identically zero for
        # each): probe forward a bounded range
        # on EADDRINUSE instead of crashing the worker at startup.
        # port=0 never probes — the OS hands out a free port.
        import errno
        probes = self._port_probe if self._port_requested else 1
        last_err = None
        for offset in range(probes):
            try:
                self._httpd = ThreadingHTTPServer(
                    (self._host,
                     self._port_requested + offset
                     if self._port_requested else 0), Handler)
                break
            except OSError as e:
                last_err = e
                if e.errno != errno.EADDRINUSE:
                    raise
        if self._httpd is None:
            raise OSError(
                errno.EADDRINUSE,
                f"no free port in [{self._port_requested}, "
                f"{self._port_requested + probes - 1}]") from last_err
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mgt-live-server")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self._host}:{self.port}" if self._httpd \
            else None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def wire_monitoring(telemetry, log_every: int, live=None, alerts=None,
                    default_log_every: int = 25):
    """Attach live/alert sinks to a fit's record stream.

    The shared plumbing behind every entry point's ``live=`` /
    ``alerts=`` parameters.  Returns ``(telemetry, log_every,
    owned)``:

    * with neither monitor: the arguments pass through untouched;
    * with a monitor and an existing logger: the monitors join it as
      extra sinks (idempotent — re-wiring at an inner driver is a
      no-op) and immediately receive the run record;
    * with a monitor but no logger: a fresh
      :class:`~multigrad_tpu_torch.telemetry.MetricsLogger` over just the
      monitors is created and returned as ``owned`` — the caller must
      close it when the fit ends;
    * ``log_every`` is defaulted to ``default_log_every`` when unset,
      since a live view without tap records would be empty.

    Monitors exposing ``bind_logger`` (the
    :class:`~multigrad_tpu_torch.telemetry.alerts.AlertEngine`, which emits
    ``alert`` records back into the stream) are bound to the logger.
    """
    monitors = [s for s in (live, alerts) if s is not None]
    if not monitors:
        return telemetry, log_every, None
    owned = None
    from .metrics import MetricsLogger
    if telemetry is None:
        telemetry = owned = MetricsLogger(*monitors)
    else:
        for s in monitors:
            telemetry.add_sink(s)
    for s in monitors:
        bind = getattr(s, "bind_logger", None)
        if bind is not None:
            bind(telemetry)
    if not log_every:
        log_every = default_log_every
    return telemetry, log_every, owned
