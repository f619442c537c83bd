"""Declarative SLOs over the QoS classes, evaluated live (a copy of
:mod:`multigrad_tpu.serve.slo`).

The observability half of the QoS subsystem
(:mod:`multigrad_tpu_torch.serve.qos`): an :class:`Slo` states a latency
objective declaratively — *p95 < 2 s for class interactive* — and a
:class:`SloMonitor` evaluates it continuously from the latencies the
scheduler (or fleet router) feeds it:

* every served fit lands one observation in a **per-class latency
  histogram** (``multigrad_qos_fit_latency_seconds{priority_class=}``
  in the live registry, trace id as the exemplar) plus an exact
  in-process sample buffer, so :meth:`SloMonitor.evaluate` returns
  true quantiles even with no registry attached (bench, demos);
* declared objectives export as gauges
  (``multigrad_qos_slo_threshold_seconds`` /
  ``multigrad_qos_slo_quantile``) the moment the monitor is built,
  so ``LiveServer /status`` can judge a class's health from the
  registry alone — :meth:`~multigrad_tpu_torch.telemetry.live.LiveSink
  .qos_summary` recomputes *measured vs declared* on every scrape;
* :meth:`evaluate` refreshes ``multigrad_qos_p50/p95/p99_seconds``
  and the ``multigrad_qos_slo_ok`` verdict gauges, and its return
  value is the dict ``bench.py qos_mixed_load`` flattens into the
  dossier ``telemetry.regress`` gates — a scheduling change that
  trades a protected class's tail for aggregate throughput fails CI.

The monitor buffers at most :attr:`SloMonitor.MAX_SAMPLES` latencies
per class (deterministic decimation: every other sample is dropped
when the buffer doubles), bounding memory in a long-running service
while keeping the empirical distribution's shape.
"""
from __future__ import annotations

import collections
import re
from dataclasses import dataclass
from typing import Optional

from .._lockdep import make_lock

__all__ = ["Slo", "SloMonitor", "parse_slo"]

_SLO_RE = re.compile(
    r"^\s*p(\d{1,2}(?:\.\d+)?)\s*<\s*([0-9.]+)\s*s?\s+for\s+"
    r"(?:class\s+)?(\S+)\s*$", re.IGNORECASE)


@dataclass(frozen=True)
class Slo:
    """One declarative latency objective: the ``quantile`` of class
    ``priority_class``'s end-to-end fit latency must stay under
    ``threshold_s`` seconds.

    ``budget`` is the allowed-violation fraction backing the
    error-budget engine (:class:`~multigrad_tpu_torch.telemetry.budget
    .SloBudget`); it defaults to ``1 - quantile`` — a p95 objective
    tolerates 5 % violating requests — so every pre-budget ``Slo``
    keeps its meaning unchanged."""

    priority_class: str
    threshold_s: float
    quantile: float = 0.95
    budget: Optional[float] = None

    def __post_init__(self):
        if not isinstance(self.priority_class, str) \
                or not self.priority_class:
            raise TypeError("Slo.priority_class must be a non-empty "
                            f"str, got {self.priority_class!r}")
        object.__setattr__(self, "threshold_s",
                           float(self.threshold_s))
        object.__setattr__(self, "quantile", float(self.quantile))
        if self.threshold_s <= 0:
            raise ValueError("Slo.threshold_s must be positive")
        if not (0.0 < self.quantile < 1.0):
            raise ValueError("Slo.quantile must be in (0, 1), got "
                             f"{self.quantile}")
        budget = self.budget
        if budget is None:
            budget = round(1.0 - self.quantile, 6)
        object.__setattr__(self, "budget", float(budget))
        if not (0.0 < self.budget <= 1.0):
            raise ValueError("Slo.budget must be in (0, 1], got "
                             f"{self.budget}")

    def describe(self) -> str:
        q = self.quantile * 100
        qs = f"{q:g}"
        return (f"p{qs} < {self.threshold_s:g} s for class "
                f"{self.priority_class!r}")


def parse_slo(text: str) -> Slo:
    """Parse the declarative string form — ``"p95 < 2 s for
    interactive"`` (``class`` keyword and the ``s`` unit optional) —
    into an :class:`Slo`."""
    m = _SLO_RE.match(text)
    if m is None:
        raise ValueError(
            f"cannot parse SLO {text!r}; expected the form "
            "'p95 < 2.0 s for <class>'")
    return Slo(priority_class=m.group(3),
               threshold_s=float(m.group(2)),
               quantile=float(m.group(1)) / 100.0)


def _quantile(sorted_vals, q: float) -> Optional[float]:
    """Exact linear-interpolated quantile of a sorted sample."""
    n = len(sorted_vals)
    if not n:
        return None
    if n == 1:
        return float(sorted_vals[0])
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac)
                 + sorted_vals[hi] * frac)


class SloMonitor:
    """Live per-class latency bookkeeping + SLO verdicts.

    Parameters
    ----------
    metrics : LiveMetrics, optional
        Registry the per-class histograms and SLO gauges export
        into (``multigrad_qos_*``); ``None`` keeps the monitor
        fully in-process (bench / demo use).
    slos : iterable of Slo | str
        Declared objectives — :class:`Slo` instances or their
        declarative string form (:func:`parse_slo`).  At most one
        per class.  Classes without a declared SLO are still
        observed (histograms, quantiles), just never judged.
    budgets : bool
        Grow a :class:`~multigrad_tpu_torch.telemetry.budget.SloBudget`
        error-budget ledger per declared SLO (the
        ``multigrad_slo_budget_*`` gauges, burn rates, exhaustion
        ETA).  On by default; the rollup-overhead bench's baseline
        leg turns it off for a fair A/B.
    """

    MAX_SAMPLES = 8192

    def __init__(self, metrics=None, slos=(),
                 prefix: str = "multigrad_qos",
                 budgets: bool = True):
        self.metrics = metrics
        self.prefix = prefix
        self.slos: dict = {}
        for s in (slos or ()):
            if isinstance(s, str):
                s = parse_slo(s)
            if not isinstance(s, Slo):
                raise TypeError(f"slos entries must be Slo or str, "
                                f"got {type(s).__name__}")
            if s.priority_class in self.slos:
                raise ValueError("duplicate SLO for class "
                                 f"{s.priority_class!r}")
            self.slos[s.priority_class] = s
        self._lock = make_lock("serve.slo.SloMonitor._lock")
        # Error-budget ledgers, one per declared SLO.  Built (and
        # fed) OUTSIDE the monitor lock: a ledger exports gauges into
        # the registry, and registry work under the monitor lock
        # would be a gratuitous lock-order edge.
        self.budgets: dict = {}
        if budgets:
            from ..telemetry.budget import SloBudget
            for s in self.slos.values():
                self.budgets[s.priority_class] = SloBudget(
                    s.priority_class, s.threshold_s,
                    budget=s.budget, live=metrics)
        self._samples: dict = {}            # class -> [e2e_s, ...]
        self._shed_by_class: collections.Counter = \
            collections.Counter()
        self._shed_by_tenant: collections.Counter = \
            collections.Counter()
        # Thresholds export immediately: /status judges a class from
        # the registry alone, so the declaration must be visible
        # before the first observation arrives.
        if metrics is not None:
            for s in self.slos.values():
                labels = {"priority_class": s.priority_class}
                metrics.set(f"{prefix}_slo_threshold_seconds",
                            s.threshold_s, labels=labels,
                            help="declared per-class latency SLO "
                                 "threshold")
                metrics.set(f"{prefix}_slo_quantile", s.quantile,
                            labels=labels,
                            help="quantile the class's SLO is "
                                 "declared over")

    # -- write side ---------------------------------------------------------
    def observe(self, priority_class: str, tenant: str, e2e_s: float,
                trace_id: Optional[str] = None):
        """One served fit: its end-to-end latency joins the class's
        sample buffer and (when a registry is attached) the
        per-class histogram, with the trace id as the exemplar."""
        e2e_s = float(e2e_s)
        with self._lock:
            buf = self._samples.setdefault(priority_class, [])
            buf.append(e2e_s)
            if len(buf) > self.MAX_SAMPLES:
                # Deterministic decimation: halve by dropping every
                # other sample — keeps the distribution's shape,
                # bounds memory, stays reproducible (no RNG).
                del buf[::2]
        m = self.metrics
        if m is not None:
            m.observe(f"{self.prefix}_fit_latency_seconds", e2e_s,
                      labels={"priority_class": priority_class},
                      exemplar=trace_id,
                      help="end-to-end served fit latency by "
                           "priority class")
            m.inc(f"{self.prefix}_fits_total",
                  labels={"priority_class": priority_class,
                          "tenant": tenant},
                  help="served fits by priority class and tenant")
        ledger = self.budgets.get(priority_class)
        if ledger is not None:
            ledger.observe(e2e_s, trace_id=trace_id)

    def record_shed(self, priority_class: str, tenant: str):
        """One class-aware shed (queue eviction or fleet-wide
        reject) against this class/tenant."""
        with self._lock:
            self._shed_by_class[priority_class] += 1
            self._shed_by_tenant[tenant] += 1
        m = self.metrics
        if m is not None:
            m.inc(f"{self.prefix}_shed_total",
                  labels={"priority_class": priority_class},
                  help="requests shed, by priority class")
            m.inc(f"{self.prefix}_shed_tenant_total",
                  labels={"tenant": tenant},
                  help="requests shed, by tenant")
        ledger = self.budgets.get(priority_class)
        if ledger is not None:
            # A shed request never met its objective: it burns
            # budget exactly like a late one.
            ledger.record_shed()

    # -- read side ----------------------------------------------------------
    def evaluate(self) -> dict:
        """Per-class health: ``{class: {count, p50_s, p95_s, p99_s,
        max_s, shed, slo?}}`` where ``slo`` (present for declared
        classes) carries ``{target, quantile, threshold_s,
        measured_s, ok}`` — ``ok`` is ``None`` until the class has
        data.  Refreshes the ``multigrad_qos_p*_seconds`` and
        ``multigrad_qos_slo_ok`` gauges when a registry is
        attached."""
        with self._lock:
            samples = {c: sorted(v)
                       for c, v in self._samples.items()}
            shed = dict(self._shed_by_class)
        out: dict = {}
        for cls in sorted(set(samples) | set(self.slos)):
            vals = samples.get(cls, [])
            entry = {
                "count": len(vals),
                "p50_s": _quantile(vals, 0.50),
                "p95_s": _quantile(vals, 0.95),
                "p99_s": _quantile(vals, 0.99),
                "max_s": vals[-1] if vals else None,
                "shed": shed.get(cls, 0),
            }
            slo = self.slos.get(cls)
            if slo is not None:
                measured = _quantile(vals, slo.quantile)
                entry["slo"] = {
                    "target": slo.describe(),
                    "quantile": slo.quantile,
                    "threshold_s": slo.threshold_s,
                    "measured_s": measured,
                    "ok": (None if measured is None
                           else bool(measured <= slo.threshold_s)),
                }
            ledger = self.budgets.get(cls)
            if ledger is not None:
                snap = ledger.snapshot()
                entry["budget"] = {
                    k: snap[k] for k in
                    ("budget", "remaining_frac", "burn_rate",
                     "fast_burning", "exhaustion_eta_s",
                     "violations")}
            out[cls] = entry
        m = self.metrics
        if m is not None:
            for cls, entry in out.items():
                labels = {"priority_class": cls}
                for name, key in (("p50", "p50_s"), ("p95", "p95_s"),
                                  ("p99", "p99_s")):
                    if entry[key] is not None:
                        m.set(f"{self.prefix}_{name}_seconds",
                              entry[key], labels=labels,
                              help=f"measured {name} end-to-end fit "
                                   "latency by priority class")
                verdict = entry.get("slo", {}).get("ok")
                if verdict is not None:
                    m.set(f"{self.prefix}_slo_ok",
                          1.0 if verdict else 0.0, labels=labels,
                          help="1 when the class's measured "
                               "quantile meets its declared SLO")
        return out

    def ok(self) -> bool:
        """True when every declared SLO with data is met (classes
        with no observations yet don't fail the verdict)."""
        return all(e["slo"]["ok"] is not False
                   for e in self.evaluate().values() if "slo" in e)

    def snapshot(self) -> dict:
        """JSON-able monitor state for ``/status`` style surfaces:
        per-class health plus the tenant-level shed counters."""
        with self._lock:
            shed_tenant = dict(self._shed_by_tenant)
        return {"classes": self.evaluate(),
                "shed_by_tenant": shed_tenant}
