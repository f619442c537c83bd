"""Declarative non-fatal alert rules over the live record stream (a copy
of :mod:`multigrad_tpu.telemetry.alerts`).

The flight recorder (:mod:`.flight`) handles *fatal* anomalies — NaN
loss, wedged hosts — after the fact.  This module is the soft layer
in front of it: rules that watch the record stream **while the fit
runs** and emit ``alert`` records (plus an optional callback action)
the moment a fit stops making progress, without killing runs that are
merely slow or unlucky:

* :class:`LossPlateau` — the EMA of the tapped loss stops moving
  (|slope| below a relative threshold);
* :class:`GradExplosion` — |grad| jumps far above its trailing
  median;
* :class:`ThroughputDrop` — steps/s (from tap-record spacing) falls
  below a fraction of its trailing median — the single-host shadow of
  the straggler check of the JAX package's ``telemetry.aggregate``;
* :class:`DivergenceRate` — the HMC sampler's cumulative divergence
  count grows faster than ``max_rate`` per draw;
* :class:`HeartbeatStall` — a ``stall`` record flowed by (re-arms on
  ``stall_recovered``).

Rules have rising-edge semantics: one ``alert`` record per episode,
re-armed when the condition clears, so a plateaued fit does not flood
the stream.  An :class:`AlertEngine` is a :class:`~multigrad_tpu_torch
.telemetry.MetricsLogger` **sink**; pass it as ``alerts=`` to any fit
entry point (or add it to the logger yourself) and fired alerts are
logged back into the same stream — the JSONL file, the live
``/status`` endpoint and the terminal dashboard all see them.  With
``flight=`` a firing rule marked ``escalate=True`` also trips the
:class:`~multigrad_tpu_torch.telemetry.flight.FlightRecorder` (non-fatal:
a postmortem bundle is dumped, the fit continues).

::

    engine = AlertEngine(flight=recorder)          # default rule set
    model.run_adam(guess, nsteps, telemetry=log, log_every=20,
                   alerts=engine)
    engine.alerts        # the fired alert records, host-side

Pure stdlib at module level, per the telemetry package contract.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

__all__ = ["AlertRule", "LossPlateau", "GradExplosion",
           "ThroughputDrop", "DivergenceRate", "HeartbeatStall",
           "default_rules", "AlertEngine"]


def _scalar(v):
    """Scalar view of a tap value (batched fits emit lists): the mean
    over members, so a single diverging ensemble member still moves
    the rule inputs."""
    if isinstance(v, (list, tuple)):
        vals = [float(x) for x in v
                if isinstance(x, (int, float))]
        return sum(vals) / len(vals) if vals else None
    return float(v) if isinstance(v, (int, float)) else None


def _median(values):
    values = sorted(values)
    n = len(values)
    if not n:
        return None
    mid = n // 2
    return values[mid] if n % 2 else 0.5 * (values[mid - 1]
                                            + values[mid])


class AlertRule:
    """Base class: stateful record-stream predicate with rising-edge
    firing.

    Subclasses implement :meth:`check`, returning a detail dict while
    the condition HOLDS and ``None`` otherwise; the base class turns
    that level signal into edge-triggered alerts (one per episode).

    Parameters
    ----------
    action : callable, optional
        ``action(alert_record)`` invoked when the rule fires — hook
        for paging, checkpoint forcing, LR scheduling.  Exceptions
        are swallowed (an alert action must never kill the fit).
    escalate : bool
        Also trip the engine's flight recorder (non-fatal bundle
        dump) on firing.
    """

    name = "alert"

    def __init__(self, action: Optional[Callable] = None,
                 escalate: bool = False):
        self.action = action
        self.escalate = bool(escalate)
        self._active = False

    def check(self, record: dict) -> Optional[dict]:
        raise NotImplementedError

    def reset(self):
        """Re-arm and clear trailing state (a new ``run``/``fit_plan``
        record resets every rule)."""
        self._active = False

    def update(self, record: dict) -> Optional[dict]:
        """Engine entry point: edge-filter :meth:`check`'s level
        signal."""
        detail = self.check(record)
        if detail is None:
            self._active = False
            return None
        if self._active:
            return None
        self._active = True
        return detail


class LossPlateau(AlertRule):
    """Loss EMA slope ~ 0: the fit has stopped improving.

    Tracks an exponential moving average of the tapped loss
    (``halflife`` in *records*) and its slope per step between
    consecutive records; fires when ``|slope|`` stays below
    ``rel_slope · (|ema| + eps)`` — a relative threshold, so it works
    for χ² losses in the thousands and log-MSE losses near zero —
    for ``patience`` consecutive records after ``min_records``.
    """

    name = "loss_plateau"

    def __init__(self, rel_slope: float = 1e-4, halflife: float = 10.0,
                 min_records: int = 8, patience: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.rel_slope = float(rel_slope)
        self.decay = 0.5 ** (1.0 / float(halflife))
        self.min_records = int(min_records)
        self.patience = int(patience)
        self.reset()

    def reset(self):
        super().reset()
        self._m = 0.0
        self._n = 0
        self._prev = None               # (step, corrected ema)
        self._flat = 0

    def check(self, record):
        if record.get("event") != "adam":
            return None
        loss = _scalar(record.get("loss"))
        step = record.get("step")
        if loss is None or step is None or loss != loss:
            return None
        self._n += 1
        self._m = self.decay * self._m + (1.0 - self.decay) * loss
        ema = self._m / (1.0 - self.decay ** self._n)
        prev, self._prev = self._prev, (step, ema)
        if prev is None or step <= prev[0]:
            return None
        slope = (ema - prev[1]) / (step - prev[0])
        limit = self.rel_slope * (abs(ema) + 1e-12)
        if self._n >= self.min_records and abs(slope) < limit:
            self._flat += 1
        else:
            self._flat = 0
        if self._flat >= self.patience:
            return {"message": "loss EMA has plateaued",
                    "loss_ema": round(ema, 6),
                    "ema_slope": slope, "slope_limit": limit}
        return None


class GradExplosion(AlertRule):
    """|grad| spikes ``factor``× above its trailing median."""

    name = "grad_explosion"

    def __init__(self, factor: float = 50.0, window: int = 16,
                 min_records: int = 4, **kwargs):
        super().__init__(**kwargs)
        self.factor = float(factor)
        self.window = int(window)
        self.min_records = int(min_records)
        self.reset()

    def reset(self):
        super().reset()
        self._norms: List[float] = []

    def check(self, record):
        if record.get("event") != "adam":
            return None
        g = _scalar(record.get("grad_norm"))
        if g is None or g != g:
            return None
        med = _median(self._norms[-self.window:])
        self._norms.append(g)
        del self._norms[:-self.window - 1]
        if (med is not None and len(self._norms) > self.min_records
                and g > self.factor * max(med, 1e-30)):
            return {"message": "gradient norm exploded",
                    "grad_norm": g, "trailing_median": med,
                    "factor": round(g / max(med, 1e-30), 2)}
        return None


class ThroughputDrop(AlertRule):
    """Steps/s falls below ``frac`` of its trailing median.

    Rates are measured between consecutive ``adam`` records (wall
    time from ``t``, steps from ``step``), so the rule needs no extra
    instrumentation — a slowing host, a saturating prefetch, or a
    competing tenant all show up here first.
    """

    name = "throughput_drop"

    def __init__(self, frac: float = 0.5, window: int = 12,
                 min_records: int = 6, **kwargs):
        super().__init__(**kwargs)
        self.frac = float(frac)
        self.window = int(window)
        self.min_records = int(min_records)
        self.reset()

    def reset(self):
        super().reset()
        self._prev = None               # (t, step)
        self._rates: List[float] = []

    def check(self, record):
        if record.get("event") != "adam":
            return None
        t, step = record.get("t"), record.get("step")
        if t is None or step is None:
            return None
        prev, self._prev = self._prev, (t, step)
        if prev is None or step <= prev[1] or t <= prev[0]:
            return None
        rate = (step - prev[1]) / (t - prev[0])
        med = _median(self._rates[-self.window:])
        self._rates.append(rate)
        del self._rates[:-self.window - 1]
        if (med is not None and len(self._rates) > self.min_records
                and rate < self.frac * med):
            return {"message": "throughput dropped",
                    "steps_per_sec": round(rate, 4),
                    "trailing_median": round(med, 4),
                    "frac": round(rate / med, 4)}
        return None


class DivergenceRate(AlertRule):
    """HMC divergences accumulate faster than ``max_rate`` per draw."""

    name = "divergence_rate"

    def __init__(self, max_rate: float = 0.1, min_draws: int = 20,
                 **kwargs):
        super().__init__(**kwargs)
        self.max_rate = float(max_rate)
        self.min_draws = int(min_draws)
        self.reset()

    def check(self, record):
        if record.get("event") != "hmc":
            return None
        div = record.get("divergences")
        if isinstance(div, (list, tuple)):
            div = sum(float(d) for d in div)
        step = record.get("step")
        if not isinstance(div, (int, float)) or not step:
            return None
        rate = div / step
        if step >= self.min_draws and rate > self.max_rate:
            return {"message": "HMC divergence rate is high",
                    "divergences": div, "draws": step,
                    "rate": round(rate, 4)}
        return None


class HeartbeatStall(AlertRule):
    """A ``stall`` record flowed by (the Heartbeat thread's verdict);
    re-arms on ``stall_recovered``."""

    name = "heartbeat_stall"

    def check(self, record):      # pragma: no cover - update overrides
        return None

    def update(self, record):
        # Stall records are one-per-episode (Heartbeat's contract), so
        # the base class's level->edge filter cannot apply: hold the
        # episode open until a `stall_recovered` record re-arms.
        event = record.get("event")
        if event == "stall_recovered":
            self._active = False
            return None
        if event != "stall":
            return None
        if self._active:
            return None
        self._active = True
        return {"message": "fit loop stalled",
                "stalled_s": record.get("stalled_s")}


def _accepted_kwargs(cls) -> set:
    """Named constructor parameters across ``cls``'s MRO (so a
    rule-specific override is forwarded only where it applies)."""
    import inspect

    names = set()
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        for name, p in inspect.signature(init).parameters.items():
            if name != "self" and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                             p.KEYWORD_ONLY):
                names.add(name)
    return names


def default_rules(**overrides) -> list:
    """One instance of every shipped rule, default thresholds.

    ``overrides`` are forwarded to every constructor that accepts
    them — ``escalate=True`` arms flight-recorder escalation across
    the board, while a rule-specific knob (``rel_slope=1e-3``)
    reaches only its rule instead of raising on the others.
    """
    classes = (LossPlateau, GradExplosion, ThroughputDrop,
               DivergenceRate, HeartbeatStall)
    return [cls(**{k: v for k, v in overrides.items()
                   if k in _accepted_kwargs(cls)})
            for cls in classes]


class AlertEngine:
    """Evaluate alert rules on a record stream (a MetricsLogger sink).

    Every non-``alert`` record is offered to every rule; a firing
    rule's detail becomes an ``alert`` record — logged back into the
    bound stream (so files, the live endpoint and dashboards see it)
    and collected in :attr:`alerts`.  ``run``/``fit_plan`` records
    reset all rule state, so one engine serves a sequence of fits.

    Parameters
    ----------
    rules : sequence of AlertRule, optional
        Default: :func:`default_rules`.
    flight : FlightRecorder, optional
        Escalation target for rules constructed with
        ``escalate=True`` — the trip is non-fatal (bundle dumped,
        fit continues).
    on_alert : callable, optional
        Engine-wide ``on_alert(alert_record)`` hook, called after any
        rule fires (in addition to per-rule ``action``\\ s).

    A broken rule is disabled after its first exception (one
    ``alert`` record with ``severity="error"`` reports it) — alert
    evaluation must never take the fit down with it.
    """

    def __init__(self, rules=None, flight=None,
                 on_alert: Optional[Callable] = None):
        self.rules = list(rules) if rules is not None \
            else default_rules()
        self.flight = flight
        self.on_alert = on_alert
        self.alerts: List[dict] = []
        self._logger = None
        self._dead: set = set()

    def bind_logger(self, logger):
        """Bind the stream alerts are emitted into (the fit drivers'
        ``wire_monitoring`` calls this)."""
        self._logger = logger

    # -- sink protocol ------------------------------------------------------
    def write(self, record: dict):
        event = record.get("event")
        if event == "alert":
            return                       # never react to our own output
        if event in ("run", "fit_plan"):
            for rule in self.rules:
                rule.reset()
        for rule in self.rules:
            if id(rule) in self._dead:
                continue
            try:
                detail = rule.update(record)
            except Exception as e:
                self._dead.add(id(rule))
                self._emit(rule.name, {
                    "message": f"alert rule disabled after error: {e}",
                }, severity="error", record=record, rule=rule,
                    escalate=False)
                continue
            if detail is not None:
                self._emit(rule.name, detail, record=record,
                           rule=rule)

    def close(self):
        pass

    # -- firing -------------------------------------------------------------
    def _emit(self, name: str, detail: dict, record=None, rule=None,
              severity: str = "warning", escalate=None):
        fields = {"rule": name, "severity": severity,
                  "step": (record or {}).get("step"), **detail}
        if self._logger is not None:
            # MetricsLogger's lock is re-entrant, so emitting from
            # inside a sink's write() fans the alert out to every
            # OTHER sink too (the engine ignores `alert` events).
            alert = self._logger.log("alert", **fields)
        else:
            alert = {"event": "alert", "t": time.time(), **fields}
        self.alerts.append(alert)
        do_escalate = (rule.escalate if escalate is None and
                       rule is not None else bool(escalate))
        if self.flight is not None and do_escalate:
            self.flight.trip(f"alert_{name}", fatal=False,
                             step=fields.get("step"), **detail)
        for hook in (getattr(rule, "action", None), self.on_alert):
            if hook is None:
                continue
            try:
                hook(alert)
            except Exception:
                pass                    # actions must never kill a fit
        return alert
