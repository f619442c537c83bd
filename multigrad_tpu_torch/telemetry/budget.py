"""SLO error budgets and multi-window burn-rate alerting (a copy of
:mod:`multigrad_tpu.telemetry.budget`).

The :class:`~multigrad_tpu_torch.serve.slo.SloMonitor` renders a live
verdict — "interactive p95 is 0.41 s against a 0.5 s SLO" — but a
verdict has no memory: it cannot say how much violation headroom is
*left*, nor how fast it is being consumed.  This module adds both,
the SRE way:

* an :class:`~multigrad_tpu_torch.serve.slo.Slo` carries an
  **allowed-violation budget** (default ``1 - quantile``: a p95
  objective tolerates 5 % violating requests);
* :class:`SloBudget` counts good/bad observations in a
  :class:`~multigrad_tpu_torch.telemetry.rollup.RollupStore` and derives,
  over a rolling compliance window,

  - ``remaining_frac`` — the unspent budget fraction,
  - ``burn_rate`` — violation fraction over a window divided by the
    budget (1.0 = burning exactly at the sustainable rate), tracked
    over **multi-window pairs** (fast 5 m/1 h and slow 1 h/6 h — the
    Google SRE workbook shape: the short window catches the fire,
    the long window stops a single spike from paging),
  - ``exhaustion_eta_s`` — seconds until the budget hits zero at the
    current fast burn;

* the three land as ``multigrad_slo_budget_*`` gauges (labelled by
  ``priority_class``), budget-burning fits additionally observe into
  ``multigrad_slo_budget_violation_seconds`` with their **trace id
  as the exemplar** — from a burning budget straight to an offending
  trace;
* :class:`BurnRateAlert` is an :class:`~multigrad_tpu_torch.telemetry
  .alerts.AlertRule`: rising-edge, one ``alert`` record per burn
  episode, wired into any :class:`~multigrad_tpu_torch.telemetry.alerts
  .AlertEngine` next to the default rules.

Pure stdlib at module level, per the telemetry package contract;
never imports :mod:`multigrad_tpu_torch.serve` (the serve layer constructs
budgets from its ``Slo`` objects, not the other way around).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from .alerts import AlertRule
from .rollup import RollupStore

__all__ = ["SloBudget", "BurnRateAlert",
           "FAST_WINDOWS", "SLOW_WINDOWS",
           "FAST_BURN_THRESHOLD", "SLOW_BURN_THRESHOLD"]

#: Multi-window burn pairs (seconds) and page thresholds — the SRE
#: workbook's 5 m/1 h fast pair at 14.4× and 1 h/6 h slow pair at 6×.
FAST_WINDOWS = (300.0, 3600.0)
SLOW_WINDOWS = (3600.0, 21600.0)
FAST_BURN_THRESHOLD = 14.4
SLOW_BURN_THRESHOLD = 6.0


class SloBudget:
    """Error-budget ledger for one priority class.

    Parameters
    ----------
    priority_class : str
        The class this ledger covers (gauge label).
    threshold_s : float
        Latency objective — an observation above it burns budget.
    budget : float
        Allowed violating fraction over the compliance window
        (``0.05`` = 5 %).
    live : LiveMetrics, optional
        Registry the gauges/exemplars export into.
    window_s : float
        Rolling compliance window the remaining fraction is computed
        over (default 6 h — the slow pair's long window, i.e. the
        store's full retention).
    clock : callable
        Injected time source (tests hand-compute against a fake
        clock).
    """

    def __init__(self, priority_class: str, threshold_s: float,
                 budget: float = 0.05, live=None,
                 window_s: float = 21600.0,
                 fast_threshold: float = FAST_BURN_THRESHOLD,
                 slow_threshold: float = SLOW_BURN_THRESHOLD,
                 clock=time.time):
        if not (0.0 < float(budget) <= 1.0):
            raise ValueError(
                f"budget must be in (0, 1], got {budget}")
        self.priority_class = str(priority_class)
        self.threshold_s = float(threshold_s)
        self.budget = float(budget)
        self.window_s = float(window_s)
        self.fast_threshold = float(fast_threshold)
        self.slow_threshold = float(slow_threshold)
        self._clock = clock
        # The ledger IS a rollup store: two counter series, windows
        # and retention for free.  10 s base windows resolve the 5 m
        # fast pair; the 10 m tier's 48-ring covers the 6 h window.
        self._store = RollupStore(clock=clock)
        self._live = live
        self._labels = {"priority_class": self.priority_class}
        self._export()

    # ---------------------------------------------------------- #
    # feeding
    # ---------------------------------------------------------- #
    def observe(self, e2e_s: float,
                trace_id: Optional[str] = None,
                t: Optional[float] = None):
        """Fold one served request; latency above the objective
        burns budget (and exports the trace id as the violation
        exemplar)."""
        bad = float(e2e_s) > self.threshold_s
        self._store.inc("total", 1.0, t=t)
        if bad:
            self._store.inc("bad", 1.0, t=t)
            if self._live is not None:
                self._live.observe(
                    "multigrad_slo_budget_violation_seconds",
                    float(e2e_s), labels=dict(self._labels),
                    exemplar=trace_id,
                    help="latency of budget-burning fits "
                         "(exemplar: trace id)")
        self._export(t=t)

    def record_shed(self, t: Optional[float] = None):
        """A shed request is a violated request: it burns budget."""
        self._store.inc("total", 1.0, t=t)
        self._store.inc("bad", 1.0, t=t)
        self._export(t=t)

    # ---------------------------------------------------------- #
    # arithmetic
    # ---------------------------------------------------------- #
    def burn_rate(self, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        """Violating fraction over the window divided by the budget;
        ``None`` with no traffic in the window."""
        total = self._store.delta("total", window_s, now=now)
        if not total:
            return None
        bad = self._store.delta("bad", window_s, now=now) or 0.0
        return (bad / total) / self.budget

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The budget state, hand-computable: ``remaining_frac =
        1 - bad/(total*budget)`` over the compliance window;
        ``burn_rate`` is the fast pair's short window;
        ``exhaustion_eta_s = remaining_frac * window_s / burn_rate``
        (the time to spend what's left at the current pace)."""
        now = self._clock() if now is None else now
        total = self._store.delta("total", self.window_s,
                                  now=now) or 0.0
        bad = self._store.delta("bad", self.window_s, now=now) or 0.0
        if total > 0:
            spent = bad / (total * self.budget)
            remaining = max(0.0, 1.0 - spent)
        else:
            remaining = 1.0
        fast_short = self.burn_rate(FAST_WINDOWS[0], now=now)
        fast_long = self.burn_rate(FAST_WINDOWS[1], now=now)
        slow_short = self.burn_rate(SLOW_WINDOWS[0], now=now)
        slow_long = self.burn_rate(SLOW_WINDOWS[1], now=now)
        burn = fast_short if fast_short is not None else 0.0
        eta = None
        if burn > 0 and remaining > 0:
            eta = remaining * self.window_s / burn
        elif remaining <= 0:
            eta = 0.0
        return {
            "priority_class": self.priority_class,
            "budget": self.budget,
            "total": int(total), "violations": int(bad),
            "remaining_frac": remaining,
            "burn_rate": burn,
            "burn_rate_fast": (fast_short, fast_long),
            "burn_rate_slow": (slow_short, slow_long),
            "fast_burning": self._pair_burning(
                fast_short, fast_long, self.fast_threshold),
            "slow_burning": self._pair_burning(
                slow_short, slow_long, self.slow_threshold),
            "exhaustion_eta_s": eta,
        }

    @staticmethod
    def _pair_burning(short, long, threshold) -> bool:
        """A pair pages only when BOTH windows exceed the threshold —
        the long window vetoes one-spike pages, the short window ends
        the alert promptly once the fire is out."""
        return (short is not None and long is not None
                and short > threshold and long > threshold)

    def fast_burning(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        return self._pair_burning(
            self.burn_rate(FAST_WINDOWS[0], now=now),
            self.burn_rate(FAST_WINDOWS[1], now=now),
            self.fast_threshold)

    # ---------------------------------------------------------- #
    # export
    # ---------------------------------------------------------- #
    def _export(self, t: Optional[float] = None):
        if self._live is None:
            return
        snap = self.snapshot(now=t)
        self._live.set("multigrad_slo_budget_remaining_frac",
                       snap["remaining_frac"],
                       labels=dict(self._labels),
                       help="unspent error-budget fraction over "
                            "the compliance window")
        self._live.set("multigrad_slo_budget_burn_rate",
                       snap["burn_rate"],
                       labels=dict(self._labels),
                       help="fast-window burn rate (1.0 = "
                            "sustainable pace)")
        self._live.set("multigrad_slo_budget_fast_burning",
                       1.0 if snap["fast_burning"] else 0.0,
                       labels=dict(self._labels),
                       help="1 when the fast multi-window pair "
                            "exceeds its page threshold")
        if snap["exhaustion_eta_s"] is not None:
            self._live.set("multigrad_slo_budget_exhaustion_eta_s",
                           snap["exhaustion_eta_s"],
                           labels=dict(self._labels),
                           help="seconds to budget exhaustion at "
                                "the current burn")


class BurnRateAlert(AlertRule):
    """Rising-edge alert over a set of :class:`SloBudget` ledgers.

    Evaluated on every record the :class:`~multigrad_tpu_torch.telemetry
    .alerts.AlertEngine` sees; the condition HOLDS while any class's
    fast multi-window pair exceeds its threshold, so the base class's
    edge filter yields exactly one ``alert`` record per burn episode
    (re-armed when every class stops burning).

    Parameters
    ----------
    budgets : mapping or object with ``.budgets``
        ``{priority_class: SloBudget}`` — pass a ``SloMonitor``
        directly, its ``budgets`` attribute is picked up.
    """

    name = "slo_burn_rate"

    def __init__(self, budgets, action=None, escalate: bool = False):
        super().__init__(action=action, escalate=escalate)
        self._budgets = budgets

    def _ledgers(self) -> Dict[str, SloBudget]:
        b = getattr(self._budgets, "budgets", self._budgets)
        return b if isinstance(b, dict) else {}

    def check(self, record: dict) -> Optional[dict]:
        burning = {}
        for cls, ledger in self._ledgers().items():
            try:
                if ledger.fast_burning():
                    snap = ledger.snapshot()
                    burning[cls] = {
                        "burn_rate": round(snap["burn_rate"], 3),
                        "remaining_frac": round(
                            snap["remaining_frac"], 4),
                        "exhaustion_eta_s": (
                            round(snap["exhaustion_eta_s"], 1)
                            if snap["exhaustion_eta_s"] is not None
                            else None),
                    }
            except Exception:
                # A broken ledger must not take down the alert
                # engine's whole rule set; skip it this record.
                continue
        if not burning:
            return None
        return {"classes": burning,
                "threshold": FAST_BURN_THRESHOLD,
                "windows_s": list(FAST_WINDOWS)}
