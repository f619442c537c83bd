"""Multi-tenant QoS: priorities, weighted fairness, deadline packing (a copy of
:mod:`multigrad_tpu.serve.qos`).

The policy half of the serving layer's scheduling decisions.  The
FIFO :class:`~multigrad_tpu_torch.serve.queue.FitQueue` treats every
request identically — one heavy tenant starves everyone, shedding
evicts whoever submitted last, and tail latency is an outcome, not a
policy.  This module turns each of those decisions into an explicit,
testable policy object:

* :class:`QosTag` — who a request belongs to (``tenant``), how much
  it matters (``priority_class``), and how soon it is useful
  (``slo_deadline_s``).  The tag rides ON THE REQUEST, deliberately
  NOT inside :class:`~multigrad_tpu_torch.serve.queue.FitConfig`: the
  config is the batchability key (and the fleet's affinity key), so
  same-config fits from *different tenants still co-batch into one
  bucket* — the paper's core economics (a marginal bucket row is
  nearly free) is exactly why multi-tenancy works here, and putting
  the tenant in the key would shatter buckets per tenant and
  multiply retraces for zero isolation gain.
* :class:`QosPolicy` — the scheduling policy the queue consults:
  **deficit round-robin** over tenants (weighted fair shares;
  a tenant submitting 10x faster gets its fair share, not 10x),
  then **EDF** (earliest deadline first) within the winning
  tenant's config home, per-tenant admission quotas
  (:class:`TenantQuotaError` — "YOU are over quota" — rejects
  before the global queue-full), and class-aware shedding: a full
  queue sheds the *lowest* priority class with the most slack
  (:class:`FitShedError`) to admit strictly-higher-class work.

Deadline-aware bucket packing is the composition of three existing
mechanisms with the EDF dequeue order: ``buckets="auto"`` resolves
the bucket ladder (the cold-table ladder until the port has its
autotuner), ``k_budget_bytes`` caps it with the memory model,
and the queue hands the scheduler each group EDF-ordered — so when
a group splits across dispatches, the earliest deadlines ride the
first bucket, and a head-of-line request whose deadline is tighter
than the batch window collapses the window to zero
(:meth:`QosPolicy.effective_window`) instead of idling its slack
away waiting for stragglers to coalesce.

Concurrency contract: a :class:`QosPolicy` instance is owned by
exactly one :class:`~multigrad_tpu_torch.serve.queue.FitQueue`; every
mutating method (``select`` / ``charge`` / ``check_quota`` /
``shed_victim`` / ``record_shed``) is called *inside* that queue's
``_lock`` critical sections, so the policy carries no lock of its
own — the queue's lock is the policy's lock.  Read shed counters
through :meth:`FitQueue.qos_counts`, which takes the queue lock.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .queue import QueueFullError

__all__ = ["PRIORITY_CLASSES", "DEFAULT_TENANT", "DEFAULT_CLASS",
           "QosTag", "QosPolicy", "TenantQuotaError", "FitShedError",
           "class_rank", "request_tag", "make_tag", "edf_key",
           "edf_sorted", "deadlines_met", "jain_fairness"]

#: Built-in priority classes, ranked low → high.  Free-form class
#: names are allowed (a newer peer may send one this build has never
#: heard of); unknown classes rank lowest — a scheduler must never
#: give work it cannot identify precedence over work it can.
PRIORITY_CLASSES = ("batch", "standard", "interactive")

DEFAULT_TENANT = "default"
DEFAULT_CLASS = "standard"


def class_rank(priority_class: str,
               order: Tuple[str, ...] = PRIORITY_CLASSES) -> int:
    """Rank of a priority class in ``order`` (0 = lowest, shed
    first).  Unknown classes rank 0."""
    try:
        return order.index(priority_class)
    except ValueError:
        return 0


@dataclass(frozen=True)
class QosTag:
    """Per-request QoS identity: tenant, priority class, and an
    optional relative deadline.

    ``slo_deadline_s`` is the request's *useful-by* horizon in
    seconds from submit: it becomes the request's absolute deadline
    when the caller gave none, and it is the key EDF packs buckets
    by.  The tag is frozen and hashable but is **not** part of the
    batchability key — see the module docstring for why.
    """

    tenant: str = DEFAULT_TENANT
    priority_class: str = DEFAULT_CLASS
    slo_deadline_s: Optional[float] = None

    def __post_init__(self):
        for name in ("tenant", "priority_class"):
            value = getattr(self, name)
            if not isinstance(value, str) or not value:
                raise TypeError(
                    f"QosTag.{name} must be a non-empty str, "
                    f"got {value!r}")
        if self.slo_deadline_s is not None:
            object.__setattr__(self, "slo_deadline_s",
                               float(self.slo_deadline_s))
            if self.slo_deadline_s <= 0:
                raise ValueError(
                    f"QosTag.slo_deadline_s must be positive, got "
                    f"{self.slo_deadline_s}")


#: The identity every untagged request schedules as.
DEFAULT_TAG = QosTag()


def request_tag(req) -> QosTag:
    """The request's :class:`QosTag` (the default tag for untagged
    requests — legacy callers schedule as one shared tenant)."""
    tag = getattr(req, "qos", None)
    return tag if tag is not None else DEFAULT_TAG


def make_tag(qos=None, tenant: Optional[str] = None,
             priority_class: Optional[str] = None,
             slo_deadline_s: Optional[float] = None
             ) -> Optional[QosTag]:
    """Coerce the submit-surface QoS kwargs into one tag.

    ``qos`` (a prebuilt :class:`QosTag`) wins; otherwise a tag is
    built from the piecewise fields; all-defaults returns ``None``
    so untagged requests stay untagged (and off the wire)."""
    if qos is not None:
        if not isinstance(qos, QosTag):
            raise TypeError(
                f"qos must be a QosTag, got {type(qos).__name__}")
        return qos
    if tenant is None and priority_class is None \
            and slo_deadline_s is None:
        return None
    return QosTag(
        tenant=DEFAULT_TENANT if tenant is None else tenant,
        priority_class=(DEFAULT_CLASS if priority_class is None
                        else priority_class),
        slo_deadline_s=slo_deadline_s)


class TenantQuotaError(QueueFullError):
    """Per-tenant admission quota pushed back — "YOU are over quota",
    distinct from "the queue is full": the queue may have plenty of
    headroom for *other* tenants.  A subclass of
    :class:`~multigrad_tpu_torch.serve.queue.QueueFullError` so existing
    backpressure handlers keep working unmodified."""

    def __init__(self, tenant: str, queued: int, quota: int):
        self.tenant = tenant
        self.queued = int(queued)
        self.quota = int(quota)
        super().__init__(
            f"tenant {tenant!r} is at its per-tenant quota "
            f"({queued}/{quota} queued); the queue itself has "
            "headroom — this is tenant admission control, not "
            "fleet saturation")


class FitShedError(QueueFullError):
    """A queued request was shed from a full queue to admit
    strictly-higher-class work (class-aware load shedding).  The
    shed request's future resolves with this; the error names both
    sides of the trade."""

    def __init__(self, request_id: int, tenant: str,
                 priority_class: str, shed_for: str):
        self.request_id = int(request_id)
        self.tenant = tenant
        self.priority_class = priority_class
        self.shed_for = shed_for
        super().__init__(
            f"request {request_id} (class {priority_class!r}, "
            f"tenant {tenant!r}) shed from a full queue to admit "
            f"{shed_for!r}-class work")


def edf_key(req, order: Tuple[str, ...] = PRIORITY_CLASSES) -> tuple:
    """Earliest-deadline-first sort key: finite deadlines first
    (ascending), then higher class, then FIFO.  Deadline-less
    requests sort after every deadlined one — they have infinite
    slack by definition."""
    deadline = getattr(req, "deadline", None)
    tag = request_tag(req)
    return (deadline is None,
            0.0 if deadline is None else float(deadline),
            -class_rank(tag.priority_class, order),
            req.submitted_t, req.id)


def edf_sorted(requests, order: Tuple[str, ...] = PRIORITY_CLASSES
               ) -> list:
    """Requests in EDF order (stable)."""
    return sorted(requests, key=lambda r: edf_key(r, order))


def deadlines_met(requests, service_s: float, batch: int = 1,
                  now: float = 0.0) -> int:
    """How many deadlines a serving order meets: serve ``requests``
    in the given order, ``batch`` at a time, each dispatch costing
    ``service_s`` seconds — count the requests whose (absolute)
    deadline is ``None`` or ≥ their completion time.  The pure
    simulation the EDF-packing test and the fairness bench share."""
    met = 0
    for i, req in enumerate(requests):
        done_t = now + (i // max(1, int(batch)) + 1) * float(service_s)
        deadline = getattr(req, "deadline", None)
        if deadline is None or done_t <= deadline:
            met += 1
    return met


def jain_fairness(values) -> float:
    """Jain's fairness index over per-tenant allocations:
    ``(Σx)² / (n·Σx²)`` — 1.0 is perfectly fair, ``1/n`` is one
    tenant taking everything.  Empty or all-zero input is vacuously
    fair (1.0)."""
    vals = [float(v) for v in values]
    if not vals:
        return 1.0
    denom = len(vals) * sum(v * v for v in vals)
    if denom == 0:
        return 1.0
    total = sum(vals)
    return (total * total) / denom


@dataclass
class QosPolicy:
    """The scheduling policy a :class:`~multigrad_tpu_torch.serve.queue
    .FitQueue` consults when QoS is on.

    Parameters
    ----------
    class_order : tuple of str
        Priority classes, lowest first (shed order).  Unknown
        classes rank with the lowest.
    weights : dict tenant → float
        Fair-share weights for deficit round-robin; a weight-2
        tenant gets twice the dequeue credit per round of a
        weight-1 tenant.  ``default_weight`` covers tenants not
        listed.
    tenant_quota : int, optional
        Max *live* (non-expired, non-cancelled) queued requests per
        tenant; a submit past it raises :class:`TenantQuotaError`
        before the global queue-full check.
    quantum : float
        DRR credit granted per ring visit, scaled by the tenant's
        weight.  Request cost is 1.0.
    coalesce_cost : float
        What a non-winning tenant is charged for a row that rode the
        winner's bucket.  Less than 1.0 on purpose: a co-batched row
        is nearly free in device time (the paper's marginal-cost
        identity), so it must not cost a full turn — but it is not
        fully free either, or a heavy tenant could ride every bucket
        for nothing.  Deficits are clamped at one quantum of debt so
        co-batching can defer, never starve, a tenant's own turn.
    """

    enabled: bool = True
    class_order: Tuple[str, ...] = PRIORITY_CLASSES
    weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    tenant_quota: Optional[int] = None
    quantum: float = 2.0
    coalesce_cost: float = 0.25

    def __post_init__(self):
        self.class_order = tuple(str(c) for c in self.class_order)
        if self.tenant_quota is not None:
            self.tenant_quota = int(self.tenant_quota)
            if self.tenant_quota <= 0:
                raise ValueError("tenant_quota must be positive")
        # DRR + shed state — guarded by the owning FitQueue._lock
        # (see the module docstring's concurrency contract).
        self._ring: collections.deque = collections.deque()
        self._known: set = set()
        self._deficits: Dict[str, float] = {}
        self._last_winner: Optional[str] = None
        self._shed_by_class: collections.Counter = \
            collections.Counter()
        self._shed_by_tenant: collections.Counter = \
            collections.Counter()

    # -- identity helpers ---------------------------------------------------
    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def rank(self, priority_class: str) -> int:
        return class_rank(priority_class, self.class_order)

    # -- admission side (under the queue lock) ------------------------------
    def check_quota(self, pending, request, now: float):
        """Raise :class:`TenantQuotaError` when the request's tenant
        is at its quota of live queued requests.  Expired and
        cancelled requests do not count — a backlog of dead work
        must not lock a live tenant out (the admission-purge
        satellite's quota-side twin)."""
        if self.tenant_quota is None:
            return
        tenant = request_tag(request).tenant
        queued = sum(
            1 for r in pending
            if request_tag(r).tenant == tenant
            and not r.future.cancelled() and not r.expired(now))
        if queued >= self.tenant_quota:
            raise TenantQuotaError(tenant, queued, self.tenant_quota)

    def shed_victim(self, pending, incoming):
        """The queued request class-aware shedding evicts for
        ``incoming``: lowest priority class strictly below the
        incoming request's, ties broken toward the most slack
        (no deadline beats a far deadline beats a near one, then
        newest submit).  ``None`` when nothing queued ranks below
        the incoming class — equal classes never shed each other."""
        inc_rank = self.rank(request_tag(incoming).priority_class)
        victim = best = None
        for r in pending:
            if r.future.cancelled():
                continue
            rank = self.rank(request_tag(r).priority_class)
            if rank >= inc_rank:
                continue
            slack = (0, 0.0) if r.deadline is None \
                else (1, -float(r.deadline))
            key = (rank, slack, -r.submitted_t, -r.id)
            if best is None or key < best:
                victim, best = r, key
        return victim

    def record_shed(self, victim):
        tag = request_tag(victim)
        self._shed_by_class[tag.priority_class] += 1
        self._shed_by_tenant[tag.tenant] += 1

    def shed_error(self, victim, incoming) -> FitShedError:
        vtag = request_tag(victim)
        return FitShedError(victim.id, vtag.tenant,
                            vtag.priority_class,
                            request_tag(incoming).priority_class)

    def shed_counts(self) -> dict:
        """``{"by_class": {...}, "by_tenant": {...}}`` cumulative
        shed counters (read through :meth:`FitQueue.qos_counts`,
        which holds the queue lock)."""
        return {"by_class": dict(self._shed_by_class),
                "by_tenant": dict(self._shed_by_tenant)}

    # -- dequeue side (under the queue lock) --------------------------------
    def select(self, pending, now: float):
        """The request whose config home dequeues next: deficit
        round-robin picks the winning tenant, EDF picks the winner's
        most urgent request."""
        by_tenant: dict = {}
        for r in pending:
            if r.future.cancelled():
                continue
            by_tenant.setdefault(request_tag(r).tenant, []).append(r)
        if not by_tenant:
            return pending[0]
        winner = self._drr_pick(list(by_tenant))
        self._last_winner = winner
        return min(by_tenant[winner],
                   key=lambda r: edf_key(r, self.class_order))

    def _drr_pick(self, tenants) -> str:
        """Deficit round-robin: visit tenants in ring order, each
        visit granting ``quantum × weight`` credit (capped at one
        quantum — idle tenants must not bank unbounded credit);
        first active tenant whose deficit covers one request wins."""
        active = set(tenants)
        for t in tenants:
            if t not in self._known:
                self._known.add(t)
                self._ring.append(t)
                self._deficits.setdefault(t, 0.0)
        for _ in range(2 * len(self._ring)):
            t = self._ring[0]
            self._ring.rotate(-1)
            if t not in active:
                continue
            if self._deficits[t] >= 1.0:
                return t
            credit = self.quantum * self.weight(t)
            self._deficits[t] = min(self._deficits[t] + credit,
                                    max(1.0, credit))
            if self._deficits[t] >= 1.0:
                return t
        # Degenerate (all weights ≈ 0): serve somebody rather than
        # spin — the first active tenant in submit order.
        return tenants[0]

    def charge(self, group):
        """Debit the dequeued group's tenants: the winner pays full
        fare, co-batched riders pay ``coalesce_cost``.  Debt is
        clamped at one quantum so riding buckets defers a tenant's
        next turn, never starves it."""
        winner = self._last_winner
        for r in group:
            t = request_tag(r).tenant
            cost = 1.0 if (winner is None or t == winner) \
                else self.coalesce_cost
            cap = max(1.0, self.quantum * self.weight(t))
            self._deficits[t] = max(
                self._deficits.get(t, 0.0) - cost, -cap)

    def order_group(self, group) -> list:
        """Bucket packing order for a dequeued config home: the
        winning tenant's rows first (its turn), then co-batched
        riders — each side EDF-ordered, so when a group splits
        across dispatches the tightest deadlines ride the first
        bucket."""
        winner = self._last_winner
        return sorted(group, key=lambda r: (
            (0 if request_tag(r).tenant == winner else 1,)
            + edf_key(r, self.class_order)))

    def effective_window(self, head, window_s: float,
                         now: float) -> float:
        """Deadline-aware batch window: a head request whose slack
        is inside ~2 windows dispatches immediately — waiting for a
        fuller bucket would spend the very slack the deadline
        protects."""
        if window_s <= 0 or head.deadline is None:
            return window_s
        if head.deadline - now < 2.0 * window_s:
            return 0.0
        return window_s
