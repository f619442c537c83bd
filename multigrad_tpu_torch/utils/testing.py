"""Shared test harnesses: deterministic-interleaving replay (a copy of
the harness in :mod:`multigrad_tpu.utils.testing`).

:class:`InterleaveController` / :func:`run_interleavings`: the races a
serving layer can have (a producer deadlock on a purge, a sink that
re-enters its own lock, a duplicate result where the first must win)
are found by review, because the thread schedule that triggers them
almost never happens under test load.  The harness makes those
schedules enumerable: worker callables yield at **scheduling points**
(explicit :func:`~multigrad_tpu_torch.utils.lockdep.sched_point` calls,
plus, with lockdep enabled, every contended wrapped-lock acquisition,
automatically), and a controller replays the workers under a chosen
permutation, one thread running at a time.  A schedule under which
every live thread is parked outside a scheduling point and nothing
changes for the deadlock window is reported as **deadlocked**, with
each stuck thread's stack.

The JAX module's exactness fixtures (``ExactShardModel``,
``bitwise_trajectory_pair``) come with sharded K (ROADMAP.md Queue 1
item 6).
"""
from __future__ import annotations

import itertools as _itertools
import sys as _sys
import threading as _threading
import time as _time
import traceback as _traceback

from .. import _lockdep

__all__ = ["InterleaveOutcome", "InterleaveController",
           "run_interleavings", "default_schedules"]


class InterleaveOutcome:
    """Result of replaying one schedule.

    ``deadlocked`` is True when every live thread sat parked outside
    a scheduling point (a real lock wait, a condition wait) with no
    state change for the deadlock window — the harness's verdict
    that this schedule wedges.  ``stuck`` maps each such thread's
    name to its stack at verdict time; ``errors`` collects
    exceptions worker callables raised (a
    :class:`~multigrad_tpu_torch.utils.lockdep.LockdepViolation` raised by
    a wrapped lock counts as a deadlock too — it is the detected
    form of one); ``trace`` is the ordered (thread, point-tag) log
    of scheduling points actually hit.
    """

    def __init__(self, schedule):
        self.schedule = tuple(schedule)
        self.deadlocked = False
        self.errors: list = []
        self.stuck: dict = {}
        self.trace: list = []

    def __repr__(self):
        state = "DEADLOCK" if self.deadlocked else (
            "errors" if self.errors else "ok")
        return (f"<InterleaveOutcome {state} "
                f"schedule={self.schedule}>")


class _TState:
    __slots__ = ("idx", "name", "status", "granted", "error",
                 "tag", "ident")

    def __init__(self, idx, name):
        self.idx = idx
        self.name = name
        self.status = "new"       # new/waiting/blocked/running/done/error
        self.granted = False
        self.error = None
        self.tag = None
        self.ident = None


class InterleaveController:
    """Replays N worker callables under one explicit interleaving.

    One thread runs at a time: each worker parks at every scheduling
    point (:func:`~multigrad_tpu_torch.utils.lockdep.sched_point`, or a
    contended lockdep-wrapped lock acquisition) until the controller
    grants it the next turn per ``schedule`` — a sequence of thread
    indices cycled until every worker finishes.

    A granted thread that neither parks nor finishes within
    ``stall_timeout_s`` is *opaque-blocked* (e.g. inside a plain
    ``Condition.wait`` the harness cannot see into); the controller
    moves on and re-offers turns.  When every live thread is
    opaque-blocked or lock-blocked and nothing changes for
    ``deadlock_timeout_s``, the schedule is declared **deadlocked**
    and each stuck thread's stack is captured.
    """

    def __init__(self, stall_timeout_s: float = 0.05,
                 deadlock_timeout_s: float = 0.5):
        self.stall_timeout_s = float(stall_timeout_s)
        self.deadlock_timeout_s = float(deadlock_timeout_s)
        self._cv = _threading.Condition()
        self._states: list = []
        self._idents: dict = {}
        self._closed = False
        self._version = 0

    # -- worker-side hooks (lockdep protocol) --------------------------- #
    def managed(self, ident) -> bool:
        return not self._closed and ident in self._idents

    def point(self, tag=None):
        self._park(self._idents[_threading.get_ident()],
                   "waiting", tag)

    def blocked(self, lockname):
        self._park(self._idents[_threading.get_ident()],
                   "blocked", lockname)

    def _park(self, ts, status, tag):
        with self._cv:
            if self._closed:
                return
            ts.status = status
            ts.tag = tag
            self._version += 1
            self._cv.notify_all()
            while not ts.granted and not self._closed:
                self._cv.wait()
            ts.granted = False
            ts.status = "running"

    # -- controller side ------------------------------------------------ #
    def _worker(self, ts: _TState, fn, outcome: InterleaveOutcome):
        with self._cv:
            ts.ident = _threading.get_ident()
            self._idents[ts.ident] = ts
        self._park(ts, "waiting", "<start>")
        status, error = "done", None
        try:
            fn()
        except _lockdep.LockdepViolation as e:
            status, error = "error", e
        except BaseException as e:      # noqa: BLE001 — reported
            status, error = "error", e
        with self._cv:
            ts.status = status
            ts.error = error
            if error is not None:
                outcome.errors.append(error)
            self._version += 1
            self._cv.notify_all()

    def run(self, workers, schedule, names=None,
            timeout_s: float = 10.0) -> InterleaveOutcome:
        """Run ``workers`` (callables) under ``schedule``; returns
        the :class:`InterleaveOutcome`.  Threads left stuck by a
        deadlock verdict are daemons and are abandoned."""
        outcome = InterleaveOutcome(schedule)
        self._states = [
            _TState(i, (names[i] if names else f"t{i}"))
            for i in range(len(workers))]
        _lockdep.set_controller(self)
        threads = []
        try:
            for ts, fn in zip(self._states, workers):
                t = _threading.Thread(
                    target=self._worker, args=(ts, fn, outcome),
                    daemon=True,
                    name=f"mgt-interleave-{ts.name}")
                threads.append(t)
                t.start()
            self._drive(schedule, outcome, timeout_s)
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            _lockdep.set_controller(None)
            for t in threads:
                t.join(timeout=0.2)
        return outcome

    def _drive(self, schedule, outcome, timeout_s):
        deadline = _time.monotonic() + timeout_s
        cycle = _itertools.cycle(schedule)
        quiet_since = None
        while _time.monotonic() < deadline:
            with self._cv:
                alive = [ts for ts in self._states
                         if ts.status not in ("done", "error")]
                if not alive:
                    return
                grantable = [ts for ts in alive
                             if ts.status in ("waiting", "blocked")]
            if grantable:
                quiet_since = None
                # next schedule entry that is grantable
                ts = None
                for _ in range(len(schedule)):
                    idx = next(cycle)
                    cand = self._states[idx]
                    if cand in grantable:
                        ts = cand
                        break
                if ts is None:
                    ts = grantable[0]
                if ts.status == "waiting":
                    outcome.trace.append((ts.name, ts.tag))
                self._grant(ts)
                continue
            # nothing grantable: either some thread is genuinely
            # computing, or everything is opaque-blocked -> deadlock
            with self._cv:
                v = self._version
                self._cv.wait(self.stall_timeout_s)
                if self._version != v:
                    quiet_since = None
                    continue
            now = _time.monotonic()
            if quiet_since is None:
                quiet_since = now
            elif now - quiet_since >= self.deadlock_timeout_s:
                self._declare_deadlock(outcome)
                return
        self._declare_deadlock(outcome)

    def _grant(self, ts: _TState):
        with self._cv:
            ts.granted = True
            self._cv.notify_all()
            deadline = _time.monotonic() + self.stall_timeout_s
            while (ts.granted or ts.status == "running"):
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return          # opaque-blocked; move on
                self._cv.wait(remaining)

    def _declare_deadlock(self, outcome: InterleaveOutcome):
        outcome.deadlocked = True
        frames = _sys._current_frames()
        with self._cv:
            for ts in self._states:
                if ts.status in ("done", "error"):
                    continue
                frame = frames.get(ts.ident)
                outcome.stuck[ts.name] = (
                    "".join(_traceback.format_stack(frame))
                    if frame is not None else "<no stack>")


def default_schedules(n_threads: int, max_schedules: int = 16):
    """A deterministic schedule set for ``n_threads`` workers: every
    starting-order permutation, plus doubled-turn variants (a thread
    running two points per turn exposes different windows)."""
    perms = list(_itertools.permutations(range(n_threads)))
    doubled = [tuple(x for x in p for _ in range(2))
               for p in perms]
    out = perms + doubled
    return out[:max_schedules]


def run_interleavings(build, schedules=None, n_threads=None,
                      stall_timeout_s: float = 0.05,
                      deadlock_timeout_s: float = 0.5,
                      timeout_s: float = 10.0):
    """Replay a scenario under many schedules.

    ``build()`` must return a fresh list of worker callables (with
    fresh shared state closed over) per call; ``schedules`` defaults
    to :func:`default_schedules` over the worker count.  Returns the
    list of :class:`InterleaveOutcome`\\ s — assert
    ``not any(o.deadlocked for o in outcomes)`` for a fixed
    implementation, ``any(...)`` for a seeded-bug fixture.
    """
    outcomes = []
    first = build()
    if schedules is None:
        schedules = default_schedules(
            n_threads if n_threads is not None else len(first))
    workers = first
    for i, schedule in enumerate(schedules):
        if workers is None:
            workers = build()
        ctrl = InterleaveController(
            stall_timeout_s=stall_timeout_s,
            deadlock_timeout_s=deadlock_timeout_s)
        outcomes.append(ctrl.run(workers, schedule,
                                 timeout_s=timeout_s))
        workers = None
    return outcomes
