"""Chaos-injection harness for the fit-fleet (a copy of
:mod:`multigrad_tpu.serve.chaos`).

The robustness proof of :mod:`~multigrad_tpu_torch.serve.fleet` is not the
happy path — it is what happens when a worker's host disappears
mid-burst.  :class:`ChaosController` injects exactly those failures
against a live :class:`~multigrad_tpu_torch.serve.fleet.FleetRouter`, at
configurable points, so tests and demos can assert the invariant the
fleet promises: **every submitted FitFuture resolves — result or
typed error, none lost, none hung.**

Injections (process-level faults need nothing from the worker;
protocol-level ones require workers spawned with ``chaos=True``):

===================  ==========================================
:meth:`kill`         SIGKILL — the spot-preemption worst case:
                     no drain, no goodbye; the router must detect
                     heartbeat/connection loss and re-enqueue.
:meth:`preempt`      SIGTERM — graceful preemption: the worker
                     drains and exits 0; the router routes around
                     it meanwhile.
:meth:`suspend` /    SIGSTOP / SIGCONT — a frozen host: heartbeats
:meth:`resume`       stop while the process lives; on resume, late
                     duplicate results must be ignored.
:meth:`inject_queue_full`
                     The worker rejects its next ``n`` submits as
                     queue-full — deterministic saturation, no
                     timing games — driving the reroute →
                     admission-reject path.
:meth:`stall`        The worker's submit path sleeps while
                     heartbeats keep flowing — the alive-but-
                     useless slow worker.
:meth:`pause_heartbeat`
                     Heartbeats stop while the worker keeps
                     serving — exercises false-positive death
                     declarations and late-result dedup.
===================  ==========================================

Scheduling hooks: :meth:`after` runs an injection on a timer,
:meth:`when` polls a predicate over the router (e.g. "≥ 16 requests
in flight on the victim") and fires at the matching moment —
the "configurable points" of the chaos contract.  Every injection is
recorded in ``.events`` for the post-run report.
"""
from __future__ import annotations

import os
import signal
import threading
import time

__all__ = ["ChaosController"]


class ChaosController:
    """Fault injector bound to one :class:`~multigrad_tpu_torch.serve
    .fleet.FleetRouter` (see module docstring for the menu)."""

    def __init__(self, router):
        self.router = router
        self.events: list = []
        self._timers: list = []
        self._watchers: list = []
        self._closed = False

    # ------------------------------------------------------------------ #
    # plumbing
    # ------------------------------------------------------------------ #
    def _handle(self, worker):
        """Resolve a worker index or id to its handle."""
        if isinstance(worker, int):
            return self.router.workers[worker]
        for w in self.router.workers:
            if w.id == worker:
                return w
        raise KeyError(f"no fleet worker {worker!r}")

    def _record(self, kind: str, **detail):
        self.events.append({"t": time.time(), "kind": kind,
                            **detail})

    def _signal(self, worker, sig, kind: str):
        handle = self._handle(worker)
        if handle.proc is None or handle.proc.poll() is not None:
            raise RuntimeError(
                f"worker {handle.id} has no live process to signal")
        os.kill(handle.proc.pid, sig)
        self._record(kind, worker=handle.id, pid=handle.proc.pid)
        return handle

    def _chaos_op(self, worker, **payload):
        if not self.router.chaos_enabled:
            raise RuntimeError(
                "protocol-level chaos needs FleetRouter(chaos=True) "
                "(workers ignore chaos ops otherwise)")
        handle = self._handle(worker)
        handle.send({"op": "chaos", **payload})
        self._record("chaos_op", worker=handle.id, **payload)
        return handle

    # ------------------------------------------------------------------ #
    # process-level faults
    # ------------------------------------------------------------------ #
    def kill(self, worker=0):
        """SIGKILL: the un-drained spot preemption."""
        return self._signal(worker, signal.SIGKILL, "kill")

    def preempt(self, worker=0):
        """SIGTERM: graceful preemption (worker drains, exits 0)."""
        return self._signal(worker, signal.SIGTERM, "preempt")

    def suspend(self, worker=0):
        """SIGSTOP: freeze the process (heartbeats stop)."""
        return self._signal(worker, signal.SIGSTOP, "suspend")

    def resume(self, worker=0):
        """SIGCONT: thaw a suspended worker."""
        return self._signal(worker, signal.SIGCONT, "resume")

    # ------------------------------------------------------------------ #
    # protocol-level faults (workers spawned with chaos=True)
    # ------------------------------------------------------------------ #
    def inject_queue_full(self, worker=0, n: int = 1):
        """The worker rejects its next ``n`` submits as queue-full."""
        return self._chaos_op(worker, what="queue_full", n=int(n))

    def stall(self, worker=0, duration_s: float = 1.0):
        """Wedge the worker's submit path for ``duration_s`` while
        heartbeats keep flowing."""
        return self._chaos_op(worker, what="stall",
                              duration_s=float(duration_s))

    def pause_heartbeat(self, worker=0, duration_s: float = 1.0):
        """Silence heartbeats for ``duration_s`` while the worker
        keeps serving — long enough and the router declares it lost
        and re-enqueues; the late duplicates must be dropped."""
        return self._chaos_op(worker, what="pause_heartbeat",
                              duration_s=float(duration_s))

    # ------------------------------------------------------------------ #
    # scheduling: injections at configurable points
    # ------------------------------------------------------------------ #
    def after(self, delay_s: float, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` after ``delay_s`` seconds."""
        t = threading.Timer(delay_s, self._guarded, (fn,) + args,
                            kwargs)
        t.daemon = True
        t.name = "mgt-chaos-timer"
        t.start()
        self._timers.append(t)
        return t

    def when(self, predicate, fn, *args, poll_s: float = 0.02,
             timeout_s: float = 60.0, **kwargs):
        """Fire ``fn`` the first moment ``predicate(router)`` is
        true (polled every ``poll_s``); give up after ``timeout_s``.
        Returns an event set once the injection has fired."""
        fired = threading.Event()

        def _watch():
            deadline = time.time() + timeout_s
            while not self._closed and time.time() < deadline:
                try:
                    if predicate(self.router):
                        self._guarded(fn, *args, **kwargs)
                        fired.set()
                        return
                except Exception:
                    return
                time.sleep(poll_s)

        t = threading.Thread(target=_watch, daemon=True,
                             name="mgt-chaos-watch")
        t.start()
        self._watchers.append(t)
        return fired

    def when_inflight(self, n: int, fn, *args, worker=None,
                      **kwargs):
        """Fire once ≥ ``n`` requests are in flight (on ``worker``
        if given, else fleet-wide) — "SIGKILL mid-burst with ≥ 16
        in-flight requests" as one line."""
        def _pred(router):
            if worker is None:
                return sum(len(w.inflight)
                           for w in router.workers) >= n
            return len(self._handle(worker).inflight) >= n
        return self.when(_pred, fn, *args, **kwargs)

    # ------------------------------------------------------------------ #
    def report(self) -> str:
        """Human-readable injection log."""
        if not self.events:
            return "no chaos injected"
        t0 = self.events[0]["t"]
        lines = []
        for e in self.events:
            detail = " ".join(f"{k}={v}" for k, v in e.items()
                              if k not in ("t", "kind"))
            lines.append(f"+{e['t'] - t0:6.2f}s  {e['kind']:<10s} "
                         f"{detail}")
        return "\n".join(lines)

    def _guarded(self, fn, *args, **kwargs):
        try:
            fn(*args, **kwargs)
        except Exception as e:           # a late timer must not die
            self._record("injection_failed", error=repr(e))

    def close(self):
        self._closed = True
        for t in self._timers:
            t.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
