"""Runtime lock-dependency validation: the lockdep shadow (a copy of
:mod:`multigrad_tpu._lockdep`).

The static pass (:mod:`multigrad_tpu_torch.analysis.concurrency`) proves
lock-order and hold-while-blocking invariants from the AST; this
module is its runtime twin — the Linux-lockdep idea applied to the
serve/fleet layer's hand-threaded code.  Every lock the package
creates goes through the factories below (:func:`make_lock`,
:func:`make_rlock`, :func:`make_condition`) with a **canonical name**
(``"serve.queue.FitQueue._lock"`` — the same name the static pass
derives from the AST, which is what lets the two sides cross-check).

Off by default: without ``MGT_LOCKDEP=1`` the factories return plain
``threading`` primitives — zero overhead, tier-1 wall-clock
untouched.  Enabled, every acquisition records, per thread:

* **acquisition edges** — acquiring B while holding A adds the
  name-level edge ``A -> B`` (first-seen stacks kept for both ends);
* **order violations** — an edge that closes a cycle in the runtime
  edge graph is a potential deadlock, reported with the stack of
  *this* acquisition and the stack that recorded the reverse path's
  first edge (the "names both stacks" contract);
* **self-deadlock** — a thread blocking-acquiring a non-reentrant
  lock it already holds (a sink re-entering its own lock) raises
  :class:`LockdepViolation` immediately instead of hanging the
  process;
* **hold-while-blocking** — a lock held longer than
  ``MGT_LOCKDEP_HOLD_S`` seconds (default 1.0) is reported as a
  ``long-hold`` violation with the holder's stack: the runtime
  signature of a blocking call (socket, subprocess, device dispatch)
  made under a lock.  ``Condition.wait`` releases the lock, so
  waiting never counts.

Violations are emitted as ``lockdep_violation`` telemetry records
when a :class:`~multigrad_tpu_torch.telemetry.MetricsLogger` is registered
via :func:`set_logger`, and always kept in :func:`violations`.

**Cross-checking both ways** (:func:`crosscheck`): a runtime edge
absent from the static lock graph is a *static coverage hole* and
fails the run; a static cycle confirmed at runtime names both
stacks.  With ``MGT_LOCKDEP_DUMP=<dir>`` every process dumps its
edges + violations to ``<dir>/lockdep-<pid>.json`` at exit (workers
call :func:`maybe_dump` before ``os._exit``), and
``python -m multigrad_tpu_torch.analysis.lint --targets threads
--runtime-edges <dir>`` performs the cross-check as a CI gate.

This module is **stdlib-only** (no torch, no numpy, no intra-package
imports) so every layer — including :mod:`multigrad_tpu_torch.telemetry
.metrics`, which must stay cycle-free — can depend on it.

The interleaving harness (:mod:`multigrad_tpu_torch.utils.testing`) hooks
in through :func:`set_controller`: with a controller installed,
wrapped locks report blocked acquisitions as scheduling points, and
:func:`sched_point` lets test code mark explicit ones.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import traceback
from typing import Optional

__all__ = [
    "LockdepViolation", "enabled", "enable", "disable",
    "make_lock", "make_rlock", "make_condition",
    "edges", "violations", "reset", "crosscheck",
    "dump", "maybe_dump", "load_edge_dumps",
    "set_logger", "set_controller", "sched_point",
]

#: Env knob: ``MGT_LOCKDEP=1`` turns the shadow on process-wide.
ENV_FLAG = "MGT_LOCKDEP"
#: Env knob: directory each process dumps its edges/violations into
#: at exit (``lockdep-<pid>.json``).
ENV_DUMP = "MGT_LOCKDEP_DUMP"
#: Env knob: hold-while-blocking threshold in seconds.
ENV_HOLD_S = "MGT_LOCKDEP_HOLD_S"


class LockdepViolation(RuntimeError):
    """A deterministic lockdep violation (self-deadlock: a thread
    blocking on a non-reentrant lock it already holds).  Raised
    instead of hanging — the whole point of the shadow is to turn a
    wedge into a stack trace."""


# ------------------------------------------------------------------ #
# global state (guarded by a PLAIN lock — the registry must never
# route through the wrappers it implements)
# ------------------------------------------------------------------ #
_STATE = threading.Lock()
_enabled: Optional[bool] = None
_edges: dict = {}          # (src, dst) -> {"stack_src", "stack_dst", "t"}
_violations: list = []
_logger = None
_controller = None
_held = threading.local()  # per-thread list of _Held


class _Held:
    __slots__ = ("name", "obj", "t0", "count")

    def __init__(self, name, obj):
        self.name = name
        self.obj = obj
        self.t0 = time.monotonic()
        self.count = 1


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def enabled() -> bool:
    """Whether the shadow is on (env ``MGT_LOCKDEP``, overridable by
    :func:`enable`/:func:`disable` for tests)."""
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get(ENV_FLAG, "") not in ("", "0")
        if _enabled:
            _register_atexit()
    return _enabled


def enable():
    """Programmatic on-switch (tests).  Only locks created AFTER this
    call are wrapped."""
    global _enabled
    _enabled = True
    _register_atexit()


def disable():
    global _enabled
    _enabled = False


def set_logger(logger):
    """Emit every violation as a ``lockdep_violation`` telemetry
    record into ``logger`` (a MetricsLogger; None detaches)."""
    global _logger
    _logger = logger


def set_controller(controller):
    """Install (or remove, with ``None``) the interleaving-harness
    controller.  The controller must expose ``managed(ident)``,
    ``point(tag)`` and ``blocked(name)``."""
    global _controller
    _controller = controller


def sched_point(tag: Optional[str] = None):
    """Explicit scheduling point for the deterministic-interleaving
    harness: a no-op unless a controller is installed AND the calling
    thread is one the controller manages."""
    c = _controller
    if c is not None and c.managed(threading.get_ident()):
        c.point(tag)


def _hold_threshold() -> float:
    try:
        return float(os.environ.get(ENV_HOLD_S, "") or 1.0)
    except ValueError:
        return 1.0


def _record_violation(kind: str, **detail):
    rec = {"kind": kind, "t": time.time(),
           "thread": threading.current_thread().name, **detail}
    with _STATE:
        _violations.append(rec)
    logger = _logger
    if logger is not None:
        try:
            logger.log("lockdep_violation", **rec)
        except Exception:
            pass
    return rec


def _edge_reaches(src: str, dst: str, edge_map: dict) -> Optional[list]:
    """DFS: a path ``src -> ... -> dst`` over name edges, or None."""
    seen = set()
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for (a, b) in edge_map:
            if a == node and b not in seen:
                stack.append((b, path + [b]))
    return None


def _record_acquire(lock: "_DepLock"):
    stack = _held_stack()
    if stack:
        # Steady state is all-edges-already-known: probe first so
        # the stack render (the expensive part) happens only when a
        # NEW edge is actually inserted.  The probe-then-insert gap
        # can at worst make two racing threads both render a stack
        # for the same first occurrence — benign.
        with _STATE:
            fresh = any(h.name != lock.name
                        and (h.name, lock.name) not in _edges
                        for h in stack)
        if not fresh:
            stack.append(_Held(lock.name, lock))
            return
        here = "".join(traceback.format_stack(limit=12)[:-2])
        new_edges = []
        with _STATE:
            for h in stack:
                key = (h.name, lock.name)
                if h.name != lock.name and key not in _edges:
                    _edges[key] = {"stack_src": here,
                                   "stack_dst": here,
                                   "t": time.time()}
                    new_edges.append(key)
            # Cycle check OUTSIDE the registry lock would race a
            # concurrent edge insert; the graph is tiny, keep it in.
            cycle_hits = []
            for (a, b) in new_edges:
                path = _edge_reaches(b, a, dict(_edges))
                if path is not None:
                    rev = _edges.get((path[0], path[1]), {})
                    cycle_hits.append(((a, b), path, rev))
        for (a, b), path, rev in cycle_hits:
            _record_violation(
                "lock-order-cycle",
                edge=[a, b], cycle=path + [b],
                stack=here,
                other_stack=rev.get("stack_src", ""))
    stack.append(_Held(lock.name, lock))


def _record_release(lock: "_DepLock"):
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i].obj is lock:
            held = stack.pop(i)
            dt = time.monotonic() - held.t0
            if dt > _hold_threshold():
                _record_violation(
                    "long-hold", lock=lock.name,
                    held_s=round(dt, 3),
                    stack="".join(
                        traceback.format_stack(limit=12)[:-2]))
            return


class _DepLock:
    """Name-carrying wrapper around ``threading.Lock`` recording
    acquisition edges, self-deadlock, and hold duration."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        if blocking and not self._reentrant:
            for h in _held_stack():
                if h.obj is self:
                    _record_violation(
                        "self-deadlock", lock=self.name,
                        stack="".join(
                            traceback.format_stack(limit=12)[:-1]))
                    raise LockdepViolation(
                        f"thread {threading.current_thread().name} "
                        f"blocking on non-reentrant lock "
                        f"{self.name!r} it already holds")
        c = _controller
        if (blocking and timeout == -1 and c is not None
                and c.managed(threading.get_ident())):
            # Harness mode: a failed try-acquire is a scheduling
            # point — the controller learns the thread is blocked
            # (deterministic deadlock detection) and re-grants turns
            # until the lock frees up.
            while not self._inner.acquire(False):
                c.blocked(self.name)
            ok = True
        else:
            ok = (self._inner.acquire(blocking, timeout) if blocking
                  else self._inner.acquire(False))
        if ok:
            self._on_acquired()
        return ok

    def _on_acquired(self):
        _record_acquire(self)

    def release(self):
        _record_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<DepLock {self.name!r}>"


class _DepRLock(_DepLock):
    """Reentrant flavor: inner RLock; only the outermost acquire and
    the matching release touch the held stack."""

    _reentrant = True

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.RLock()
        self._depth_local = threading.local()

    def _depth(self) -> int:
        return getattr(self._depth_local, "n", 0)

    def _on_acquired(self):
        n = self._depth() + 1
        self._depth_local.n = n
        if n == 1:
            _record_acquire(self)

    def release(self):
        n = self._depth() - 1
        self._depth_local.n = n
        if n == 0:
            _record_release(self)
        self._inner.release()

    def locked(self):
        return self._depth() > 0


# ------------------------------------------------------------------ #
# factories — the one creation idiom the whole package uses
# ------------------------------------------------------------------ #
def make_lock(name: str, may_precede=None):
    """A mutex named for the lockdep shadow and the static graph.

    ``name`` is the canonical lock name the static pass derives from
    the AST (``"<module>.<Class>.<attr>"`` relative to the package
    root) — the factories and :mod:`multigrad_tpu_torch.analysis
    .concurrency` cross-check that they agree.  ``may_precede``
    (a tuple of canonical names, or ``"*"``) is a **static
    declaration**, read from the AST, of lock-order edges this lock
    is allowed to open that the analyzer cannot derive (a dynamic
    dispatch — e.g. a metrics logger's pluggable sinks); the runtime
    ignores it.  Returns a plain ``threading.Lock`` unless lockdep
    is enabled.
    """
    del may_precede
    if enabled():
        return _DepLock(name)
    return threading.Lock()


def make_rlock(name: str, may_precede=None):
    """Reentrant twin of :func:`make_lock`."""
    del may_precede
    if enabled():
        return _DepRLock(name)
    return threading.RLock()


def make_condition(name: str, lock=None):
    """A condition variable for the shadow.  ``lock`` (typically a
    sibling :func:`make_lock` product, so several conditions share
    one mutex) is wrapped as-is — ``threading.Condition`` drives any
    object with ``acquire``/``release``, so waits and re-acquires of
    a DepLock keep recording.  With ``lock=None`` and lockdep on,
    the condition gets its own named DepLock."""
    if lock is None and enabled():
        lock = _DepLock(name)
    return threading.Condition(lock)


# ------------------------------------------------------------------ #
# registry access + cross-check
# ------------------------------------------------------------------ #
def edges() -> dict:
    """Snapshot of the runtime edge map:
    ``{(src, dst): {"stack_src", "stack_dst", "t"}}``."""
    with _STATE:
        return dict(_edges)


def violations() -> list:
    with _STATE:
        return list(_violations)


def reset():
    """Clear edges and violations (tests)."""
    with _STATE:
        _edges.clear()
        _violations.clear()


def crosscheck(allowed_edges, wildcard_sources=(),
               runtime_edges=None) -> list:
    """Cross-check runtime acquisition edges against the static lock
    graph — **a runtime edge absent from the static graph is a
    static coverage hole** and must fail the run.

    ``allowed_edges`` is an iterable of ``(src, dst)`` canonical-name
    pairs (the static graph's derived + declared edges);
    ``wildcard_sources`` names locks declared ``may_precede="*"``.
    ``runtime_edges`` defaults to this process's live registry; pass
    a dict/iterable (e.g. from :func:`load_edge_dumps`) to check a
    fleet's dumped edges.  Returns one violation dict per hole.
    """
    allowed = set(tuple(e) for e in allowed_edges)
    wild = set(wildcard_sources)
    observed = runtime_edges if runtime_edges is not None else edges()
    holes = []
    items = (observed.items() if isinstance(observed, dict)
             else ((tuple(e), {}) for e in observed))
    for (src, dst), info in items:
        if (src, dst) in allowed or src in wild:
            continue
        holes.append({
            "kind": "static-coverage-hole",
            "edge": [src, dst],
            "stack": (info or {}).get("stack_src", ""),
        })
    return holes


def dump(path: str) -> str:
    """Write this process's edges + violations as JSON."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with _STATE:
        payload = {
            "pid": os.getpid(),
            "t": time.time(),
            "edges": [[a, b] for (a, b) in _edges],
            "violations": list(_violations),
        }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def maybe_dump() -> Optional[str]:
    """Dump to ``$MGT_LOCKDEP_DUMP/lockdep-<pid>.json`` when the env
    knob is set (no-op otherwise).  Safe to call repeatedly; the
    fleet worker calls it explicitly before ``os._exit`` (which
    skips atexit)."""
    out_dir = os.environ.get(ENV_DUMP)
    if not out_dir or not enabled():
        return None
    return dump(os.path.join(out_dir, f"lockdep-{os.getpid()}.json"))


_atexit_registered = False


def _register_atexit():
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(maybe_dump)


def load_edge_dumps(path):
    """Load one dump file — or every ``lockdep-*.json`` in a
    directory — into ``(edges, violations, loaded_paths)``: the
    fleet-wide runtime picture for :func:`crosscheck`.
    ``loaded_paths`` is the evidence trail — a caller gating CI on
    the cross-check MUST fail when it is empty (a missing/empty dump
    dir would otherwise read as a clean run)."""
    paths = []
    if os.path.isdir(path):
        paths = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("lockdep-") and f.endswith(".json"))
    elif os.path.exists(path):
        paths = [path]
    all_edges: dict = {}
    all_violations: list = []
    loaded = []
    for p in paths:
        try:
            with open(p) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        loaded.append(p)
        for e in payload.get("edges", ()):
            all_edges.setdefault(tuple(e), {"stack_src": "", "t": 0})
        for v in payload.get("violations", ()):
            all_violations.append(dict(v, source=p))
    return all_edges, all_violations, loaded
