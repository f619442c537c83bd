"""Concurrency static analysis: the thread-safety check registry.

Consumes the AST inventory of :mod:`.lockgraph` and reports through
the same :class:`~multigrad_tpu_torch.analysis.findings.Finding` machinery
as the SPMD checks — one registry, one severity model, one CI gate
(``python -m multigrad_tpu_torch.analysis.lint --targets threads``).

=====================  ==============================================
``lock-order-cycle``   the lock-acquisition-order graph (``with``
                       nesting + one level of intra-module calls +
                       ``may_precede`` declarations) contains a
                       cycle — the classic AB/BA deadlock, caught
                       before any thread runs
``cond-wait-no-while`` a ``Condition.wait()`` not guarded by a
                       ``while``-predicate loop: spurious wakeups
                       and lost-wakeup races (the
                       ``_purge_cancelled`` producer-deadlock class)
``notify-outside-lock`` ``notify``/``notify_all`` without holding
                       the condition's owning mutex (undefined
                       behavior per the threading docs; the waiter
                       can miss the wakeup)
``blocking-under-lock`` socket send/recv, subprocess waits,
                       ``time.sleep``, ``block_until_ready``, event/
                       process waits, semaphore acquires... while a
                       lock is held — the convoy/deadlock fuel the
                       serve layer's fixes kept finding by eye
``callback-under-lock`` a user callback (``on_*``, sink ``write``,
                       ``action``/``callback``) invoked while
                       holding a lock — re-entrancy (the
                       ``MetricsLogger`` sink shape) and arbitrary
                       lock-order edges injected by user code
``unlocked-shared-write`` an attribute written from ≥ 2 thread roots
                       with no common lock across its write sites
``thread-unnamed``     a ``threading.Thread`` spawn without a
                       descriptive ``name=`` (lockdep reports, trace
                       waterfalls and stuck-run dumps would say
                       ``Thread-7``)
``lockdep-name``       a lockdep factory call whose literal name
                       disagrees with the AST-derived canonical name
                       (the runtime shadow and this pass would stop
                       cross-checking the same graph)
``allowlist``          a ``# lock-ok:`` entry with no justification,
                       an unknown check id, or one that suppresses
                       nothing (stale)
``runtime-coverage``   (cross-check only) a lockdep runtime edge
                       absent from the static graph — a static
                       coverage hole — or a violation recorded at
                       runtime
=====================  ==============================================

**Allowlisting**: a finding that is deliberate is suppressed by a
trailing (or preceding-line) comment at its anchor line::

    self._sock.sendall(data)  # lock-ok: <check-id> <why it is safe>

The linter *verifies* the annotation: the check id must be real, the
justification non-empty, and the entry must actually suppress a
finding — zero unexplained findings, zero stale explanations.
"""
from __future__ import annotations

import collections
from typing import List, Optional

from .findings import ERROR, WARNING, Finding
from .lockgraph import (MAIN_ROOT, ConcurrencyModel, find_cycles,
                        scan_package, to_dot)

__all__ = ["THREAD_CHECK_IDS", "analyze_concurrency",
           "lock_order_dot", "crosscheck_runtime", "scan_package"]

THREAD_CHECK_IDS = (
    "lock-order-cycle", "cond-wait-no-while", "notify-outside-lock",
    "blocking-under-lock", "callback-under-lock",
    "unlocked-shared-write", "thread-unnamed", "lockdep-name",
    "allowlist", "runtime-coverage",
)

_PROGRAM = "threads"


def _where(module: str, lineno: int, func: str = "") -> str:
    mod_path = module.replace(".", "/") + ".py"
    fn = f" ({func})" if func else ""
    return f"{mod_path}:{lineno}{fn}"


class _Allowlist:
    def __init__(self, model: ConcurrencyModel):
        self.entries = model.allows
        self._index = {}
        for e in self.entries:
            self._index[(e.module, e.lineno, e.check)] = e
            # an annotation on the line ABOVE the anchor also counts
            self._index.setdefault(
                (e.module, e.lineno + 1, e.check), e)

    def suppress(self, check: str, module: str, lineno: int) -> bool:
        e = self._index.get((module, lineno, check))
        if e is not None and e.reason:
            e.used = True
            return True
        return False

    def verify(self) -> List[Finding]:
        out = []
        for e in self.entries:
            if e.check not in THREAD_CHECK_IDS:
                out.append(Finding(
                    "allowlist", ERROR,
                    f"lock-ok annotation names unknown check "
                    f"{e.check!r}", program=_PROGRAM,
                    where=_where(e.module, e.lineno)))
            elif not e.reason:
                out.append(Finding(
                    "allowlist", ERROR,
                    f"lock-ok annotation for {e.check!r} has no "
                    "justification — every allowlisted finding "
                    "must say WHY it is safe",
                    program=_PROGRAM,
                    where=_where(e.module, e.lineno)))
            elif not e.used:
                out.append(Finding(
                    "allowlist", WARNING,
                    f"stale lock-ok annotation: no {e.check!r} "
                    "finding at this line anymore — delete it or "
                    "move it to the real anchor",
                    program=_PROGRAM,
                    where=_where(e.module, e.lineno)))
        return out


def _check_cycles(model, allow) -> List[Finding]:
    out = []
    for cycle in find_cycles(model):
        steps = list(zip(cycle, cycle[1:]))
        sites = [e for e in model.edges
                 if not e.declared and (e.src, e.dst) in steps]
        anchor = sites[0] if sites else None
        mod = anchor.module if anchor else cycle[0].rsplit(
            ".", 2)[0]
        lineno = anchor.lineno if anchor else 0
        if allow.suppress("lock-order-cycle", mod, lineno):
            continue
        out.append(Finding(
            "lock-order-cycle", ERROR,
            "lock-acquisition-order cycle: "
            + " -> ".join(cycle)
            + " — two threads taking these locks in opposite "
              "orders deadlock",
            program=_PROGRAM,
            where=_where(mod, lineno,
                         anchor.func if anchor else ""),
            path="/".join(cycle)))
    return out


def _check_waits(model, allow) -> List[Finding]:
    out = []
    for w in model.waits:
        if w.in_while:
            continue
        if allow.suppress("cond-wait-no-while", w.module, w.lineno):
            continue
        out.append(Finding(
            "cond-wait-no-while", ERROR,
            f"Condition.wait() on {w.cond} is not guarded by a "
            "while-predicate loop — spurious wakeups and lost "
            "wakeups proceed on a false predicate",
            program=_PROGRAM,
            where=_where(w.module, w.lineno, w.func),
            path=w.cond))
    return out


def _check_notifies(model, allow) -> List[Finding]:
    """A notify site must hold the condition's owning mutex — either
    locally, or (for helper methods) in every intra-module call
    context that reaches it."""
    out = []
    for n in model.notifies:
        if n.owner in n.held:
            continue
        # one level up: every caller of this helper must hold it
        callers_hold = _callers_hold(model, n, n.owner)
        if callers_hold:
            continue
        if allow.suppress("notify-outside-lock", n.module, n.lineno):
            continue
        out.append(Finding(
            "notify-outside-lock", ERROR,
            f"{n.cond}.notify outside its owning lock "
            f"{n.owner} — waiters can miss the wakeup "
            "(undefined behavior per threading docs)",
            program=_PROGRAM,
            where=_where(n.module, n.lineno, n.func),
            path=n.cond))
    return out


def _callers_hold(model: ConcurrencyModel, notify, owner) -> bool:
    """True when every recorded intra-module call of the notify
    site's function holds ``owner`` at the call site (the
    ``_purge_cancelled`` pattern: a lock-holding consumer calls the
    helper).  No recorded caller = cannot prove = False."""
    sites = [c for c in model.calls
             if c[0] == notify.module and c[1] == notify.cls
             and c[2] == notify.func]
    return bool(sites) and all(owner in held
                               for (_m, _c, _f, held, _ln) in sites)


def _check_ops(model, allow) -> List[Finding]:
    out = []
    for op in model.ops:
        check = ("blocking-under-lock" if op.op == "blocking"
                 else "callback-under-lock")
        if allow.suppress(check, op.module, op.lineno):
            continue
        noun = ("blocking call" if op.op == "blocking"
                else "user callback")
        out.append(Finding(
            check, WARNING,
            f"{noun} {op.desc} while holding "
            f"{', '.join(op.held)} — "
            + ("every other thread needing the lock convoys "
               "behind (or deadlocks on) this operation"
               if op.op == "blocking" else
               "user code runs inside the critical section: "
               "re-entrancy deadlocks and arbitrary lock-order "
               "edges (the sink-re-entrancy class)"),
            program=_PROGRAM,
            where=_where(op.module, op.lineno, op.func),
            path="+".join(op.held)))
    return out


def _check_shared_writes(model, allow) -> List[Finding]:
    out = []
    # Grouping: writes through non-self receivers (`handle.state`)
    # cannot be typed statically, so they merge with EVERY write of
    # the same attr in the module — the aliasing that catches
    # `close()` writing what `_worker_lost` guards.  When an attr
    # has ONLY self-writes, each class is its own shared variable:
    # two classes with a private, own-lock-guarded `.state` must not
    # be judged as one.
    by_attr = collections.defaultdict(list)
    for w in model.writes:
        if w.in_init or w.attr.startswith("__"):
            continue
        by_attr[(w.module, w.attr)].append(w)
    groups = {}
    for (module, attr), sites in by_attr.items():
        if any(w.owner_cls is None for w in sites):
            groups[(module, attr, None)] = sites
        else:
            for w in sites:
                groups.setdefault(
                    (module, attr, w.owner_cls), []).append(w)
    for (module, attr, _owner), sites in sorted(groups.items()):
        roots = set()
        for w in sites:
            roots |= model.func_roots.get(
                w.func_key, frozenset({MAIN_ROOT}))
        if len(roots) < 2:
            continue
        common = None
        for w in sites:
            held = set(w.held)
            common = held if common is None else (common & held)
        if common:
            continue
        anchor = next((w for w in sites if not w.held), sites[0])
        if allow.suppress("unlocked-shared-write", anchor.module,
                          anchor.lineno):
            continue
        where_all = ", ".join(
            f"{w.func}:{w.lineno}" for w in sites[:6])
        out.append(Finding(
            "unlocked-shared-write", WARNING,
            f"attribute .{attr} is written from "
            f"{len(roots)} thread roots "
            f"({', '.join(sorted(roots))}) with no common lock "
            f"across its write sites [{where_all}]",
            program=_PROGRAM,
            where=_where(anchor.module, anchor.lineno,
                         anchor.func),
            path=attr))
    return out


def _check_spawns(model, allow) -> List[Finding]:
    out = []
    for s in model.spawns:
        if s.kind != "thread" or s.has_name:
            continue
        if allow.suppress("thread-unnamed", s.module, s.lineno):
            continue
        out.append(Finding(
            "thread-unnamed", WARNING,
            "threading.Thread spawned without name= — lockdep "
            "reports, trace waterfalls and stuck-run dumps "
            "will say Thread-7 instead of what it does"
            + (f" (target {s.target})" if s.target else ""),
            program=_PROGRAM,
            where=_where(s.module, s.lineno, s.func)))
    return out


def _check_names(model, allow) -> List[Finding]:
    out = []
    for name, ld in sorted(model.locks.items()):
        if ld.declared_name is None or ld.declared_name == name:
            continue
        if allow.suppress("lockdep-name", ld.module, ld.lineno):
            continue
        out.append(Finding(
            "lockdep-name", ERROR,
            f"lockdep factory name {ld.declared_name!r} disagrees "
            f"with the AST-derived canonical name {name!r} — the "
            "runtime shadow and the static graph would stop "
            "cross-checking the same lock",
            program=_PROGRAM,
            where=_where(ld.module, ld.lineno)))
    return out


_CHECK_FNS = {
    "lock-order-cycle": _check_cycles,
    "cond-wait-no-while": _check_waits,
    "notify-outside-lock": _check_notifies,
    "blocking-under-lock": _check_ops,
    "callback-under-lock": _check_ops,
    "unlocked-shared-write": _check_shared_writes,
    "thread-unnamed": _check_spawns,
    "lockdep-name": _check_names,
}


def analyze_concurrency(root: Optional[str] = None,
                        checks=None,
                        model: Optional[ConcurrencyModel] = None
                        ) -> List[Finding]:
    """Run the concurrency checks over the package (or any source
    tree rooted at ``root``) and return the surviving findings —
    allowlisted sites are suppressed, and the allowlist itself is
    verified (unknown check, empty justification, stale entry)."""
    if model is None:
        model = scan_package(root)
    allow = _Allowlist(model)
    selected = list(checks) if checks is not None \
        else [c for c in THREAD_CHECK_IDS
              if c not in ("allowlist", "runtime-coverage")]
    findings: List[Finding] = []
    ran = set()
    for check in selected:
        fn = _CHECK_FNS.get(check)
        if fn is None or fn in ran:
            continue
        ran.add(fn)
        for f in fn(model, allow):
            if f.check in selected or f.check == check:
                findings.append(f)
    if checks is None or "allowlist" in checks:
        findings.extend(allow.verify())
    return findings


def lock_order_dot(root: Optional[str] = None,
                   model: Optional[ConcurrencyModel] = None) -> str:
    """The lock-order graph in Graphviz DOT (the CI artifact)."""
    if model is None:
        model = scan_package(root)
    return to_dot(model)


def crosscheck_runtime(runtime, root: Optional[str] = None,
                       model: Optional[ConcurrencyModel] = None
                       ) -> List[Finding]:
    """The static side of the both-ways lockdep cross-check.

    ``runtime`` is a path (one lockdep dump file, or a directory of
    ``lockdep-*.json`` dumps from a fleet run).  Every runtime
    acquisition edge must appear in the static graph — derived or
    declared — or it is a **static coverage hole** (the analyzer
    missed an ordering real execution produced); every violation the
    runtime shadow recorded (order cycle, self-deadlock, long hold)
    is surfaced as a finding naming both stacks.
    """
    from .. import _lockdep as lockdep

    if model is None:
        model = scan_package(root)
    edges, violations, loaded = lockdep.load_edge_dumps(runtime)
    findings = []
    if not loaded:
        # A gate that silently passes when the evidence is missing
        # is no gate: a crashed (or mis-pathed) MGT_LOCKDEP run must
        # fail the cross-check, not launder it.
        return [Finding(
            "runtime-coverage", ERROR,
            f"no lockdep dumps found at {runtime!r} — the runtime "
            "side of the cross-check produced no evidence (did the "
            "MGT_LOCKDEP=1 run crash, or does MGT_LOCKDEP_DUMP "
            "point somewhere else?)", program=_PROGRAM)]
    for hole in lockdep.crosscheck(model.edge_pairs(),
                                   model.wildcard_sources(),
                                   runtime_edges=edges):
        src, dst = hole["edge"]
        findings.append(Finding(
            "runtime-coverage", ERROR,
            f"runtime acquisition edge {src} -> {dst} is absent "
            "from the static lock graph — a static coverage hole; "
            "add the ordering (or a may_precede declaration at the "
            "lock's factory) so the analyzer sees what execution "
            "does",
            program=_PROGRAM, path=f"{src}->{dst}"))
    for v in violations:
        detail = {k: v[k] for k in ("lock", "edge", "cycle",
                                    "held_s", "thread")
                  if k in v}
        msg = (f"lockdep runtime violation {v.get('kind')}: "
               f"{detail}")
        stacks = [v[k] for k in ("stack", "other_stack")
                  if v.get(k)]
        if stacks:
            msg += "\n" + "\n--- other stack ---\n".join(
                s.rstrip() for s in stacks)
        findings.append(Finding(
            "runtime-coverage", ERROR, msg, program=_PROGRAM,
            path=str(v.get("kind"))))
    return findings
