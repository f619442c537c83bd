"""Settlement lint: prove every future settles, in the right order.

The serve layer's correctness rests on a handful of *settlement
obligations*: a :class:`~multigrad_tpu_torch.serve.queue.FitFuture`,
:class:`~multigrad_tpu_torch.serve.jobs.JobFuture` or
:class:`~multigrad_tpu_torch.serve.fleet.FleetRequest` claim, once created,
MUST reach a discharge call (``_set_result`` / ``_set_exception`` /
``_stage_settled`` / shed / cancel / requeue) on *every* path out of
the owning scope — including exception edges and thread-body exits —
and the discharge must follow the conventions the serve layer's fixes
kept restoring by hand:

* **Backstops** — a thread whose body (or call graph) settles futures
  must wrap itself in a broad ``except`` backstop: a dispatcher,
  reader, monitor or stage worker dying silently strands every
  obligation it held (the unrecorded-stage-death bug class).
* **Root-before-resolve** — trace roots and dispatch counters are
  recorded BEFORE the future resolves: a caller waking on
  ``result()`` must see a fully-accounted request (a bug
  class re-fixed three times).
* **Settle-outside-lock** — resolving a future runs caller callbacks
  and wakes waiters; doing so under the owning lock is a lock-order
  hazard and a latency cliff.
* **First-wins** — future classes guard ``_set_result`` /
  ``_set_exception`` so a late duplicate (a requeued request
  completing twice) cannot clobber the delivered result; and no code
  path settles the same future twice unconditionally.

Like :mod:`.lockgraph` / :mod:`.concurrency` (whose thread-root
propagation this pass reuses to follow obligations handed across
threads), everything here is a pure-``ast`` pass — the scanned code
is parsed, never imported.

Deliberate exceptions are allowlisted IN the code::

    fut._set_exception(err)   # settle-ok: <check-id> <why it is safe>

and the allowlist itself is verified: unknown check ids and empty
justifications are errors, stale entries are warnings.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .findings import ERROR, WARNING, Finding
from .lockgraph import MAIN_ROOT, ConcurrencyModel, scan_package

__all__ = ["SETTLE_CHECK_IDS", "SettlementModel", "scan_settlement",
           "analyze_settlement"]

#: Registry of settlement check ids (the ``--checks`` vocabulary of
#: the ``settlement`` lint target).
SETTLE_CHECK_IDS = (
    "settle-orphan",
    "settle-no-backstop",
    "settle-root-after-resolve",
    "settle-under-lock",
    "settle-double",
    "settle-first-wins",
    "settle-allowlist",
)

_PROGRAM = "settlement"

#: Discharge calls: resolving an obligation (``_stage_settled`` is
#: the per-stage incremental settle of a :class:`JobFuture`).
RESOLVE_ATTRS = frozenset({"_set_result", "_set_exception",
                           "_stage_settled"})
#: Terminal resolves only — the pair the first-wins / double-settle
#: invariants are about.
TERMINAL_ATTRS = frozenset({"_set_result", "_set_exception"})
#: Accounting that must land BEFORE a resolve (root-before-resolve):
#: trace roots, dispatch counters, latency/SLO observations.  NOT in
#: this set: ``telemetry.log`` summaries and gauge refreshes, which
#: legitimately trail the resolve (they are streams, not the state a
#: woken caller reads).
ACCOUNTING_ATTRS = frozenset({"_trace_root", "_count", "_count_locked",
                              "_fits_counter", "_count_job",
                              "_count_stage", "record_shed",
                              "_observe_latency", "observe"})

_ALLOW_RE = re.compile(r"#\s*settle-ok:\s*([a-z0-9-]+)\s*(.*)$")


# ---------------------------------------------------------------------- #
# model
# ---------------------------------------------------------------------- #
@dataclass
class ResolveSite:
    """One discharge call (``<base>.<attr>(...)``)."""

    module: str
    func: str                 # simple name, for messages
    fkey: str                 # lockgraph-style "module[.Class].name"
    lineno: int
    base: str                 # dotted receiver ("req.future", "fut")
    attr: str
    held: Tuple[str, ...]     # lock-ish `with` contexts held here


@dataclass
class CreateSite:
    """An obligation minted: ``name = SomethingFuture(...)``."""

    module: str
    func: str
    fkey: str
    lineno: int
    var: str
    factory: str
    used: bool = False        # referenced after creation (handed off)


@dataclass
class OrderViol:
    """Accounting recorded after the future already resolved."""

    module: str
    func: str
    lineno: int               # the late accounting call
    acct: str
    resolve_lineno: int
    resolve_base: str


@dataclass
class DoubleSettle:
    """Two unconditional terminal resolves of one base on one path."""

    module: str
    func: str
    lineno: int
    base: str
    first_lineno: int


@dataclass
class FutureMethod:
    """A future class's ``_set_result`` / ``_set_exception``."""

    module: str
    cls: str
    name: str
    lineno: int
    guarded: bool             # has a first-wins early-exit


@dataclass
class FuncFacts:
    """Per-function settlement facts (keyed like lockgraph)."""

    fkey: str
    module: str
    simple: str
    lineno: int
    broad_handler: bool = False   # any except Exception/BaseException
    resolves: int = 0


@dataclass
class AllowEntry:
    module: str
    lineno: int
    check: str
    reason: str
    used: bool = False


@dataclass
class SettlementModel:
    """Everything :func:`analyze_settlement`'s checks consume."""

    resolves: List[ResolveSite] = field(default_factory=list)
    creations: List[CreateSite] = field(default_factory=list)
    order_viols: List[OrderViol] = field(default_factory=list)
    doubles: List[DoubleSettle] = field(default_factory=list)
    future_methods: List[FutureMethod] = field(default_factory=list)
    funcs: Dict[str, FuncFacts] = field(default_factory=dict)
    allows: List[AllowEntry] = field(default_factory=list)
    #: The concurrency model: spawn sites + thread-root
    #: fixpoint (``func_roots``) — how obligations handed across
    #: threads are followed.
    lock_model: Optional[ConcurrencyModel] = None


def _dotted(node) -> str:
    """Best-effort dotted rendering of an expression."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return f"{_dotted(node.func)}()"
    if isinstance(node, ast.Subscript):
        return f"{_dotted(node.value)}[...]"
    return node.__class__.__name__.lower()


def _lockish(expr) -> Optional[str]:
    """Dotted name when a ``with`` context looks like a lock."""
    base = expr
    if isinstance(base, ast.Call):      # with self._lock: vs lock()
        base = base.func
    name = _dotted(base)
    last = name.rsplit(".", 1)[-1].lower()
    if "lock" in last or "cond" in last or "mutex" in last:
        return name
    return None


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [_dotted(e) for e in t.elts]
    else:
        names = [_dotted(t)]
    return any(n.rsplit(".", 1)[-1] in ("Exception", "BaseException")
               for n in names)


def _walk_no_fn(node):
    """ast.walk that does not descend into nested function/class
    definitions (their bodies are scanned as functions of their
    own)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------- #
# scanner
# ---------------------------------------------------------------------- #
class _ModScanner:
    def __init__(self, module: str, tree: ast.Module, source: str,
                 model: SettlementModel):
        self.module = module
        self.tree = tree
        self.model = model
        for i, line in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(line)
            if m:
                model.allows.append(AllowEntry(
                    module, i, m.group(1), m.group(2).strip()))

    def fkey(self, cls: Optional[str], name: str) -> str:
        return ".".join(x for x in (self.module, cls, name) if x)

    def scan(self):
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self._scan_fn(node, cls=None)
            elif isinstance(node, ast.ClassDef):
                self._scan_class(node)

    def _scan_class(self, cls: ast.ClassDef):
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        # A "future class": defines BOTH terminal settle methods —
        # each must carry a first-wins early-exit guard.
        if TERMINAL_ATTRS <= set(methods):
            for name in sorted(TERMINAL_ATTRS):
                fn = methods[name]
                guarded = any(
                    isinstance(n, ast.If)
                    and any(isinstance(s, (ast.Return, ast.Raise))
                            for s in n.body)
                    for n in _walk_no_fn(fn))
                self.model.future_methods.append(FutureMethod(
                    self.module, cls.name, name, fn.lineno, guarded))
        for fn in methods.values():
            self._scan_fn(fn, cls=cls.name)

    def _scan_fn(self, fn, cls: Optional[str]):
        key = self.fkey(cls, fn.name)
        facts = FuncFacts(fkey=key, module=self.module,
                          simple=fn.name, lineno=fn.lineno)
        self.model.funcs[key] = facts
        _FnWalker(self, fn, cls, facts).run()
        # Nested defs (worker.main's closures) are functions of
        # their own — same keying as lockgraph, so the thread-root
        # fixpoint lines up.
        for node in fn.body:
            self._walk_nested(node, cls)

    def _walk_nested(self, node, cls):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scan_fn(node, cls=cls)
            return
        for child in ast.iter_child_nodes(node):
            self._walk_nested(child, cls)


class _FnWalker:
    """Statement-ordered walk of ONE function body: resolve sites
    with their held locks, unconditional resolve→accounting ordering,
    unconditional double settles, obligation creations, and broad
    exception backstops."""

    def __init__(self, sc: _ModScanner, fn, cls: Optional[str],
                 facts: FuncFacts):
        self.sc = sc
        self.fn = fn
        self.cls = cls
        self.facts = facts
        self.creations: List[CreateSite] = []

    def run(self):
        self._suite(self.fn.body, held=())
        # Orphans: a minted future never referenced again in this
        # function was neither discharged nor handed off.
        names = [n.id for n in _walk_no_fn(self.fn)
                 if isinstance(n, ast.Name)]
        for c in self.creations:
            c.used = names.count(c.var) > 1
            self.sc.model.creations.append(c)

    # -- statements ----------------------------------------------------- #
    def _suite(self, stmts, held) -> List[ResolveSite]:
        """Walk one suite; returns the resolves that execute
        UNCONDITIONALLY in it (With bodies are transparent;
        If/For/While/Try bodies are not — their resolves are
        conditional from the suite's point of view)."""
        settled: List[ResolveSite] = []
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if settled:
                self._late_accounting(stmt, settled)
            if isinstance(stmt, ast.Try):
                for h in stmt.handlers:
                    if _is_broad_handler(h):
                        self.facts.broad_handler = True
                    self._suite(h.body, held)
                self._suite(stmt.body, held)
                self._suite(stmt.orelse, held)
                settled.extend(self._suite(stmt.finalbody, held))
            elif isinstance(stmt, (ast.If, ast.For, ast.While)):
                self._suite(stmt.body, held)
                self._suite(stmt.orelse, held)
            elif isinstance(stmt, ast.With):
                locks = tuple(x for x in
                              (_lockish(i.context_expr)
                               for i in stmt.items) if x)
                settled.extend(
                    self._suite(stmt.body, held + locks))
            else:
                settled.extend(self._plain(stmt, held, settled))
        return settled

    def _plain(self, stmt, held, settled) -> List[ResolveSite]:
        out: List[ResolveSite] = []
        for node in _walk_no_fn(stmt):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in RESOLVE_ATTRS:
                site = ResolveSite(
                    module=self.sc.module, func=self.fn.name,
                    fkey=self.facts.fkey, lineno=node.lineno,
                    base=_dotted(f.value), attr=f.attr, held=held)
                self.sc.model.resolves.append(site)
                self.facts.resolves += 1
                if f.attr in TERMINAL_ATTRS:
                    for prev in settled + out:
                        if prev.base == site.base \
                                and prev.attr in TERMINAL_ATTRS:
                            self.sc.model.doubles.append(DoubleSettle(
                                self.sc.module, self.fn.name,
                                node.lineno, site.base,
                                prev.lineno))
                            break
                out.append(site)
            elif isinstance(f, (ast.Name, ast.Attribute)):
                name = f.id if isinstance(f, ast.Name) else f.attr
                if name.endswith("Future") \
                        and isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.value is node:
                    self.creations.append(CreateSite(
                        module=self.sc.module, func=self.fn.name,
                        fkey=self.facts.fkey, lineno=node.lineno,
                        var=stmt.targets[0].id, factory=name))
        return out

    def _late_accounting(self, stmt, settled: List[ResolveSite]):
        for node in _walk_no_fn(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ACCOUNTING_ATTRS:
                first = settled[0]
                self.sc.model.order_viols.append(OrderViol(
                    module=self.sc.module, func=self.fn.name,
                    lineno=node.lineno, acct=node.func.attr,
                    resolve_lineno=first.lineno,
                    resolve_base=first.base))


def scan_settlement(root: Optional[str] = None) -> SettlementModel:
    """Scan a package tree (default: ``multigrad_tpu_torch``'s own) into a
    :class:`SettlementModel`.  Also runs :func:`~multigrad_tpu_torch
    .analysis.lockgraph.scan_package` over the same tree — the
    thread-root fixpoint is how resolves are attributed to the
    threads that run them."""
    import os
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    model = SettlementModel()
    model.lock_model = scan_package(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d != "__pycache__"]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            module = rel[:-3].replace(os.sep, ".")
            if module.endswith(".__init__"):
                module = module[:-len(".__init__")]
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
            _ModScanner(module, tree, source, model).scan()
    return model


# ---------------------------------------------------------------------- #
# allowlist
# ---------------------------------------------------------------------- #
class _Allowlist:
    """In-code ``# settle-ok: <check> <why>`` suppressions, indexed
    by (module, lineno) AND (module, lineno+1) so an annotation on
    the line above its anchor counts too."""

    def __init__(self, entries: List[AllowEntry]):
        self.entries = entries
        self.index: Dict[Tuple[str, int, str], AllowEntry] = {}
        for e in entries:
            self.index[(e.module, e.lineno, e.check)] = e
            self.index.setdefault(
                (e.module, e.lineno + 1, e.check), e)

    def suppress(self, module: str, lineno: int, check: str) -> bool:
        e = self.index.get((module, lineno, check))
        if e is not None and e.reason:
            e.used = True
            return True
        return False

    def verify(self) -> List[Finding]:
        out = []
        for e in self.entries:
            where = _where(e.module, e.lineno)
            if e.check not in SETTLE_CHECK_IDS:
                out.append(Finding(
                    "settle-allowlist", ERROR,
                    f"settle-ok names unknown check {e.check!r} "
                    f"(known: {', '.join(SETTLE_CHECK_IDS)})",
                    program=_PROGRAM, where=where))
            elif not e.reason:
                out.append(Finding(
                    "settle-allowlist", ERROR,
                    f"settle-ok for {e.check!r} has no "
                    "justification — the allowlist contract is an "
                    "explained exception, not a mute button",
                    program=_PROGRAM, where=where))
            elif not e.used:
                out.append(Finding(
                    "settle-allowlist", WARNING,
                    f"stale settle-ok: no {e.check!r} finding is "
                    "anchored here anymore — remove the annotation",
                    program=_PROGRAM, where=where))
        return out


def _where(module: str, lineno: int, func: str = "") -> str:
    path = module.replace(".", "/") + ".py"
    return f"{path}:{lineno} ({func})" if func \
        else f"{path}:{lineno}"


# ---------------------------------------------------------------------- #
# checks
# ---------------------------------------------------------------------- #
def _check_orphan(model: SettlementModel,
                  allow: _Allowlist) -> List[Finding]:
    out = []
    for c in model.creations:
        if c.used:
            continue
        if allow.suppress(c.module, c.lineno, "settle-orphan"):
            continue
        out.append(Finding(
            "settle-orphan", ERROR,
            f"{c.factory}() creates an obligation in {c.var!r} that "
            "is never discharged or handed off — every path out of "
            "the owning scope must reach _set_result/_set_exception "
            "or pass the future on",
            program=_PROGRAM,
            where=_where(c.module, c.lineno, c.func)))
    return out


def _check_no_backstop(model: SettlementModel,
                       allow: _Allowlist) -> List[Finding]:
    """A thread root from whose call graph futures are settled must
    carry a broad exception backstop: the thread dying silently
    strands every obligation it held (the stage-death shape).
    Thread attribution is the lock graph's root fixpoint — obligations
    handed across threads are followed, not just direct resolves."""
    lock_model = model.lock_model
    if lock_model is None:
        return []
    func_roots = lock_model.func_roots
    # Roots under which some scanned function discharges.
    settling_roots = set()
    for fkey, facts in model.funcs.items():
        if facts.resolves:
            settling_roots |= set(
                func_roots.get(fkey, frozenset()))
    settling_roots.discard(MAIN_ROOT)
    out = []
    for fkey in sorted(settling_roots):
        facts = model.funcs.get(fkey)
        if facts is None or facts.broad_handler:
            continue
        # Only flag actual thread roots (a function is its own root
        # exactly when something spawns it).
        if fkey not in func_roots.get(fkey, frozenset()):
            continue
        if allow.suppress(facts.module, facts.lineno,
                          "settle-no-backstop"):
            continue
        out.append(Finding(
            "settle-no-backstop", ERROR,
            f"thread body {facts.simple!r} settles futures (itself "
            "or via its callees) but has no broad except backstop — "
            "an escaping exception kills the thread and strands "
            "every obligation it held; wrap the body in "
            "try/except (Base)Exception that discharges or requeues",
            program=_PROGRAM,
            where=_where(facts.module, facts.lineno, facts.simple)))
    return out


def _check_root_after_resolve(model: SettlementModel,
                              allow: _Allowlist) -> List[Finding]:
    out = []
    for v in model.order_viols:
        if allow.suppress(v.module, v.lineno,
                          "settle-root-after-resolve"):
            continue
        out.append(Finding(
            "settle-root-after-resolve", ERROR,
            f"{v.acct}(...) runs after {v.resolve_base} already "
            f"resolved (line {v.resolve_lineno}) — trace roots and "
            "dispatch counters must land BEFORE the resolve, so a "
            "caller waking on result() sees a fully-accounted "
            "request",
            program=_PROGRAM,
            where=_where(v.module, v.lineno, v.func)))
    return out


def _check_under_lock(model: SettlementModel,
                      allow: _Allowlist) -> List[Finding]:
    out = []
    for s in model.resolves:
        if not s.held:
            continue
        if allow.suppress(s.module, s.lineno, "settle-under-lock"):
            continue
        out.append(Finding(
            "settle-under-lock", ERROR,
            f"{s.base}.{s.attr}(...) runs while holding "
            f"{', '.join(s.held)} — settling wakes waiters and runs "
            "caller callbacks; move the resolve outside the owning "
            "lock (collect under the lock, settle after)",
            program=_PROGRAM,
            where=_where(s.module, s.lineno, s.func)))
    return out


def _check_double(model: SettlementModel,
                  allow: _Allowlist) -> List[Finding]:
    out = []
    for d in model.doubles:
        if allow.suppress(d.module, d.lineno, "settle-double"):
            continue
        out.append(Finding(
            "settle-double", ERROR,
            f"{d.base} is settled twice unconditionally on the same "
            f"path (first at line {d.first_lineno}) — settlement is "
            "first-wins; the second resolve is dead at best and a "
            "clobbered result at worst",
            program=_PROGRAM,
            where=_where(d.module, d.lineno, d.func)))
    return out


def _check_first_wins(model: SettlementModel,
                      allow: _Allowlist) -> List[Finding]:
    out = []
    for m in model.future_methods:
        if m.guarded:
            continue
        if allow.suppress(m.module, m.lineno, "settle-first-wins"):
            continue
        out.append(Finding(
            "settle-first-wins", ERROR,
            f"{m.cls}.{m.name} has no first-wins guard — a late "
            "duplicate settle (a requeued request completing twice) "
            "clobbers the already-delivered outcome; early-return "
            "when the future is already settled",
            program=_PROGRAM,
            where=_where(m.module, m.lineno,
                         f"{m.cls}.{m.name}")))
    return out


_CHECK_FNS = {
    "settle-orphan": _check_orphan,
    "settle-no-backstop": _check_no_backstop,
    "settle-root-after-resolve": _check_root_after_resolve,
    "settle-under-lock": _check_under_lock,
    "settle-double": _check_double,
    "settle-first-wins": _check_first_wins,
}


def analyze_settlement(root: Optional[str] = None,
                       checks=None,
                       model: Optional[SettlementModel] = None
                       ) -> List[Finding]:
    """Run the settlement checks; a clean tree is the empty list.

    ``checks`` subsets :data:`SETTLE_CHECK_IDS`; by default every
    check runs and the allowlist is verified.  Pass a prebuilt
    ``model`` (from :func:`scan_settlement`) to amortize the scan.
    """
    if model is None:
        model = scan_settlement(root)
    allow = _Allowlist(model.allows)
    selected = list(_CHECK_FNS) if checks is None \
        else [c for c in checks if c in _CHECK_FNS]
    findings: List[Finding] = []
    for check in _CHECK_FNS:
        if check not in selected:
            continue
        findings.extend(_CHECK_FNS[check](model, allow))
    if checks is None or "settle-allowlist" in checks:
        findings.extend(allow.verify())
    return findings
