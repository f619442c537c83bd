"""AST inventory of the package's concurrency surface.

The serve/fleet layer is ~4k LoC of hand-threaded code (dispatcher
threads, heartbeat monitors, condition-variable queues, RPC writers)
whose invariants — lock acquisition order, condition-wait predicates,
what may run while a lock is held — were previously enforced by
eye.  This module makes them machine-readable: a pure
``ast`` walk over the package (zero imports of the scanned code, so
it runs in CI without a device or even torch) that inventories

* every lock/rlock/condition/event/semaphore **definition** —
  ``threading.*`` constructors and the :mod:`multigrad_tpu_torch.utils
  .lockdep` factories alike — under a **canonical name**
  (``"serve.queue.FitQueue._lock"``) shared with the runtime shadow;
* every **thread spawn site** (``threading.Thread``/``Timer``) and
  its ``name=`` hygiene;
* the **lock-acquisition-order graph**: acquiring B inside a ``with
  A:`` (or between ``A.acquire()``/``A.release()``) adds the edge
  ``A → B``, following one level of intra-module calls, plus the
  ``may_precede=`` edges declared at :func:`~multigrad_tpu_torch.utils
  .lockdep.make_lock` call sites for orderings the AST cannot derive
  (dynamic sink/callback dispatch);
* per-site facts the checks in :mod:`.concurrency` consume:
  condition ``wait()`` sites and their enclosing-``while`` status,
  ``notify`` sites and the locks held there, blocking/callback calls
  under locks, attribute writes with the held-lock set and the
  thread root(s) that can reach them.

Thread roots are propagated over the intra-module call graph to a
fixpoint: a function is attributed to every spawn target that
reaches it (and to ``<main>`` when reachable from non-thread code),
so "written from two different threads" is decidable per write site.

Conditions created over a sibling lock (``threading.Condition(
self._lock)``) resolve to the *underlying* mutex, so ``with
self._not_empty:`` correctly counts as holding ``._lock``.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["LockDef", "SpawnSite", "EdgeSite", "OpSite", "WaitSite",
           "NotifySite", "WriteSite", "AllowEntry",
           "ConcurrencyModel", "scan_package", "find_cycles",
           "to_dot", "MAIN_ROOT"]

MAIN_ROOT = "<main>"

#: ``threading`` constructors we inventory, by kind.
THREADING_KINDS = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "Event": "event", "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore",
}
#: lockdep factory names, by kind.
FACTORY_KINDS = {
    "make_lock": "lock", "make_rlock": "rlock",
    "make_condition": "condition",
}
#: Held-lock tracking applies to these kinds only (events and
#: semaphores are signalling primitives, not mutual exclusion).
HELD_KINDS = ("lock", "rlock", "condition")

#: Method/function names whose *call* blocks the calling thread
#: (sockets, subprocesses, device dispatch, sleeps).  ``Condition
#: .wait`` is deliberately absent — it releases the lock.
BLOCKING_ATTRS = {
    "sendall", "recv", "recv_into", "accept", "connect",
    "communicate", "sleep", "block_until_ready", "readline",
    "create_connection", "getaddrinfo", "urlopen", "select",
}
#: Receiver-name fragments that make a ``.wait()``/``.join()`` call
#: count as blocking (process handles, thread handles) — conditions
#: are excluded by kind, events by their inventory entry.
BLOCKING_WAIT_RECV = ("proc", "thread", "process")
#: Attribute names that identify a user-callback invocation.
CALLBACK_NAMES = {"callback", "action"}

_ALLOW_RE = re.compile(r"#\s*lock-ok:\s*([a-z0-9-]+)\s*(.*)$")


@dataclass(frozen=True)
class LockDef:
    name: str                    # canonical, e.g. serve.queue.FitQueue._lock
    kind: str                    # lock / rlock / condition / event / semaphore
    module: str
    lineno: int
    shares: Optional[str] = None         # condition -> underlying lock name
    declared_name: Optional[str] = None  # factory literal, if any
    may_precede: Tuple[str, ...] = ()    # declared edges ("*" allowed)


@dataclass(frozen=True)
class SpawnSite:
    module: str
    func: str
    lineno: int
    kind: str                    # thread / timer
    target: Optional[str] = None
    has_name: bool = False
    cls: Optional[str] = None    # class of the spawning function


@dataclass(frozen=True)
class EdgeSite:
    src: str
    dst: str
    module: str
    func: str
    lineno: int
    via: Optional[str] = None    # callee name for one-level edges
    declared: bool = False


@dataclass(frozen=True)
class OpSite:
    """A blocking or callback call made while holding locks."""
    op: str                      # "blocking" / "callback"
    desc: str
    module: str
    func: str
    lineno: int
    held: Tuple[str, ...]
    via: Optional[str] = None


@dataclass(frozen=True)
class WaitSite:
    cond: str
    module: str
    func: str
    lineno: int
    in_while: bool


@dataclass(frozen=True)
class NotifySite:
    cond: str
    owner: str
    module: str
    func: str
    lineno: int
    held: Tuple[str, ...]
    cls: Optional[str] = None    # class of the notifying function


@dataclass(frozen=True)
class WriteSite:
    module: str
    attr: str
    func: str
    lineno: int
    held: Tuple[str, ...]
    in_init: bool
    receiver: str = "self"
    # class of the written object for `self.attr = ...` writes
    # (None for writes through other receivers, whose type is
    # unknown statically), and the thread-root lookup key of the
    # function containing the write.
    owner_cls: Optional[str] = None
    func_key: str = ""


@dataclass
class AllowEntry:
    module: str
    lineno: int
    check: str
    reason: str
    used: bool = False


@dataclass
class _FuncInfo:
    key: str                               # mod.[Class.]name
    module: str
    simple: str
    cls: Optional[str] = None
    acquired: set = field(default_factory=set)
    # (caller_cls_ctx, callee_name, is_self_call, held, lineno) —
    # resolved to _FuncInfo keys after the whole module is scanned
    calls: list = field(default_factory=list)
    blocking: list = field(default_factory=list)   # OpSite
    notifies: list = field(default_factory=list)


@dataclass
class ConcurrencyModel:
    locks: Dict[str, LockDef] = field(default_factory=dict)
    spawns: List[SpawnSite] = field(default_factory=list)
    edges: List[EdgeSite] = field(default_factory=list)
    ops: List[OpSite] = field(default_factory=list)
    waits: List[WaitSite] = field(default_factory=list)
    notifies: List[NotifySite] = field(default_factory=list)
    writes: List[WriteSite] = field(default_factory=list)
    allows: List[AllowEntry] = field(default_factory=list)
    func_roots: Dict[str, frozenset] = field(default_factory=dict)
    # every RESOLVED intra-module call site:
    # (module, callee_cls, callee_name, held, lineno) — the
    # notify-outside-lock check's caller-context evidence
    calls: List[tuple] = field(default_factory=list)

    def edge_pairs(self) -> set:
        """Every (src, dst) pair of the graph — derived AND declared
        (wildcards excluded; see :meth:`wildcard_sources`)."""
        return {(e.src, e.dst) for e in self.edges if e.dst != "*"}

    def wildcard_sources(self) -> set:
        """Locks declared ``may_precede="*"``."""
        return {e.src for e in self.edges if e.dst == "*"}


# ------------------------------------------------------------------ #
# per-module scanning
# ------------------------------------------------------------------ #
def _dotted(node) -> str:
    """Best-effort dotted rendering of an expression (for messages
    and receiver heuristics)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return f"{_dotted(node.func)}()"
    return node.__class__.__name__.lower()


def _lock_ctor_kind(call: ast.Call) -> Optional[Tuple[str, bool]]:
    """``(kind, is_factory)`` when ``call`` constructs a lock-like
    object (``threading.X(...)``, bare ``X(...)`` from a
    ``from threading import X``, or a lockdep factory), else None."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if (isinstance(fn.value, ast.Name)
                and fn.value.id == "threading"
                and fn.attr in THREADING_KINDS):
            return THREADING_KINDS[fn.attr], False
        if fn.attr in FACTORY_KINDS:      # lockdep.make_lock(...)
            return FACTORY_KINDS[fn.attr], True
    if isinstance(fn, ast.Name):
        if fn.id in FACTORY_KINDS:
            return FACTORY_KINDS[fn.id], True
        if fn.id in THREADING_KINDS:
            return THREADING_KINDS[fn.id], False
    return None


def _unwrap_factory(call: ast.Call):
    """``(kind, is_factory, call)`` for a lock constructor, looking
    through ``field(default_factory=...)`` and zero-arg lambdas (the
    dataclass-field idiom)."""
    res = _lock_ctor_kind(call)
    if res is not None:
        return res[0], res[1], call
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id == "field":
        for kw in call.keywords:
            if kw.arg != "default_factory":
                continue
            v = kw.value
            if isinstance(v, ast.Lambda) \
                    and isinstance(v.body, ast.Call):
                inner = _lock_ctor_kind(v.body)
                if inner is not None:
                    return inner[0], inner[1], v.body
            if isinstance(v, (ast.Name, ast.Attribute)):
                name = v.attr if isinstance(v, ast.Attribute) \
                    else v.id
                if name in THREADING_KINDS:
                    return THREADING_KINDS[name], False, call
    return None


def _str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _ModuleScanner:
    def __init__(self, module: str, tree: ast.Module, source: str,
                 model: ConcurrencyModel):
        self.module = module
        self.tree = tree
        self.model = model
        # (scope_key, symbol) -> LockDef; scope_key "" = module,
        # class name for self-attrs, function key for locals.
        self.symbols: Dict[Tuple[str, str], LockDef] = {}
        # (cls_or_None, simple_name) -> _FuncInfo.  Class-qualified
        # so two classes' same-named methods never merge (a merged
        # `close` would attribute one class's acquisitions to the
        # other's call sites — phantom lock-order edges).
        self.funcs: Dict[Tuple[Optional[str], str], _FuncInfo] = {}
        self._parse_allows(source)

    def fkey(self, cls: Optional[str], name: str) -> str:
        return ".".join(x for x in (self.module, cls, name) if x)

    def resolve_callee(self, cls_ctx: Optional[str], name: str,
                       is_self: bool) -> Optional[_FuncInfo]:
        """A call's target _FuncInfo: `self.m()` resolves within the
        calling class only; a bare `f()` prefers a same-class nested
        function, then a module-level one."""
        if is_self:
            return self.funcs.get((cls_ctx, name))
        return (self.funcs.get((cls_ctx, name))
                or self.funcs.get((None, name)))

    def _parse_allows(self, source: str):
        for i, line in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(line)
            if m:
                self.model.allows.append(AllowEntry(
                    self.module, i, m.group(1),
                    m.group(2).strip()))

    # -- pass 1: lock definitions -------------------------------------- #
    def collect_defs(self):
        self._collect_scope(self.tree.body, scope="", owner="")
        for cls in [n for n in ast.walk(self.tree)
                    if isinstance(n, ast.ClassDef)]:
            # class-body fields (dataclass default_factory idiom)
            self._collect_scope(cls.body, scope=cls.name,
                                owner=cls.name, class_body=True)
            for fn in [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]:
                self._collect_fn_defs(fn, cls.name)
        for fn in [n for n in self.tree.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]:
            self._collect_fn_defs(fn, None)

    def _collect_fn_defs(self, fn, cls: Optional[str]):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                for tgt in node.targets:
                    self._maybe_def(tgt, node.value, fn, cls)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    and node is not fn:
                pass      # nested fns re-walked via module walk

    def _collect_scope(self, body, scope: str, owner: str,
                       class_body: bool = False):
        for node in body:
            value = None
            targets = []
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.value, ast.Call):
                value, targets = node.value, [node.target]
            if value is None:
                continue
            info = _unwrap_factory(value)
            if info is None:
                continue
            kind, is_factory, call = info
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    canonical = (f"{self.module}.{owner}.{tgt.id}"
                                 if class_body and owner
                                 else f"{self.module}.{tgt.id}")
                    self._register(canonical, kind, is_factory,
                                   call, node.lineno,
                                   scope_key=(owner if class_body
                                              else ""),
                                   symbol=tgt.id)

    def _maybe_def(self, tgt, call: ast.Call, fn, cls: Optional[str]):
        info = _unwrap_factory(call)
        if info is None:
            return
        kind, is_factory, call = info
        if isinstance(tgt, ast.Attribute) \
                and isinstance(tgt.value, ast.Name) \
                and tgt.value.id == "self" and cls is not None:
            canonical = f"{self.module}.{cls}.{tgt.attr}"
            self._register(canonical, kind, is_factory, call,
                           tgt.lineno, scope_key=cls,
                           symbol=tgt.attr)
        elif isinstance(tgt, ast.Name):
            canonical = f"{self.module}.{fn.name}.{tgt.id}"
            self._register(canonical, kind, is_factory, call,
                           tgt.lineno, scope_key=fn.name,
                           symbol=tgt.id)

    def _register(self, canonical: str, kind: str, is_factory: bool,
                  call: ast.Call, lineno: int, scope_key: str,
                  symbol: str):
        declared = None
        may_precede: Tuple[str, ...] = ()
        shares = None
        if is_factory:
            if call.args:
                declared = _str_const(call.args[0])
            for kw in call.keywords:
                if kw.arg == "name":
                    declared = _str_const(kw.value) or declared
                elif kw.arg == "may_precede":
                    v = kw.value
                    s = _str_const(v)
                    if s is not None:
                        may_precede = (s,)
                    elif isinstance(v, (ast.Tuple, ast.List)):
                        may_precede = tuple(
                            x for x in (_str_const(e)
                                        for e in v.elts)
                            if x is not None)
        if kind == "condition":
            lock_arg = None
            if is_factory:
                for kw in call.keywords:
                    if kw.arg == "lock":
                        lock_arg = kw.value
                if lock_arg is None and len(call.args) > 1:
                    lock_arg = call.args[1]
            elif call.args:
                lock_arg = call.args[0]
            if isinstance(lock_arg, ast.Attribute) \
                    and isinstance(lock_arg.value, ast.Name) \
                    and lock_arg.value.id == "self":
                shares = f"{self.module}.{scope_key}.{lock_arg.attr}"
        ld = LockDef(name=canonical, kind=kind, module=self.module,
                     lineno=lineno, shares=shares,
                     declared_name=declared,
                     may_precede=may_precede)
        self.model.locks[canonical] = ld
        self.symbols[(scope_key, symbol)] = ld
        for dst in may_precede:
            self.model.edges.append(EdgeSite(
                src=canonical, dst=dst, module=self.module,
                func="<declared>", lineno=lineno, declared=True))

    # -- pass 2: function bodies --------------------------------------- #
    def analyze_functions(self):
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self._analyze_fn(node, cls=None, prefix="")
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._analyze_fn(sub, cls=node.name,
                                         prefix="")

    def _analyze_fn(self, fn, cls: Optional[str], prefix: str):
        simple = fn.name
        info = self.funcs.setdefault(
            (cls, simple),
            _FuncInfo(key=self.fkey(cls, simple),
                      module=self.module, simple=simple, cls=cls))
        scopes = tuple(x for x in (fn.name, prefix) if x)
        _FuncWalker(self, fn, cls, info, scopes).run()
        for node in fn.body:
            self._walk_nested(node, fn, cls)

    def _walk_nested(self, node, outer, cls):
        """Nested function defs (worker.main's closures) become
        first-class functions under their simple name."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._analyze_fn(node, cls=cls, prefix=outer.name)
            return
        for child in ast.iter_child_nodes(node):
            self._walk_nested(child, outer, cls)

    # -- lock-expression resolution ------------------------------------ #
    def resolve_lock(self, node, cls: Optional[str],
                     scopes: Tuple[str, ...]) -> Optional[LockDef]:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and cls is not None:
            return self.symbols.get((cls, node.attr))
        if isinstance(node, ast.Name):
            for scope in (*scopes, ""):
                ld = self.symbols.get((scope, node.id))
                if ld is not None:
                    return ld
        return None

    def underlying(self, ld: LockDef) -> str:
        if ld.kind == "condition" and ld.shares \
                and ld.shares in self.model.locks:
            return ld.shares
        return ld.name


class _FuncWalker:
    """Statement-ordered walk of one function body with a held-lock
    stack; records edges, wait/notify/blocking/callback/write sites
    and intra-module call sites."""

    def __init__(self, scanner: _ModuleScanner, fn,
                 cls: Optional[str], info: _FuncInfo,
                 scopes: Tuple[str, ...] = ()):
        self.s = scanner
        self.fn = fn
        self.cls = cls
        self.info = info
        self.scopes = scopes or (fn.name,)
        self.held: List[str] = []
        self.while_depth = 0
        self.in_init = fn.name in ("__init__", "__post_init__")

    def run(self):
        for stmt in self.fn.body:
            self._stmt(stmt)

    # -- statements ---------------------------------------------------- #
    def _stmt(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return                      # separate scope
        if isinstance(node, ast.With):
            pushed = []
            for item in node.items:
                self._expr(item.context_expr)
                ld = self.s.resolve_lock(item.context_expr,
                                         self.cls, self.scopes)
                if ld is not None and ld.kind in HELD_KINDS:
                    name = self.s.underlying(ld)
                    self._acquire(name, node.lineno)
                    pushed.append(name)
            for stmt in node.body:
                self._stmt(stmt)
            for name in reversed(pushed):
                self._release(name)
            return
        if isinstance(node, ast.While):
            self._expr(node.test)
            self.while_depth += 1
            for stmt in node.body:
                self._stmt(stmt)
            self.while_depth -= 1
            for stmt in node.orelse:
                self._stmt(stmt)
            return
        if isinstance(node, ast.For):
            self._expr(node.iter)
            for stmt in node.body:
                self._stmt(stmt)
            for stmt in node.orelse:
                self._stmt(stmt)
            return
        if isinstance(node, (ast.If,)):
            self._expr(node.test)
            for stmt in node.body:
                self._stmt(stmt)
            for stmt in node.orelse:
                self._stmt(stmt)
            return
        if isinstance(node, (ast.Try,)):
            for stmt in node.body:
                self._stmt(stmt)
            for h in node.handlers:
                for stmt in h.body:
                    self._stmt(stmt)
            for stmt in node.orelse + node.finalbody:
                self._stmt(stmt)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign,
                             ast.AnnAssign)):
            self._assign(node)
            return
        # Everything else: visit expressions in order.
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                self._expr(child)

    def _assign(self, node):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AugAssign):
            targets, value = [node.target], node.value
        else:
            targets = [node.target]
            value = node.value
        if value is not None:
            self._expr(value)
        is_lock_def = (isinstance(value, ast.Call)
                       and _unwrap_factory(value) is not None)
        for tgt in targets:
            if is_lock_def:
                continue
            if isinstance(tgt, ast.Attribute):
                recv = _dotted(tgt.value)
                self.s.model.writes.append(WriteSite(
                    module=self.s.module, attr=tgt.attr,
                    func=self.fn.name, lineno=tgt.lineno,
                    held=tuple(self.held),
                    in_init=self.in_init, receiver=recv,
                    owner_cls=(self.cls if recv == "self"
                               else None),
                    func_key=self.s.fkey(self.cls,
                                         self.fn.name)))
            elif isinstance(tgt, (ast.Subscript,)):
                self._expr(tgt.value)

    # -- expressions --------------------------------------------------- #
    def _expr(self, node):
        if node is None or isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            self._call(node)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _call(self, call: ast.Call):
        fn = call.func
        mod = self.s.module
        # threading.Thread / Timer spawns
        spawn_kind = None
        if isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "threading" \
                and fn.attr in ("Thread", "Timer"):
            spawn_kind = "thread" if fn.attr == "Thread" else "timer"
        elif isinstance(fn, ast.Name) and fn.id in ("Thread",
                                                    "Timer"):
            spawn_kind = "thread" if fn.id == "Thread" else "timer"
        if spawn_kind:
            target = None
            has_name = False
            for kw in call.keywords:
                if kw.arg == "name":
                    has_name = True
                elif kw.arg == "target":
                    if isinstance(kw.value, ast.Name):
                        target = kw.value.id
                    elif isinstance(kw.value, ast.Attribute):
                        target = kw.value.attr
            if spawn_kind == "timer" and len(call.args) > 1:
                v = call.args[1]
                if isinstance(v, ast.Name):
                    target = v.id
                elif isinstance(v, ast.Attribute):
                    target = v.attr
            self.s.model.spawns.append(SpawnSite(
                module=mod, func=self.fn.name,
                lineno=call.lineno, kind=spawn_kind,
                target=target, has_name=has_name, cls=self.cls))
            return

        if isinstance(fn, ast.Attribute):
            attr = fn.attr
            self._expr(fn.value)
            recv_ld = self.s.resolve_lock(fn.value, self.cls,
                                          self.scopes)
            # acquire/release on a known lock object
            if recv_ld is not None and recv_ld.kind in HELD_KINDS:
                if attr == "acquire":
                    self._acquire(self.s.underlying(recv_ld),
                                  call.lineno)
                    return
                if attr == "release":
                    self._release(self.s.underlying(recv_ld))
                    return
                if attr == "wait" and recv_ld.kind == "condition":
                    self.s.model.waits.append(WaitSite(
                        cond=recv_ld.name, module=mod,
                        func=self.fn.name, lineno=call.lineno,
                        in_while=self.while_depth > 0))
                    return
                if attr in ("notify", "notify_all") \
                        and recv_ld.kind == "condition":
                    self.s.model.notifies.append(NotifySite(
                        cond=recv_ld.name,
                        owner=self.s.underlying(recv_ld),
                        module=mod, func=self.fn.name,
                        lineno=call.lineno,
                        held=tuple(self.held), cls=self.cls))
                    self.info.notifies.append(call.lineno)
                    return
            # semaphore acquire / event-or-proc wait are blocking
            recv_txt = _dotted(fn.value).lower()
            blocking = None
            if recv_ld is not None and recv_ld.kind == "semaphore" \
                    and attr == "acquire":
                blocking = f"{_dotted(fn)}() [semaphore]"
            elif attr in BLOCKING_ATTRS:
                blocking = f"{_dotted(fn)}()"
            elif attr in ("wait", "join") and (
                    (recv_ld is not None
                     and recv_ld.kind == "event")
                    or any(t in recv_txt
                           for t in BLOCKING_WAIT_RECV)):
                blocking = f"{_dotted(fn)}()"
            if blocking is not None:
                site = OpSite(op="blocking", desc=blocking,
                              module=mod, func=self.fn.name,
                              lineno=call.lineno,
                              held=tuple(self.held))
                self.info.blocking.append(site)
                if self.held:
                    self.s.model.ops.append(site)
            # user callbacks
            cb = (attr.startswith("on_") or attr in CALLBACK_NAMES
                  or (attr == "write" and "sink" in recv_txt))
            if cb and self.held:
                self.s.model.ops.append(OpSite(
                    op="callback", desc=f"{_dotted(fn)}()",
                    module=mod, func=self.fn.name,
                    lineno=call.lineno, held=tuple(self.held)))
            # intra-module method call on self
            if isinstance(fn.value, ast.Name) \
                    and fn.value.id == "self":
                self.info.calls.append(
                    (self.cls, attr, True, tuple(self.held),
                     call.lineno))
        elif isinstance(fn, ast.Name):
            # bare callback parameters / intra-module functions
            if fn.id.startswith("on_") or fn.id in CALLBACK_NAMES:
                if self.held:
                    self.s.model.ops.append(OpSite(
                        op="callback", desc=f"{fn.id}()",
                        module=mod, func=self.fn.name,
                        lineno=call.lineno,
                        held=tuple(self.held)))
            self.info.calls.append(
                (self.cls, fn.id, False, tuple(self.held),
                 call.lineno))
        for arg in call.args:
            self._expr(arg)
        for kw in call.keywords:
            self._expr(kw.value)

    # -- held bookkeeping ---------------------------------------------- #
    def _acquire(self, name: str, lineno: int):
        for h in self.held:
            if h != name:
                self.s.model.edges.append(EdgeSite(
                    src=h, dst=name, module=self.s.module,
                    func=self.fn.name, lineno=lineno))
        self.held.append(name)
        self.info.acquired.add(name)

    def _release(self, name: str):
        if name in self.held:
            # pop the most recent matching entry
            for i in range(len(self.held) - 1, -1, -1):
                if self.held[i] == name:
                    del self.held[i]
                    return


# ------------------------------------------------------------------ #
# package scan + derived analyses
# ------------------------------------------------------------------ #
def _iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _module_name(root: str, path: str) -> str:
    rel = os.path.relpath(path, root)
    mod = rel[:-3].replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def scan_package(root: Optional[str] = None) -> ConcurrencyModel:
    """Scan every ``.py`` under ``root`` (default: the installed
    ``multigrad_tpu_torch`` package directory) into a
    :class:`ConcurrencyModel`."""
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    model = ConcurrencyModel()
    scanners = []
    for path in _iter_py_files(root):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        sc = _ModuleScanner(_module_name(root, path), tree, source,
                            model)
        sc.collect_defs()
        scanners.append(sc)
    for sc in scanners:
        sc.analyze_functions()
    for sc in scanners:
        _expand_calls(sc)
        _propagate_roots(sc, model)
    return model


def _expand_calls(sc: _ModuleScanner):
    """One level of intra-module call following: a call made while
    holding locks contributes the callee's own acquisitions as
    lock-order edges and the callee's blocking ops as
    blocking-under-lock sites, attributed to the call site.  Every
    resolved call also lands in ``model.calls`` (the notify check's
    caller-context evidence)."""
    for info in sc.funcs.values():
        for cls_ctx, name, is_self, held, lineno in info.calls:
            callee = sc.resolve_callee(cls_ctx, name, is_self)
            if callee is None:
                continue
            sc.model.calls.append((sc.module, callee.cls,
                                   callee.simple, held, lineno))
            if not held:
                continue
            for acquired in sorted(callee.acquired):
                for h in held:
                    if h != acquired:
                        sc.model.edges.append(EdgeSite(
                            src=h, dst=acquired,
                            module=sc.module, func=info.simple,
                            lineno=lineno, via=name))
            for op in callee.blocking:
                sc.model.ops.append(OpSite(
                    op="blocking",
                    desc=f"{op.desc} (via {name})",
                    module=sc.module, func=info.simple,
                    lineno=lineno, held=held, via=name))


def _propagate_roots(sc: _ModuleScanner, model: ConcurrencyModel):
    """Fixpoint thread-root attribution over the intra-module call
    graph: spawn targets seed their own root; functions nobody calls
    seed ``<main>``; roots flow caller -> callee until stable."""
    roots: Dict[tuple, set] = {k: set() for k in sc.funcs}
    called: Dict[tuple, set] = {k: set() for k in sc.funcs}
    resolved_calls = []
    for key, info in sc.funcs.items():
        for cls_ctx, name, is_self, _held, _lineno in info.calls:
            callee = sc.resolve_callee(cls_ctx, name, is_self)
            if callee is None:
                continue
            ckey = (callee.cls, callee.simple)
            called[ckey].add(key)
            resolved_calls.append((key, ckey))
    # A spawn's target resolves like a bare-name call from the
    # spawning context (self._method targets carry the class).
    spawn_targets = set()
    for s in model.spawns:
        if s.module != sc.module or not s.target:
            continue
        callee = sc.resolve_callee(s.cls, s.target, False)
        if callee is not None:
            spawn_targets.add((callee.cls, callee.simple))
    for key in sc.funcs:
        if key in spawn_targets:
            roots[key].add(sc.fkey(*key))
        if not called[key] and key not in spawn_targets:
            roots[key].add(MAIN_ROOT)
    changed = True
    while changed:
        changed = False
        for caller_key, callee_key in resolved_calls:
            before = len(roots[callee_key])
            roots[callee_key] |= roots[caller_key]
            if len(roots[callee_key]) != before:
                changed = True
    for key, r in roots.items():
        model.func_roots[sc.fkey(*key)] = frozenset(
            r or {MAIN_ROOT})


def find_cycles(model: ConcurrencyModel) -> List[list]:
    """Cycles in the lock-order graph (derived + declared, wildcard
    declarations excluded), as lists of lock names."""
    graph: Dict[str, set] = {}
    for a, b in model.edge_pairs():
        graph.setdefault(a, set()).add(b)
    cycles = []
    seen_cycles = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(graph) | {b for bs in graph.values() for b in bs}}

    def dfs(node, path):
        color[node] = GRAY
        path.append(node)
        for nxt in sorted(graph.get(node, ())):
            if color.get(nxt, WHITE) == GRAY:
                i = path.index(nxt)
                cyc = tuple(path[i:])
                canon = tuple(sorted(cyc))
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(cyc) + [nxt])
            elif color.get(nxt, WHITE) == WHITE:
                dfs(nxt, path)
        path.pop()
        color[node] = BLACK

    for node in sorted(color):
        if color[node] == WHITE:
            dfs(node, [])
    return cycles


def to_dot(model: ConcurrencyModel) -> str:
    """The lock-order graph in Graphviz DOT (derived edges solid,
    declared dashed, conditions/events annotated; the CI artifact)."""
    shapes = {"lock": "box", "rlock": "box3d",
              "condition": "ellipse", "event": "diamond",
              "semaphore": "hexagon"}
    lines = ["digraph lock_order {",
             '  rankdir=LR; node [fontsize=10, shape=box];']
    for name in sorted(model.locks):
        ld = model.locks[name]
        if ld.kind == "condition" and ld.shares:
            continue          # rendered as its underlying mutex
        label = f"{name}\\n({ld.kind})"
        lines.append(
            f'  "{name}" [label="{label}", '
            f'shape={shapes.get(ld.kind, "box")}];')
    seen = set()
    for e in model.edges:
        if e.dst == "*":
            lines.append(
                f'  "{e.src}" [style=filled, '
                f'fillcolor="#fff2cc"];  '
                f'// may_precede="*" (fan-out declared)')
            continue
        key = (e.src, e.dst, e.declared)
        if key in seen:
            continue
        seen.add(key)
        style = "dashed" if e.declared else "solid"
        label = "declared" if e.declared \
            else f"{e.module}.{e.func}:{e.lineno}"
        lines.append(f'  "{e.src}" -> "{e.dst}" '
                     f'[style={style}, label="{label}", '
                     f'fontsize=8];')
    lines.append("}")
    return "\n".join(lines) + "\n"
