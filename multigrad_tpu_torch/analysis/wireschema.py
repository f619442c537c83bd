"""Wire-protocol schema extraction and drift lint.

The router and its workers speak newline-delimited JSON
(:mod:`multigrad_tpu_torch.serve.wire`).  The protocol's compatibility
story — a mixed-version fleet where an old router drives new workers
and vice versa — rests on two invariants PRs 13/16/17/18 each
re-tested by hand:

* **Key symmetry** — every key a reader *requires* is a key every
  writer always sends; optional keys are read with ``.get`` and stay
  entirely off the message when absent.
* **Known-keys-only readers** — no reader ever splats a wire dict
  into a constructor (``Thing(**msg)``): unknown fields from a newer
  peer must be ignored, not crash the decode.

This module machine-checks both, the same way :mod:`.lockgraph`
proves lock order: by parsing the serve package's ASTs, never
importing them.  It extracts the full wire schema —

* the five codec pairs (``config/qos/shed/resources/result`` ×
  ``_to_wire``/``_from_wire``), writer keys from the returned dict
  (including loop-writes over module key-tuple constants), reader
  keys split required (``d["k"]``) vs optional (``d.get("k")`` or a
  guarded subscript);
* every ``{"op": ...}`` message constructor in ``worker.py`` /
  ``fleet.py`` / ``chaos.py`` (heartbeat, ready, reject, drain, ...),
  with ``**({...} if cond else {})`` augments and post-hoc
  ``msg["k"] = ...`` decorations classified optional and writer-side
  variable splats marked ``dynamic``;
* both dispatch readers (``worker.main``'s ``op`` chain and
  ``FleetRouter._reader``), following the message dict through
  handler calls (``self._on_result(handle, msg)``, nested
  ``handle_submit(msg)``) to their per-key reads —

and diffs it against the versioned, checked-in
``analysis/protocol.json`` manifest.  Any codec change therefore
becomes an explicit, reviewed manifest bump: CI fails with a
key-level diff naming exactly what drifted.
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .findings import ERROR, WARNING, Finding

__all__ = ["WIRE_CHECK_IDS", "PROTOCOL_VERSION",
           "DEFAULT_MANIFEST_PATH", "extract_schema", "dump_schema",
           "diff_schema", "protocol_markdown", "analyze_wire"]

#: Registry of wire check ids (the ``--checks`` vocabulary of the
#: ``wire`` lint target).
WIRE_CHECK_IDS = (
    "wire-key-asymmetry",
    "wire-reader-splat",
    "wire-manifest-drift",
)

_PROGRAM = "wire"

#: Schema manifest version.  Bump when the manifest SHAPE (not the
#: protocol content) changes.
PROTOCOL_VERSION = 1

#: The checked-in manifest CI diffs against.
DEFAULT_MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "protocol.json")

REQUIRED = "required"
OPTIONAL = "optional"

#: The stdout handshake line a worker prints before serving
#: (``serve/worker.py``) — the one wire message that is not an
#: ``{"op": ...}`` dict.
_READY_PREFIX = "FLEET-WORKER-READY"


# ---------------------------------------------------------------------- #
# small AST helpers
# ---------------------------------------------------------------------- #
def _walk_no_fn(node):
    """ast.walk that does not descend into nested function/class
    definitions."""
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


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _key_tuple(node, consts) -> Optional[Tuple[str, ...]]:
    """Resolve an iterable expression to a tuple of string keys:
    an inline tuple/list of constants, or a module-level tuple
    constant's name."""
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, (ast.Tuple, ast.List)):
        keys = tuple(_const_str(e) for e in node.elts)
        if all(k is not None for k in keys):
            return keys
    return None


@dataclass
class _Fn:
    module: str
    cls: Optional[str]
    name: str
    node: ast.AST
    params: List[str]


@dataclass
class SplatSite:
    module: str
    func: str
    lineno: int
    param: str


@dataclass
class _Mod:
    module: str
    consts: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    fns: Dict[str, List[_Fn]] = field(default_factory=dict)


class _Scanner:
    """One module's function table + module-level key-tuple
    constants (``_RESOURCE_INT_KEYS`` and friends)."""

    def __init__(self, module: str, tree: ast.Module):
        self.mod = _Mod(module)
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                keys = _key_tuple(node.value, {})
                if keys:
                    self.mod.consts[node.targets[0].id] = keys
        self._collect(tree, cls=None)

    def _collect(self, node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                params = [a.arg for a in child.args.args]
                self.mod.fns.setdefault(child.name, []).append(
                    _Fn(self.mod.module, cls, child.name, child,
                        params))
                self._collect(child, cls)      # nested defs
            elif isinstance(child, ast.ClassDef):
                self._collect(child, cls=child.name)
            else:
                self._collect(child, cls)


# ---------------------------------------------------------------------- #
# writer-side key extraction
# ---------------------------------------------------------------------- #
def _dict_literal_keys(node: ast.Dict, keys: Dict[str, str],
                       dynamic: List[bool]):
    """Keys of one dict literal.  ``**({...} if c else {})`` splats
    classify inner keys by presence in both arms; a variable splat
    marks the whole message dynamic."""
    for k, v in zip(node.keys, node.values):
        if k is not None:
            name = _const_str(k)
            if name is not None:
                keys.setdefault(name, REQUIRED)
            continue
        # ** splat
        if isinstance(v, ast.Dict):
            _dict_literal_keys(v, keys, dynamic)
        elif isinstance(v, ast.IfExp) \
                and isinstance(v.body, ast.Dict) \
                and isinstance(v.orelse, ast.Dict):
            both: Dict[str, str] = {}
            one: Dict[str, str] = {}
            _dict_literal_keys(v.body, one, dynamic)
            _dict_literal_keys(v.orelse, both, dynamic)
            for name in set(one) | set(both):
                status = REQUIRED if name in one and name in both \
                    else OPTIONAL
                keys.setdefault(name, status)
        else:
            dynamic.append(True)


def _writer_keys(fn: _Fn, consts) -> Dict[str, str]:
    """Keys a ``*_to_wire`` codec always writes: the returned dict
    literal's keys, plus loop-writes over key-tuple constants and
    direct ``out["k"] = ...`` stores on a returned name."""
    keys: Dict[str, str] = {}
    dynamic: List[bool] = []
    returned: set = set()
    for node in _walk_no_fn(fn.node):
        if isinstance(node, ast.Return):
            if isinstance(node.value, ast.Dict):
                _dict_literal_keys(node.value, keys, dynamic)
            elif isinstance(node.value, ast.Name):
                returned.add(node.value.id)
    if returned:
        for node in _walk_no_fn(fn.node):
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Subscript) \
                    and isinstance(node.targets[0].value, ast.Name) \
                    and node.targets[0].value.id in returned:
                sub = node.targets[0].slice
                name = _const_str(sub)
                if name is not None:
                    keys.setdefault(name, REQUIRED)
                elif isinstance(sub, ast.Name):
                    for loop_keys in _loop_vars(fn.node, consts,
                                                sub.id):
                        for k in loop_keys:
                            keys.setdefault(k, REQUIRED)
    return keys


def _loop_vars(fn_node, consts, var: str) -> List[Tuple[str, ...]]:
    """Key tuples a ``for <var> in <keys>:`` loop binds ``var``
    to, anywhere in the function."""
    out = []
    for node in _walk_no_fn(fn_node):
        if isinstance(node, ast.For) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == var:
            keys = _key_tuple(node.iter, consts)
            if keys:
                out.append(keys)
    return out


# ---------------------------------------------------------------------- #
# reader-side key extraction
# ---------------------------------------------------------------------- #
class _ReaderScan:
    """Reads of ONE wire-dict parameter inside one function, with
    one splat check.  ``.get`` / membership-tested keys are optional;
    bare subscripts are required — unless the same key was also
    ``.get``-probed (the guarded-subscript idiom), which keeps it
    optional."""

    def __init__(self, fn: _Fn, param: str, consts,
                 splats: List[SplatSite]):
        self.keys: Dict[str, str] = {}
        self.handoffs: List[Tuple[ast.Call, int]] = []
        node = fn.node
        loop_cache: Dict[str, List[Tuple[str, ...]]] = {}

        def loops(var):
            if var not in loop_cache:
                loop_cache[var] = _loop_vars(node, consts, var)
            return loop_cache[var]

        subscripts: List[Optional[str]] = []
        for n in _walk_no_fn(node):
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == param \
                        and f.attr == "get" and n.args:
                    key = _const_str(n.args[0])
                    if key is not None:
                        self.keys.setdefault(key, OPTIONAL)
                    elif isinstance(n.args[0], ast.Name):
                        for keys in loops(n.args[0].id):
                            for k in keys:
                                self.keys.setdefault(k, OPTIONAL)
                for kw in n.keywords:
                    if kw.arg is None \
                            and isinstance(kw.value, ast.Name) \
                            and kw.value.id == param:
                        splats.append(SplatSite(
                            fn.module, fn.name, n.lineno, param))
                for i, a in enumerate(n.args):
                    if isinstance(a, ast.Name) and a.id == param:
                        self.handoffs.append((n, i))
            elif isinstance(n, ast.Compare) \
                    and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.In, ast.NotIn)) \
                    and isinstance(n.comparators[0], ast.Name) \
                    and n.comparators[0].id == param:
                key = _const_str(n.left)
                if key is not None:
                    self.keys.setdefault(key, OPTIONAL)
            elif isinstance(n, ast.Subscript) \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == param:
                key = _const_str(n.slice)
                if key is not None:
                    subscripts.append(key)
                elif isinstance(n.slice, ast.Name):
                    for keys in loops(n.slice.id):
                        subscripts.extend(keys)
        for key in subscripts:
            if key is not None and key not in self.keys:
                self.keys[key] = REQUIRED


def _follow_reads(fn: _Fn, param: str, mod: _Mod,
                  splats: List[SplatSite],
                  visited: set) -> Dict[str, str]:
    """Reads of ``param`` in ``fn`` plus (recursively) in every
    same-module function the dict is handed to — how ``_reader``'s
    dispatch reaches ``_on_result``'s reads, and ``_on_error``
    reaches ``_exception_from_wire``'s."""
    if (fn.module, fn.cls, fn.name, param) in visited:
        return {}
    visited.add((fn.module, fn.cls, fn.name, param))
    scan = _ReaderScan(fn, param, mod.consts, splats)
    keys = dict(scan.keys)
    for call, argidx in scan.handoffs:
        callee = _resolve_call(call, fn, mod)
        if callee is None:
            continue
        idx = argidx
        if callee.params and callee.params[0] in ("self", "cls"):
            idx += 1
        if idx >= len(callee.params):
            continue
        sub = _follow_reads(callee, callee.params[idx], mod,
                            splats, visited)
        for k, status in sub.items():
            if status == REQUIRED:
                keys[k] = REQUIRED
            else:
                keys.setdefault(k, OPTIONAL)
    return keys


def _resolve_call(call: ast.Call, caller: _Fn,
                  mod: _Mod) -> Optional[_Fn]:
    f = call.func
    name = None
    want_cls = None
    if isinstance(f, ast.Name):
        name = f.id
    elif isinstance(f, ast.Attribute) \
            and isinstance(f.value, ast.Name) \
            and f.value.id in ("self", "cls"):
        name = f.attr
        want_cls = caller.cls
    if name is None:
        return None
    cands = mod.fns.get(name, [])
    if want_cls is not None:
        cands = [c for c in cands if c.cls == want_cls] or cands
    return cands[0] if cands else None


# ---------------------------------------------------------------------- #
# schema extraction
# ---------------------------------------------------------------------- #
@dataclass
class WireModel:
    """Extraction result: the schema plus the finding anchors."""

    schema: dict
    splats: List[SplatSite] = field(default_factory=list)
    #: (module, lineno) anchor per codec base / message op, for
    #: finding locations.
    anchors: Dict[str, Tuple[str, int]] = field(default_factory=dict)


def _scan_modules(root: Optional[str]):
    serve_only = root is None
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    mods = []
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
            # Dict literals with an "op" key exist outside the wire
            # protocol too (telemetry profiling records); on the
            # default package scan only serve.* speaks the protocol.
            if serve_only and not module.startswith("serve"):
                continue
            with open(path, encoding="utf-8") as f:
                source = f.read()
            mods.append((module, ast.parse(source, filename=path)))
    return mods


def extract_schema(root: Optional[str] = None) -> WireModel:
    """Extract the full wire schema from the package's ASTs.

    ``root=None`` scans ``multigrad_tpu_torch`` itself (serve modules
    only); pass an explicit directory (e.g. a fixture tree) to scan
    everything under it.
    """
    codecs: Dict[str, dict] = {}
    messages: Dict[str, dict] = {}
    model = WireModel(schema={})
    scanners = [(_Scanner(m, t), t) for m, t in _scan_modules(root)]

    # 1. codec pairs (module-level functions only — a class's
    #    `_exception_from_wire`-style helper is a message handler,
    #    reached through the reader dispatch, not a codec)
    for sc, _tree in scanners:
        mod = sc.mod
        for name, fns in mod.fns.items():
            for fn in fns:
                if fn.cls is not None:
                    continue
                if name.endswith("_to_wire"):
                    base = name[:-len("_to_wire")]
                    entry = codecs.setdefault(
                        base, {"writer": None, "reader": None})
                    entry["writer"] = _writer_keys(fn, mod.consts)
                    model.anchors.setdefault(
                        f"codec:{base}",
                        (mod.module, fn.node.lineno))
                elif name.endswith("_from_wire") and fn.params:
                    base = name[:-len("_from_wire")]
                    entry = codecs.setdefault(
                        base, {"writer": None, "reader": None})
                    wire_param = fn.params[0] \
                        if fn.params[0] not in ("self", "cls") \
                        else (fn.params[1] if len(fn.params) > 1
                              else None)
                    if wire_param is None:
                        continue
                    entry["reader"] = _follow_reads(
                        fn, wire_param, mod, model.splats, set())
                    model.anchors.setdefault(
                        f"codec:{base}",
                        (mod.module, fn.node.lineno))

    # 2. message constructors ({"op": ...} dict literals, including
    #    post-hoc msg["k"] = ... decorations), and the READY
    #    handshake line.
    for sc, tree in scanners:
        mod = sc.mod
        for fns in mod.fns.values():
            for fn in fns:
                _collect_messages(fn, mod, messages, model)
        _collect_ready(mod, tree, messages, model)

    # 3. dispatch readers (op = msg.get("op") ... if op == ...:)
    for sc, _tree in scanners:
        mod = sc.mod
        for fns in mod.fns.values():
            for fn in fns:
                _collect_reader(fn, mod, messages, model)

    model.schema = {
        "version": PROTOCOL_VERSION,
        "codecs": codecs,
        "messages": messages,
    }
    return model


def _direction(module: str, reading: bool = False) -> str:
    from_worker = "worker" in module.rsplit(".", 1)[-1]
    if reading:
        from_worker = not from_worker
    return "worker_to_router" if from_worker else "router_to_worker"


def _collect_messages(fn: _Fn, mod: _Mod, messages, model: WireModel):
    # (op, keys, dynamic, holding var, lineno) per {"op": ...} literal
    found: List[tuple] = []
    for n in _walk_no_fn(fn.node):
        if not isinstance(n, ast.Dict):
            continue
        op = None
        for k, v in zip(n.keys, n.values):
            if k is not None and _const_str(k) == "op":
                op = _const_str(v)
        if op is None:
            continue
        keys: Dict[str, str] = {}
        dynamic: List[bool] = []
        _dict_literal_keys(n, keys, dynamic)
        keys.pop("op", None)
        var = None
        for a in _walk_no_fn(fn.node):
            if isinstance(a, ast.Assign) and a.value is n \
                    and len(a.targets) == 1 \
                    and isinstance(a.targets[0], ast.Name):
                var = a.targets[0].id
        found.append((op, keys, bool(dynamic), var, n.lineno))
    if not found:
        return
    # Post-hoc decoration BEFORE merging: a key added to the held
    # message conditionally (`if req.trace is not None:
    # msg["trace"] = ...`) is an optional writer key.
    byvar = {var: keys for op, keys, _dyn, var, _ln in found if var}
    for n in _walk_no_fn(fn.node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Subscript) \
                and isinstance(n.targets[0].value, ast.Name) \
                and n.targets[0].value.id in byvar:
            key = _const_str(n.targets[0].slice)
            if key is not None and key != "op":
                byvar[n.targets[0].value.id] \
                    .setdefault(key, OPTIONAL)
    for op, keys, dynamic, _var, lineno in found:
        _merge_writer(messages, op, keys, dynamic,
                      _direction(fn.module))
        model.anchors.setdefault(f"message:{op}",
                                 (fn.module, lineno))


def _merge_writer(messages, op: str, keys: Dict[str, str],
                  dynamic: bool, direction: str):
    """Several constructors may write one op (three ``reject``
    shapes): the writer contract is the union of keys, required only
    when required by every constructor."""
    entry = messages.setdefault(op, {
        "direction": direction, "writer": None, "dynamic": False,
        "reader": None})
    entry["dynamic"] = entry["dynamic"] or dynamic
    if entry["writer"] is None:
        entry["writer"] = dict(keys)
        return
    prev = entry["writer"]
    for k in set(prev) | set(keys):
        if prev.get(k) == REQUIRED and keys.get(k) == REQUIRED:
            prev[k] = REQUIRED
        else:
            prev[k] = OPTIONAL


def _collect_ready(mod: _Mod, tree, messages, model: WireModel):
    """The ``FLEET-WORKER-READY {json}`` stdout handshake — detected
    as json.dumps of a dict literal concatenated to the marker
    string."""
    for n in ast.walk(tree):
        if not (isinstance(n, ast.BinOp)
                and isinstance(n.op, ast.Add)):
            continue
        marker = _const_str(n.left) or _const_str(n.right) or ""
        if not marker.startswith(_READY_PREFIX):
            continue
        other = n.right if _const_str(n.left) else n.left
        if isinstance(other, ast.Call) \
                and isinstance(other.func, ast.Attribute) \
                and other.func.attr == "dumps" \
                and other.args \
                and isinstance(other.args[0], ast.Dict):
            keys: Dict[str, str] = {}
            dynamic: List[bool] = []
            _dict_literal_keys(other.args[0], keys, dynamic)
            _merge_writer(messages, "ready", keys, bool(dynamic),
                          _direction(mod.module))
            model.anchors.setdefault("message:ready",
                                     (mod.module, n.lineno))


def _collect_reader(fn: _Fn, mod: _Mod, messages, model: WireModel):
    """A dispatch reader: ``op = msg.get("op")`` followed by an
    ``if op == "...":`` chain.  Per-branch reads of the msg dict are
    followed through handler calls."""
    opvar = msgvar = None
    for n in _walk_no_fn(fn.node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Call) \
                and isinstance(n.value.func, ast.Attribute) \
                and n.value.func.attr == "get" \
                and isinstance(n.value.func.value, ast.Name) \
                and n.value.args \
                and _const_str(n.value.args[0]) == "op":
            opvar = n.targets[0].id
            msgvar = n.value.func.value.id
            break
    if opvar is None:
        return
    for n in _walk_no_fn(fn.node):
        if not isinstance(n, ast.If):
            continue
        op = _op_test(n.test, opvar)
        if op is None:
            continue
        splats: List[SplatSite] = []
        keys: Dict[str, str] = {}
        visited: set = set()
        for stmt in n.body:
            branch = _Fn(fn.module, fn.cls, fn.name, stmt, fn.params)
            sub = _follow_reads(branch, msgvar, mod, splats, visited)
            for k, status in sub.items():
                if status == REQUIRED:
                    keys[k] = REQUIRED
                else:
                    keys.setdefault(k, OPTIONAL)
            # each branch statement gets a fresh visited-key for the
            # top frame but shares callee memoization
            visited.discard((fn.module, fn.cls, fn.name, msgvar))
        keys.pop("op", None)
        model.splats.extend(splats)
        entry = messages.setdefault(op, {
            "direction": _direction(fn.module, reading=True),
            "writer": None, "dynamic": False, "reader": None})
        if entry["reader"] is None:
            entry["reader"] = {}
        for k, status in keys.items():
            if status == REQUIRED:
                entry["reader"][k] = REQUIRED
            else:
                entry["reader"].setdefault(k, OPTIONAL)
        model.anchors.setdefault(f"reader:{op}",
                                 (fn.module, n.lineno))


def _op_test(test, opvar: str) -> Optional[str]:
    """``op == "result"`` — possibly inside ``op == "chaos" and
    args.chaos``."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            op = _op_test(v, opvar)
            if op is not None:
                return op
        return None
    if isinstance(test, ast.Compare) \
            and isinstance(test.left, ast.Name) \
            and test.left.id == opvar \
            and len(test.ops) == 1 \
            and isinstance(test.ops[0], ast.Eq):
        return _const_str(test.comparators[0])
    return None


# ---------------------------------------------------------------------- #
# manifest
# ---------------------------------------------------------------------- #
def dump_schema(schema: dict) -> str:
    """Canonical (sorted, stable) JSON for the manifest."""
    return json.dumps(schema, indent=2, sort_keys=True) + "\n"


def diff_schema(expected, actual, prefix: str = "") -> List[str]:
    """Key-level recursive diff, manifest vs extracted.  Each line
    names the exact path that drifted — the CI gate's output."""
    out: List[str] = []
    if isinstance(expected, dict) and isinstance(actual, dict):
        for k in sorted(set(expected) | set(actual), key=str):
            path = f"{prefix}.{k}" if prefix else str(k)
            if k not in actual:
                out.append(f"{path}: removed "
                           f"(manifest has {expected[k]!r})")
            elif k not in expected:
                out.append(f"{path}: added "
                           f"(extracted {actual[k]!r}, "
                           "not in manifest)")
            else:
                out.extend(diff_schema(expected[k], actual[k], path))
        return out
    if expected != actual:
        out.append(f"{prefix}: {expected!r} -> {actual!r}")
    return out


def protocol_markdown(schema: dict) -> str:
    """Render the schema as ``docs/wire_protocol.md`` content."""
    lines = [
        "# Wire protocol",
        "",
        "<!-- Generated from the extracted wire schema"
        " (`python -m multigrad_tpu_torch.analysis.lint --targets wire"
        " --emit-protocol -` renders `analysis/protocol.json`)."
        " Regenerate rather than editing by hand. -->",
        "",
        f"Protocol manifest version: **{schema.get('version')}**.",
        "",
        "The router and its workers exchange newline-delimited JSON",
        "(`serve/wire.py`).  Two invariants make a mixed-version",
        "fleet safe, and both are machine-checked by the `wire` lint",
        "target (`analysis/wireschema.py`):",
        "",
        "1. **Key symmetry** — every key a reader *requires* is one",
        "   every writer always sends.  Optional keys are read with",
        "   `.get` and stay entirely off the message when absent, so",
        "   an undecorated legacy message is byte-identical to the",
        "   older protocol.",
        "2. **Known-keys-only readers** — no reader splats a wire",
        "   dict into a constructor; unknown fields from a newer",
        "   peer are ignored, never a crash.",
        "",
        "## Codec pairs",
        "",
        "`<base>_to_wire` / `<base>_from_wire` in `serve/wire.py`.",
        "Reader status `required` means the decode raises without",
        "the key; `optional` keys default when absent.",
        "",
    ]
    for base in sorted(schema.get("codecs", {})):
        entry = schema["codecs"][base]
        lines += [f"### `{base}`", "",
                  "| key | writer | reader |", "| --- | --- | --- |"]
        writer = entry.get("writer") or {}
        reader = entry.get("reader") or {}
        for key in sorted(set(writer) | set(reader)):
            lines.append(
                f"| `{key}` | {writer.get(key, '—')} "
                f"| {reader.get(key, '—')} |")
        lines.append("")
    lines += [
        "## Messages",
        "",
        "Every `{\"op\": ...}` frame on the router↔worker channel.",
        "`dynamic` writers splat a payload whose keys are not",
        "statically known (the chaos channel); symmetry checking",
        "skips them.",
        "",
    ]
    for op in sorted(schema.get("messages", {})):
        entry = schema["messages"][op]
        writer = entry.get("writer")
        reader = entry.get("reader")
        lines += [f"### `{op}` ({entry.get('direction')})", ""]
        if entry.get("dynamic"):
            lines.append("*Writer carries a dynamic payload.*")
            lines.append("")
        lines += ["| key | writer | reader |", "| --- | --- | --- |"]
        for key in sorted(set(writer or {}) | set(reader or {})):
            w = (writer or {}).get(key, "—")
            r = (reader or {}).get(key, "—")
            lines.append(f"| `{key}` | {w} | {r} |")
        lines.append("")
    lines += [
        "## Manifest-bump procedure",
        "",
        "The extracted schema is pinned in `multigrad_tpu_torch/analysis/",
        "protocol.json`.  CI re-extracts and diffs on every run: a",
        "codec change that does not update the manifest fails the",
        "`wire` lint target with a key-level diff naming the drifted",
        "field.  To change the protocol:",
        "",
        "1. Make the codec change (writer AND reader, keeping new",
        "   keys optional on the reader side so old peers still",
        "   decode).",
        "2. Regenerate: `python -m multigrad_tpu_torch.analysis.lint",
        "   --targets wire --emit-protocol",
        "   multigrad_tpu_torch/analysis/protocol.json`.",
        "3. Commit the manifest diff alongside the code — the diff",
        "   IS the protocol review.",
        "",
        "Regenerate this document with",
        "`python - <<'PY'` + `protocol_markdown(...)` (see",
        "`docs/static_analysis.md`).",
        "",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------- #
# checks
# ---------------------------------------------------------------------- #
def _anchor(model: WireModel, key: str) -> str:
    mod, lineno = model.anchors.get(key, ("", 0))
    if not mod:
        return ""
    return mod.replace(".", "/") + f".py:{lineno}"


def _check_asymmetry(model: WireModel) -> List[Finding]:
    out = []
    schema = model.schema
    for base, entry in sorted(schema.get("codecs", {}).items()):
        writer, reader = entry.get("writer"), entry.get("reader")
        if writer is None or reader is None:
            out.append(Finding(
                "wire-key-asymmetry", ERROR,
                f"codec {base!r} has a "
                f"{'writer' if reader is None else 'reader'} but no "
                f"{'reader' if reader is None else 'writer'} — every "
                "codec ships as a _to_wire/_from_wire pair",
                program=_PROGRAM,
                where=_anchor(model, f"codec:{base}")))
            continue
        for key, status in sorted(reader.items()):
            if status == REQUIRED and key not in writer:
                out.append(Finding(
                    "wire-key-asymmetry", ERROR,
                    f"codec {base!r}: reader requires key {key!r} "
                    "that the writer never sends — decode of every "
                    "message raises",
                    program=_PROGRAM,
                    where=_anchor(model, f"codec:{base}")))
        for key in sorted(set(writer) - set(reader)):
            out.append(Finding(
                "wire-key-asymmetry", WARNING,
                f"codec {base!r}: writer sends key {key!r} that the "
                "reader never reads — dead field or a misspelled "
                "reader key",
                program=_PROGRAM,
                where=_anchor(model, f"codec:{base}")))
    for op, entry in sorted(schema.get("messages", {}).items()):
        writer, reader = entry.get("writer"), entry.get("reader")
        if writer is None or reader is None or entry.get("dynamic"):
            continue
        for key, status in sorted(reader.items()):
            if status == REQUIRED \
                    and writer.get(key) != REQUIRED:
                missing = "optional in" if key in writer \
                    else "missing from"
                out.append(Finding(
                    "wire-key-asymmetry", ERROR,
                    f"message {op!r}: reader requires key {key!r} "
                    f"that is {missing} the writer — a legacy or "
                    "shed message crashes the dispatch loop",
                    program=_PROGRAM,
                    where=_anchor(model, f"reader:{op}")
                    or _anchor(model, f"message:{op}")))
    return out


def _check_splat(model: WireModel) -> List[Finding]:
    out = []
    seen = set()
    for s in model.splats:
        anchor = (s.module, s.lineno)
        if anchor in seen:
            continue
        seen.add(anchor)
        out.append(Finding(
            "wire-reader-splat", ERROR,
            f"wire dict {s.param!r} is **-splatted into a call — "
            "readers are known-keys-only; a newer peer's extra "
            "field must be ignored, not forwarded as an unexpected "
            "keyword",
            program=_PROGRAM,
            where=s.module.replace(".", "/")
            + f".py:{s.lineno} ({s.func})"))
    return out


def _check_drift(model: WireModel,
                 manifest_path: Optional[str]) -> List[Finding]:
    path = manifest_path or DEFAULT_MANIFEST_PATH
    if not os.path.exists(path):
        return [Finding(
            "wire-manifest-drift", ERROR,
            f"wire-protocol manifest {path} does not exist — "
            "generate it with --emit-protocol and commit it; the "
            "manifest is the mixed-version-fleet compatibility gate",
            program=_PROGRAM, path=path)]
    with open(path, encoding="utf-8") as f:
        manifest = json.load(f)
    diffs = diff_schema(manifest, model.schema)
    return [Finding(
        "wire-manifest-drift", ERROR,
        f"extracted wire schema drifted from the manifest: {d} — "
        "a deliberate protocol change must bump the manifest "
        "(--emit-protocol) in the same commit",
        program=_PROGRAM, where=d.split(":", 1)[0], path=path)
        for d in diffs]


def analyze_wire(root: Optional[str] = None, checks=None,
                 manifest_path: Optional[str] = None,
                 model: Optional[WireModel] = None) -> List[Finding]:
    """Run the wire checks; a clean, undrifted tree is ``[]``.

    ``checks`` subsets :data:`WIRE_CHECK_IDS`.  ``manifest_path``
    overrides the checked-in ``analysis/protocol.json`` (the drift
    gate's expectation).
    """
    if model is None:
        model = extract_schema(root)
    selected = set(WIRE_CHECK_IDS) if checks is None \
        else {c for c in checks if c in WIRE_CHECK_IDS}
    findings: List[Finding] = []
    if "wire-key-asymmetry" in selected:
        findings.extend(_check_asymmetry(model))
    if "wire-reader-splat" in selected:
        findings.extend(_check_splat(model))
    if "wire-manifest-drift" in selected:
        findings.extend(_check_drift(model, manifest_path))
    return findings
