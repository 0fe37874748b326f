"""Concurrency-soundness rules: the proof plane over the
repo's lock graph.

Three project-level rules share one cross-module analysis pass:

``lock-order``
    Discovers every Lock/RLock/Condition the scanned modules create
    (``self.X = threading.Lock()`` fields and module-level globals),
    computes the may-hold set at each acquire site — lexically inside a
    function, and across calls via a "caller holds the lock" call-graph
    fixpoint extended cross-module — and builds the global lock-order
    graph. Cycles are potential deadlocks; a 2-cycle is the classic
    inconsistent-order pair. Locks classified as *sinks* (observability
    / interning leaves, see the config's ``sink_modules`` / ``sink_lock_ids``) are
    statically VERIFIED to be leaves: a sink acquiring a non-sink lock
    is itself a finding, and edges *into* sinks are allowed because a
    verified leaf cannot close a cycle.

``wait-under-lock``
    Flags blocking operations executed while a discovered (non-sink)
    lock is held: ``time.sleep``, file I/O (``open``/``pickle.dump``),
    ``subprocess``, device dispatch through the deviceplane seam
    (``pack_jobs`` / ``warmup_compile_only``), queue handoffs on
    StageQueue/Queue-typed receivers, thread ``join()``, ``Event.wait``
    and ``Condition.wait`` on a *different* lock — both directly and
    through resolved calls (the may-block fixpoint). The no-timeout
    sub-check flags zero-argument ``join()`` / ``Event.wait()``
    anywhere in the scanned modules: bounded waits with counted
    timeout outcomes, never silent hangs. Justified handoff sites use
    the scoped marker ``# analysis: allow-wait-under-lock(<why>)`` —
    the argument IS the soundness argument, a bare marker is not
    accepted by review.

``process-boundary``
    Values reachable from a serialization boundary (warmstore payload
    builders, anything feeding ``pickle.dump``/``write_snapshot``,
    ``__getstate__``) must be content-addressed: no ``id()``, no
    threading primitives, no open handles, and no process-local
    interned ordinals. The ordinal check is taint-based: a name passed
    to a ``sig_for_id()`` translator (``sig_names.get(sid)``) is by
    construction a process ordinal — storing that *name* (rather than
    its translated content) into the payload reach is the bug. This is
    the ROADMAP item-1 prerequisite: the emit-side twin of the
    cache-persist restore rules.

The module also exports the runtime witness surface
(``witness_inventory`` / ``static_order_graph``) consumed by
``analysis/lockwitness.py``: the conftest-gated instrumentation that
records actual acquisition orders across tier-1 and asserts every
observed edge is present in the static graph.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import (
    DEFAULT_CONFIG,
    AnalysisConfig,
    FileContext,
    ProjectContext,
    dotted_name,
    project_rule,
    repo_root,
)
from .findings import Finding, scoped_marker_args

# ---------------------------------------------------------------------------
# classification

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
    "Lock": "Lock",
    "RLock": "RLock",
    "Condition": "Condition",
}

#: Locks classified as sinks — the config's ``sink_modules`` and
#: ``sink_lock_ids`` — are observability/interning leaves by contract:
#: they guard a counter bump, a ring append, or an intern table, and
#: must never acquire coordination locks. The lock-order rule VERIFIES
#: that (a sink acquiring a non-sink lock is a finding); in exchange,
#: edges into sinks are allowed (a verified leaf cannot close a cycle),
#: sinks are excluded from wait-under-lock held-sets (single-flight
#: profile gates sleep while held, by design), and the runtime witness
#: does not instrument them (metric bumps under a Condition are
#: statically invisible but provably harmless).
#:
#: The device-dispatch seam — the config's ``device_seam`` — is kept
#: deliberately small: calls that commit work to the card. Encode-kernel
#: calls under _CATALOG_LOCK are the catalog entry's documented mutation
#: contract and stay out of it (residual assumption, see RULES.md).

_QUEUE_BLOCKERS = {"put", "get", "get_entry"}
_QUEUE_CTOR_SUFFIXES = ("StageQueue", "Queue", "SimpleQueue")
_EVENT_CTOR_SUFFIXES = ("Event",)
_REACH_MUTATORS = {"append", "extend", "add", "insert", "update", "setdefault"}

#: Block kinds that propagate through the call graph into
#: wait-under-lock findings at the holding call site. Timed parking
#: ("wait"/"queue" with a timeout) stays a direct-site-only concern —
#: propagating it would flag every lock that ever calls into a
#: backpressure seam.
_PROPAGATED_KINDS = ("device", "io", "join", "sleep", "subprocess")

_SERIALIZER_NAMES = {"write_snapshot", "dump", "dumps"}

WAIT_RULE = "wait-under-lock"


def _is_sink(lock_id: str, relpath: str, config) -> bool:
    """Sink classification with suffix tolerance so fixture copies
    (bare filenames in a tmp tree) classify like their originals."""
    for s in config.sink_lock_ids:
        if lock_id == s or s.endswith("/" + lock_id):
            return True
    for m in config.sink_modules:
        if relpath == m or m.endswith("/" + relpath):
            return True
    return False


# ---------------------------------------------------------------------------
# model


@dataclass
class LockDef:
    lock_id: str  # "relpath::Class.attr" or "relpath::NAME"
    relpath: str
    line: int  # line of the threading.<ctor>() call (creation site)
    kind: str  # Lock | RLock | Condition
    cls: str  # owning class name, "" for module-level
    attr: str
    sink: bool


@dataclass
class _ModInfo:
    ctx: FileContext
    relpath: str
    imports: Dict[str, str] = field(default_factory=dict)  # name -> module relpath
    from_names: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    module_locks: Dict[str, str] = field(default_factory=dict)  # NAME -> lock_id
    # NAME -> ("class", (rel, cls)) for module-level instances
    # (``KERNEL = CudaKernel(...)``), made on first use
    global_types: Optional[Dict[str, tuple]] = None


@dataclass
class _Acquire:
    lock_id: str
    line: int
    held: Tuple[str, ...]
    fnkey: Tuple[str, str]


@dataclass
class _Block:
    kind: str
    line: int
    desc: str
    held: Tuple[str, ...]
    fnkey: Tuple[str, str]
    untimed: bool = False
    own_lock: str = ""  # for cv-wait: the lock the wait releases


@dataclass
class _CallSite:
    callee: Tuple[str, str]
    line: int
    desc: str
    held: Tuple[str, ...]
    fnkey: Tuple[str, str]


@dataclass
class _FnSummary:
    fnkey: Tuple[str, str]  # (relpath, qualname)
    acquires: List[_Acquire] = field(default_factory=list)
    blocks: List[_Block] = field(default_factory=list)
    calls: List[_CallSite] = field(default_factory=list)


# ---------------------------------------------------------------------------
# the analyzer


class _Analyzer:
    def __init__(self, pctx: ProjectContext) -> None:
        self.pctx = pctx
        self.mods: Dict[str, _ModInfo] = {}
        self.locks: Dict[str, LockDef] = {}
        # (relpath, cls) -> attr -> lock_id
        self.class_locks: Dict[Tuple[str, str], Dict[str, str]] = {}
        # (relpath, cls) -> attr -> ("class",(rel,cls)) | ("event",) | ("queue",)
        self.class_fields: Dict[Tuple[str, str], Dict[str, tuple]] = {}
        self.class_bases: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        self.fn_defs: Dict[Tuple[str, str], ast.FunctionDef] = {}
        self.summaries: Dict[Tuple[str, str], _FnSummary] = {}
        self.may_acquire: Dict[Tuple[str, str], Set[str]] = {}
        self.may_block: Dict[Tuple[str, str], Set[str]] = {}
        # (src,dst) -> sorted sites [(relpath, line, qualname)]
        self.edges: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = {}
        # base class -> direct subclasses (inverse of class_bases);
        # built lazily once scanning is complete
        self._children: Optional[Dict[Tuple[str, str], List[Tuple[str, str]]]] = None
        self._targets_cache: Dict[Tuple[str, str], Tuple[Tuple[str, str], ...]] = {}

    # -- module set -------------------------------------------------------

    def scan_files(self) -> List[FileContext]:
        suffixes = list(self.pctx.config.concurrency_modules)
        return self.pctx.matching(suffixes)

    def run(self) -> None:
        files = self.scan_files()
        for ctx in files:
            self._index_module(ctx)
        for rel in sorted(self.mods):
            self._discover_locks(self.mods[rel])
        for rel in sorted(self.mods):
            self._infer_fields(self.mods[rel])
        for rel in sorted(self.mods):
            self._scan_module(self.mods[rel])
        self._fixpoints()
        self._build_edges()

    # -- indexing ---------------------------------------------------------

    def _module_relpath(self, dotted_mod: str) -> Optional[str]:
        base = dotted_mod.replace(".", "/")
        for cand in (base + ".py", base + "/__init__.py"):
            if cand in self.mods or self.pctx.get(cand) is not None:
                return cand
        return None

    def _index_module(self, ctx: FileContext) -> None:
        if ctx.relpath in self.mods:
            return
        mi = _ModInfo(ctx=ctx, relpath=ctx.relpath)
        self.mods[ctx.relpath] = mi
        pkg_parts = ctx.relpath.split("/")[:-1]
        # imports anywhere in the file (function-level imports hoisted:
        # registry.add_tenant does `from ..solver import prewarm as ...`)
        for node in ctx.walk():
            if isinstance(node, ast.Import):
                for alias in node.names:
                    rel = self._module_relpath(alias.name)
                    if rel is not None:
                        mi.imports[alias.asname or alias.name.split(".")[0]] = rel
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    up = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    if node.level - 1 > len(pkg_parts):
                        continue
                    base = "/".join(up + (node.module or "").split("."))
                    base = base.strip("/").replace("//", "/")
                    dotted_mod = base.replace("/", ".")
                else:
                    dotted_mod = node.module or ""
                target = self._module_relpath(dotted_mod) if dotted_mod else None
                if target is None:
                    continue
                for alias in node.names:
                    # `from ..solver import prewarm` may name a submodule
                    sub = self._module_relpath(dotted_mod + "." + alias.name)
                    if sub is not None and not self._defines(target, alias.name):
                        mi.imports[alias.asname or alias.name] = sub
                    else:
                        mi.from_names[alias.asname or alias.name] = (target, alias.name)
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                mi.classes[node.name] = node
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi.functions[node.name] = node

    def _defines(self, relpath: str, name: str) -> bool:
        ctx = self.pctx.get(relpath)
        if ctx is None:
            return False
        for node in ctx.tree.body:
            if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name == name:
                    return True
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        return True
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if (alias.asname or alias.name) == name:
                        return True
        return False

    def _ensure_module(self, relpath: str) -> Optional[_ModInfo]:
        if relpath in self.mods:
            return self.mods[relpath]
        ctx = self.pctx.get(relpath)
        if ctx is None:
            return None
        self._index_module(ctx)
        mi = self.mods[relpath]
        self._discover_locks(mi)
        self._infer_fields(mi)
        return mi

    def _resolve_class(
        self, mi: _ModInfo, name: str, depth: int = 0
    ) -> Optional[Tuple[str, str]]:
        """Class name in a module's scope -> (relpath, classname), chasing
        `from x import C` and package ``__init__`` re-exports (depth<=3)."""
        if depth > 3 or not name:
            return None
        head, _, tail = name.partition(".")
        if tail:  # mod.Class via a module import
            target = mi.imports.get(head)
            if target is not None:
                tm = self._ensure_module(target)
                if tm is not None:
                    return self._resolve_class(tm, tail, depth + 1)
            return None
        if name in mi.classes:
            return (mi.relpath, name)
        hit = mi.from_names.get(name)
        if hit is not None:
            target, orig = hit
            tm = self._ensure_module(target)
            if tm is not None:
                return self._resolve_class(tm, orig, depth + 1)
        return None

    def _resolve_function(
        self, mi: _ModInfo, name: str, depth: int = 0
    ) -> Optional[Tuple[str, str]]:
        if depth > 3 or not name:
            return None
        head, _, tail = name.partition(".")
        if tail:
            target = mi.imports.get(head)
            if target is not None:
                tm = self._ensure_module(target)
                if tm is not None:
                    return self._resolve_function(tm, tail, depth + 1)
            return None
        if name in mi.functions:
            return (mi.relpath, name)
        hit = mi.from_names.get(name)
        if hit is not None:
            target, orig = hit
            tm = self._ensure_module(target)
            if tm is not None:
                return self._resolve_function(tm, orig, depth + 1)
        return None

    # -- lock + field discovery ------------------------------------------

    def _lock_ctor_kind(self, node: ast.AST) -> Optional[Tuple[str, int]]:
        if not isinstance(node, ast.Call):
            return None
        kind = _LOCK_CTORS.get(dotted_name(node.func))
        if kind is None:
            return None
        return kind, node.lineno

    def _add_lock(self, relpath: str, cls: str, attr: str, kind: str, line: int) -> str:
        lock_id = f"{relpath}::{cls}.{attr}" if cls else f"{relpath}::{attr}"
        sink = _is_sink(lock_id, relpath, self.pctx.config)
        self.locks[lock_id] = LockDef(lock_id, relpath, line, kind, cls, attr, sink)
        return lock_id

    def _discover_locks(self, mi: _ModInfo) -> None:
        def module_stmts(body):
            for stmt in body:
                yield stmt
                if isinstance(stmt, (ast.If, ast.Try)):
                    for sub in ast.iter_child_nodes(stmt):
                        if isinstance(sub, ast.stmt):
                            yield from module_stmts([sub])

        for stmt in module_stmts(mi.ctx.tree.body):
            targets: List[ast.expr] = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            hit = self._lock_ctor_kind(value)
            if hit is None:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    mi.module_locks[t.id] = self._add_lock(
                        mi.relpath, "", t.id, hit[0], hit[1]
                    )
        for cname, cdef in mi.classes.items():
            key = (mi.relpath, cname)
            self.class_locks.setdefault(key, {})
            for meth in cdef.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                for node in ast.walk(meth):
                    if not isinstance(node, ast.Assign):
                        continue
                    hit = self._lock_ctor_kind(node.value)
                    if hit is None:
                        continue
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            self.class_locks[key][t.attr] = self._add_lock(
                                mi.relpath, cname, t.attr, hit[0], hit[1]
                            )

    def _infer_fields(self, mi: _ModInfo) -> None:
        for cname, cdef in mi.classes.items():
            key = (mi.relpath, cname)
            if key in self.class_fields:
                continue
            fields: Dict[str, tuple] = {}
            self.class_fields[key] = fields
            bases: List[Tuple[str, str]] = []
            for b in cdef.bases:
                bk = self._resolve_class(mi, dotted_name(b))
                if bk is not None:
                    bases.append(bk)
            self.class_bases[key] = bases
            for meth in cdef.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                ann: Dict[str, tuple] = {}
                for arg in list(meth.args.args) + list(meth.args.kwonlyargs):
                    t = self._annotation_type(mi, arg.annotation)
                    if t is not None:
                        ann[arg.arg] = t
                for node in ast.walk(meth):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        ftype = self._value_type(mi, node.value, ann)
                        if ftype is not None and t.attr not in fields:
                            fields[t.attr] = ftype

    def _annotation_type(self, mi: _ModInfo, ann) -> Optional[tuple]:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):  # Optional[X] / "X | None"
            base = dotted_name(ann.value)
            if base.endswith("Optional"):
                return self._annotation_type(mi, ann.slice)
            return None
        if isinstance(ann, ast.BinOp):  # X | None
            return self._annotation_type(mi, ann.left)
        name = dotted_name(ann)
        if not name:
            return None
        return self._name_type(mi, name)

    def _name_type(self, mi: _ModInfo, name: str) -> Optional[tuple]:
        last = name.split(".")[-1]
        ck = self._resolve_class(mi, name)
        if ck is not None:
            return ("class", ck)
        if last.endswith(_EVENT_CTOR_SUFFIXES):
            return ("event",)
        if last.endswith(_QUEUE_CTOR_SUFFIXES):
            return ("queue",)
        return None

    def _value_type(self, mi: _ModInfo, value, ann: Dict[str, tuple]) -> Optional[tuple]:
        if isinstance(value, ast.BoolOp):
            for operand in value.values:
                t = self._value_type(mi, operand, ann)
                if t is not None:
                    return t
            return None
        if isinstance(value, ast.Call):
            name = dotted_name(value.func)
            if name and name not in _LOCK_CTORS:
                t = self._name_type(mi, name)
                if t is not None:
                    return t
                fk = self._resolve_function(mi, name)
                if fk is not None:
                    return self._return_type(fk)
            return None
        if isinstance(value, ast.Name):
            return ann.get(value.id)
        return None

    def _global_type(self, mi: _ModInfo, name: str, depth: int = 0) -> Optional[tuple]:
        """The type of a module-level instance ``name`` in ``mi`` (assigned
        a constructor call there, or imported from where it is)."""
        if mi.global_types is None:
            mi.global_types = {}
            for node in mi.ctx.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                ):
                    t = self._value_type(mi, node.value, {})
                    if t is not None and t[0] == "class":
                        mi.global_types[node.targets[0].id] = t
        hit = mi.global_types.get(name)
        if hit is None and depth < 3 and name in mi.from_names:
            target, orig = mi.from_names[name]
            tm = self._ensure_module(target)
            if tm is not None:
                return self._global_type(tm, orig, depth + 1)
        return hit

    def _return_type(self, fnkey: Tuple[str, str]) -> Optional[tuple]:
        mi = self.mods.get(fnkey[0])
        fndef = mi.functions.get(fnkey[1]) if mi is not None else None
        if mi is None or fndef is None or fndef.returns is None:
            return None
        return self._annotation_type(mi, fndef.returns)

    # -- class hierarchy lookups -----------------------------------------

    def _iter_mro(self, key: Tuple[str, str], depth: int = 0):
        yield key
        if depth > 4:
            return
        for base in self.class_bases.get(key, ()):
            yield from self._iter_mro(base, depth + 1)

    def _class_lock_attr(self, key: Tuple[str, str], attr: str) -> Optional[str]:
        for k in self._iter_mro(key):
            hit = self.class_locks.get(k, {}).get(attr)
            if hit is not None:
                return hit
        return None

    def _class_field(self, key: Tuple[str, str], attr: str) -> Optional[tuple]:
        for k in self._iter_mro(key):
            hit = self.class_fields.get(k, {}).get(attr)
            if hit is not None:
                return hit
        return None

    def _call_targets(self, callee: Tuple[str, str]) -> Tuple[Tuple[str, str], ...]:
        """Sound may-analysis over dynamic dispatch: a call resolved to
        ``Class.meth`` may execute any subclass override (the static
        type is only an upper bound — e.g. a ``PackBackend``-typed
        receiver dispatching to the fleet's coalescing facade). Returns
        the resolved callee plus every transitive-subclass override
        that has a summary."""
        cached = self._targets_cache.get(callee)
        if cached is not None:
            return cached
        out: List[Tuple[str, str]] = [callee] if callee in self.summaries else []
        rel, qual = callee
        if "." in qual:
            cls, meth = qual.rsplit(".", 1)
            if self._children is None:
                children: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
                for sub, bases in self.class_bases.items():
                    for b in bases:
                        children.setdefault(b, []).append(sub)
                self._children = children
            seen = {(rel, cls)}
            work = list(self._children.get((rel, cls), ()))
            while work:
                sub = work.pop()
                if sub in seen:
                    continue
                seen.add(sub)
                override = (sub[0], f"{sub[1]}.{meth}")
                if override in self.summaries:
                    out.append(override)
                work.extend(self._children.get(sub, ()))
        result = tuple(sorted(out))
        self._targets_cache[callee] = result
        return result

    def _resolve_method(
        self, key: Tuple[str, str], name: str
    ) -> Optional[Tuple[str, str]]:
        for k in self._iter_mro(key):
            mi = self.mods.get(k[0])
            cdef = mi.classes.get(k[1]) if mi is not None else None
            if cdef is None:
                continue
            for meth in cdef.body:
                if (
                    isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and meth.name == name
                ):
                    return (k[0], f"{k[1]}.{name}")
        return None

    # -- per-function scanning -------------------------------------------

    def _scan_module(self, mi: _ModInfo) -> None:
        for fname, fndef in mi.functions.items():
            self._scan_function(mi, None, fname, fndef)
        for cname, cdef in mi.classes.items():
            for meth in cdef.body:
                if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_function(mi, cname, f"{cname}.{meth.name}", meth)

    def _scan_function(
        self, mi: _ModInfo, cls: Optional[str], qual: str, fndef
    ) -> None:
        fnkey = (mi.relpath, qual)
        if fnkey in self.summaries:
            return
        self.fn_defs[fnkey] = fndef
        summary = _FnSummary(fnkey)
        self.summaries[fnkey] = summary
        env: Dict[str, tuple] = {}
        for arg in list(fndef.args.args) + list(fndef.args.kwonlyargs):
            t = self._annotation_type(mi, arg.annotation)
            if t is not None:
                env[arg.arg] = t

        class_key = (mi.relpath, cls) if cls else None

        def lock_of(expr) -> Optional[str]:
            if isinstance(expr, ast.Name):
                hit = env.get(expr.id)
                if hit is not None and hit[0] == "lockid":
                    return hit[1]
                if expr.id in mi.module_locks:
                    return mi.module_locks[expr.id]
                imp = mi.from_names.get(expr.id)
                if imp is not None:
                    tm = self._ensure_module(imp[0])
                    if tm is not None and imp[1] in tm.module_locks:
                        return tm.module_locks[imp[1]]
                return None
            if isinstance(expr, ast.Attribute):
                base = expr.value
                if isinstance(base, ast.Name):
                    if base.id == "self" and class_key is not None:
                        return self._class_lock_attr(class_key, expr.attr)
                    bt = env.get(base.id)
                    if bt is not None and bt[0] == "class":
                        return self._class_lock_attr(bt[1], expr.attr)
                    target = mi.imports.get(base.id)
                    if target is not None:
                        tm = self._ensure_module(target)
                        if tm is not None:
                            return tm.module_locks.get(expr.attr)
                    return None
                bt = type_of(base)
                if bt is not None and bt[0] == "class":
                    return self._class_lock_attr(bt[1], expr.attr)
            return None

        def type_of(expr) -> Optional[tuple]:
            if isinstance(expr, ast.Name):
                hit = env.get(expr.id)
                if hit is not None and hit[0] != "lockid":
                    return hit
                if hit is None:
                    return self._global_type(mi, expr.id)
                return None
            if isinstance(expr, ast.Attribute):
                if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                    if class_key is not None:
                        return self._class_field(class_key, expr.attr)
                    return None
                if isinstance(expr.value, ast.Name) and expr.value.id in mi.imports and expr.value.id not in env:
                    tm = self._ensure_module(mi.imports[expr.value.id])
                    return self._global_type(tm, expr.attr) if tm is not None else None
                bt = type_of(expr.value)
                if bt is not None and bt[0] == "class":
                    return self._class_field(bt[1], expr.attr)
                return None
            if isinstance(expr, ast.Call):
                name = dotted_name(expr.func)
                if name:
                    t = self._name_type(mi, name)
                    if t is not None:
                        return t
                    fk = self._resolve_function(mi, name)
                    if fk is not None:
                        return self._return_type(fk)
                if isinstance(expr.func, ast.Attribute):
                    # module-qualified call: `incremental.warm_state_for(...)`
                    base = expr.func.value
                    if isinstance(base, ast.Name) and base.id in mi.imports:
                        tm = self._ensure_module(mi.imports[base.id])
                        if tm is not None and expr.func.attr in tm.functions:
                            return self._return_type((tm.relpath, expr.func.attr))
                return None
            return None

        def resolve_callee(func) -> Optional[Tuple[str, str]]:
            if isinstance(func, ast.Name):
                return self._resolve_function(mi, func.id)
            if isinstance(func, ast.Attribute):
                base = func.value
                if (
                    isinstance(base, ast.Call)
                    and isinstance(base.func, ast.Name)
                    and base.func.id == "super"
                    and class_key is not None
                ):
                    # super().method(...): the first base class defining it
                    for parent in self.class_bases.get(class_key, []):
                        hit = self._resolve_method(parent, func.attr)
                        if hit is not None:
                            return hit
                    return None
                if isinstance(base, ast.Name):
                    if base.id == "self" and class_key is not None:
                        return self._resolve_method(class_key, func.attr)
                    if base.id in mi.imports:
                        tm = self._ensure_module(mi.imports[base.id])
                        if tm is not None and func.attr in tm.functions:
                            return (tm.relpath, func.attr)
                bt = type_of(base)
                if bt is not None and bt[0] == "class":
                    return self._resolve_method(bt[1], func.attr)
            return None

        def handle_call(node: ast.Call, held: Tuple[str, ...]) -> None:
            func = node.func
            name = dotted_name(func)
            line = node.lineno
            no_args = not node.args and not node.keywords
            if isinstance(func, ast.Attribute):
                attr = func.attr
                if attr == "acquire":
                    lid = lock_of(func.value)
                    if lid is not None:
                        summary.acquires.append(_Acquire(lid, line, held, fnkey))
                    return
                if attr == "release":
                    return
                if attr == "join":
                    # zero-arg join is a thread/process join (str.join and
                    # os.path.join always take arguments); a timeout kw or
                    # numeric-constant arg marks a bounded thread join —
                    # anything else (str.join(iterable)) is not blocking
                    if not node.args and not node.keywords:
                        summary.blocks.append(
                            _Block("join", line,
                                   f"{dotted_name(func.value) or 'thread'}.join()",
                                   held, fnkey, untimed=True)
                        )
                        return
                    timed = any(kw.arg == "timeout" for kw in node.keywords) or (
                        len(node.args) == 1
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, (int, float))
                    )
                    if timed:
                        summary.blocks.append(
                            _Block("join", line,
                                   f"{dotted_name(func.value) or 'thread'}.join(timeout)",
                                   held, fnkey)
                        )
                    return
                if attr == "wait":
                    lid = lock_of(func.value)
                    if lid is not None:
                        summary.blocks.append(
                            _Block("wait", line,
                                   f"Condition.wait on {lid.split('::')[-1]}",
                                   held, fnkey, own_lock=lid)
                        )
                        return
                    rt = type_of(func.value)
                    if rt is not None and rt[0] == "event":
                        timed = bool(node.args) or any(
                            kw.arg == "timeout" for kw in node.keywords
                        )
                        summary.blocks.append(
                            _Block("wait", line,
                                   f"{dotted_name(func.value) or 'event'}.wait()",
                                   held, fnkey, untimed=not timed)
                        )
                        return
                if attr in _QUEUE_BLOCKERS:
                    rt = type_of(func.value)
                    if rt is not None and rt[0] == "queue":
                        summary.blocks.append(
                            _Block("queue", line,
                                   f"{dotted_name(func.value) or 'queue'}.{attr}",
                                   held, fnkey)
                        )
                        return
                if attr in self.pctx.config.device_seam:
                    summary.blocks.append(
                        _Block("device", line, f"{attr} (device dispatch)", held, fnkey)
                    )
                    # no return: the seam call still resolves below so
                    # lock acquisitions inside the dispatched callee (a
                    # coalescing facade's pack_jobs takes the dispatcher
                    # condition) propagate into the order graph
            if name == "time.sleep":
                summary.blocks.append(_Block("sleep", line, "time.sleep", held, fnkey))
                return
            if name == "open":
                summary.blocks.append(_Block("io", line, "open()", held, fnkey))
                return
            if name.startswith("subprocess."):
                summary.blocks.append(_Block("subprocess", line, name, held, fnkey))
                return
            if name in ("pickle.dump", "pickle.load"):
                summary.blocks.append(_Block("io", line, name, held, fnkey))
                return
            if name in self.pctx.config.device_seam:
                summary.blocks.append(
                    _Block("device", line, f"{name} (device dispatch)", held, fnkey)
                )
                # fall through to call resolution: the seam call still
                # propagates lock acquisitions (a coalescing facade's
                # pack_jobs takes the dispatcher condition), only its
                # blocking kind is pinned to "device" above
            callee = resolve_callee(func)
            if callee is not None and callee != fnkey:
                desc = name
                if not desc and isinstance(func, ast.Attribute):
                    desc = func.attr
                summary.calls.append(_CallSite(callee, line, desc, held, fnkey))

        def visit(node, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested defs (thread bodies) scan with an empty held set
                # and do NOT feed the parent's may_acquire/may_block
                self._scan_function(mi, cls, f"{qual}.{node.name}", node)
                return
            if isinstance(node, (ast.ClassDef, ast.Lambda)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cur = held
                for item in node.items:
                    lid = lock_of(item.context_expr)
                    if lid is not None:
                        summary.acquires.append(
                            _Acquire(lid, item.context_expr.lineno, cur, fnkey)
                        )
                        if lid not in cur:
                            cur = cur + (lid,)
                    else:
                        visit(item.context_expr, cur)
                for stmt in node.body:
                    visit(stmt, cur)
                return
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lid = lock_of(node.value)
                        if lid is not None:
                            env[t.id] = ("lockid", lid)
                        else:
                            vt = self._value_type(mi, node.value, {
                                k: v for k, v in env.items() if v[0] != "lockid"
                            }) or type_of(node.value)
                            if vt is not None:
                                env[t.id] = vt
            if isinstance(node, ast.Call):
                handle_call(node, held)
                for child in ast.iter_child_nodes(node):
                    visit(child, held)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fndef.body:
            visit(stmt, ())

    # -- fixpoints and the order graph -----------------------------------

    def _fixpoints(self) -> None:
        for fnkey, s in self.summaries.items():
            self.may_acquire[fnkey] = {a.lock_id for a in s.acquires}
            self.may_block[fnkey] = {b.kind for b in s.blocks}
        changed = True
        guard = 0
        while changed and guard < 50:
            changed = False
            guard += 1
            for fnkey, s in self.summaries.items():
                for call in s.calls:
                    for callee in self._call_targets(call.callee):
                        acq = self.may_acquire[callee] - self.may_acquire[fnkey]
                        if acq:
                            self.may_acquire[fnkey] |= acq
                            changed = True
                        blk = self.may_block[callee] - self.may_block[fnkey]
                        if blk:
                            self.may_block[fnkey] |= blk
                            changed = True

    def _add_edge(self, src: str, dst: str, site: Tuple[str, int, str]) -> None:
        if src == dst:
            return  # RLock re-entry / same-lock nesting
        self.edges.setdefault((src, dst), []).append(site)

    def _build_edges(self) -> None:
        for fnkey, s in self.summaries.items():
            for a in s.acquires:
                site = (fnkey[0], a.line, fnkey[1])
                for h in a.held:
                    self._add_edge(h, a.lock_id, site)
            for call in s.calls:
                if not call.held:
                    continue
                site = (fnkey[0], call.line, fnkey[1])
                for callee in self._call_targets(call.callee):
                    for h in call.held:
                        for acq in self.may_acquire[callee]:
                            self._add_edge(h, acq, site)
        for key in self.edges:
            self.edges[key] = sorted(set(self.edges[key]))

    # -- rule outputs -----------------------------------------------------

    def lock_order_findings(self) -> List[Finding]:
        out: List[Finding] = []
        graph_edges: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = {}
        for (src, dst), sites in sorted(self.edges.items()):
            src_def = self.locks.get(src)
            dst_def = self.locks.get(dst)
            if src_def is None or dst_def is None:
                continue
            if src_def.sink and not dst_def.sink:
                path, line, sym = sites[0]
                out.append(Finding(
                    "lock-order", path, line, sym,
                    f"sink lock {src} (verified observability leaf) acquires "
                    f"coordination lock {dst} — sinks must stay leaves",
                ))
                continue
            if dst_def.sink:
                continue  # edge into a verified leaf cannot close a cycle
            graph_edges[(src, dst)] = sites
        # Tarjan SCC over the coordination-lock graph
        adj: Dict[str, List[str]] = {}
        for (src, dst) in graph_edges:
            adj.setdefault(src, []).append(dst)
            adj.setdefault(dst, [])
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            work = [(v, iter(sorted(adj.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(sorted(adj.get(w, ())))))
                        advanced = True
                        break
                    if w in on:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(comp)

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        for comp in sccs:
            if len(comp) < 2:
                continue
            members = sorted(comp)
            cyc_sites = sorted(
                site
                for (src, dst), sites in graph_edges.items()
                if src in comp and dst in comp
                for site in sites
            )
            path, line, sym = cyc_sites[0]
            if len(members) == 2:
                msg = (
                    f"inconsistent lock order: {members[0]} and {members[1]} "
                    f"are acquired in both orders (potential deadlock)"
                )
            else:
                msg = (
                    "potential deadlock: lock-order cycle among "
                    + ", ".join(members)
                )
            out.append(Finding("lock-order", path, line, sym, msg))
        return out

    def wait_findings(self) -> List[Finding]:
        out: List[Finding] = []

        def tracked(held: Tuple[str, ...], exclude: str = "") -> List[str]:
            keep = []
            for h in held:
                if h == exclude:
                    continue
                d = self.locks.get(h)
                if d is not None and not d.sink:
                    keep.append(h)
            return keep

        def marked(path: str, line: int) -> bool:
            owner = self.pctx.get(path)
            if owner is None:
                return False
            return scoped_marker_args(owner.lines, line, WAIT_RULE) is not None

        for fnkey, s in self.summaries.items():
            for b in s.blocks:
                path = fnkey[0]
                if b.untimed and not marked(path, b.line):
                    out.append(Finding(
                        WAIT_RULE, path, b.line, fnkey[1],
                        f"untimed {b.desc} — bound the wait and count the "
                        f"timeout outcome, never hang silently",
                    ))
                held = tracked(b.held, exclude=b.own_lock)
                if b.kind == "wait" and b.own_lock:
                    # Condition.wait on its own lock while holding ANOTHER
                    # tracked lock: the wait releases only its own lock
                    if held and not marked(path, b.line):
                        out.append(Finding(
                            WAIT_RULE, path, b.line, fnkey[1],
                            f"{b.desc} while also holding {', '.join(held)} — "
                            f"the wait releases only its own lock",
                        ))
                    continue
                if held and not marked(path, b.line):
                    out.append(Finding(
                        WAIT_RULE, path, b.line, fnkey[1],
                        f"blocking {b.kind} ({b.desc}) while holding "
                        f"{', '.join(held)}",
                    ))
            for call in s.calls:
                held = tracked(call.held)
                targets = self._call_targets(call.callee)
                if not held or not targets:
                    continue
                kinds = sorted(
                    {
                        k
                        for callee in targets
                        for k in self.may_block[callee]
                        if k in _PROPAGATED_KINDS
                    }
                )
                if kinds and not marked(call.fnkey[0], call.line):
                    out.append(Finding(
                        WAIT_RULE, call.fnkey[0], call.line, fnkey[1],
                        f"call to {call.callee[1]} may block "
                        f"({', '.join(kinds)}) while holding {', '.join(held)}",
                    ))
        dedup: Dict[Tuple[str, str, str, str], Finding] = {}
        for f in out:
            dedup.setdefault(f.baseline_key, f)
        return sorted(dedup.values(), key=lambda f: (f.path, f.line, f.message))


# ---------------------------------------------------------------------------
# process-boundary


def _sync_attrs(analyzer: _Analyzer, class_key: Tuple[str, str]) -> List[str]:
    attrs = sorted(analyzer.class_locks.get(class_key, {}))
    for attr, ftype in sorted(analyzer.class_fields.get(class_key, {}).items()):
        if ftype[0] in ("event", "queue"):
            attrs.append(attr)
    return attrs


def _process_boundary_findings(analyzer: _Analyzer) -> List[Finding]:
    out: List[Finding] = []
    # modules whose source can possibly reach a serializer root: the
    # payload walk is per-function and dominates this rule's cost, so
    # gate it on a constant-time source probe for the only two call
    # shapes _check_payload roots on (write_snapshot(...) / pickle.*)
    can_serialize: Dict[str, bool] = {}
    for fnkey, fndef in sorted(analyzer.fn_defs.items()):
        relpath, qual = fnkey
        cls = qual.rsplit(".", 2)[0] if "." in qual else ""
        simple = qual.rsplit(".", 1)[-1]
        if simple == "__getstate__" and cls and "." not in cls:
            out.extend(_check_getstate(analyzer, relpath, (relpath, cls), qual, fndef))
        if relpath not in can_serialize:
            mi = analyzer.mods.get(relpath)
            src = mi.ctx.source if mi is not None else ""
            can_serialize[relpath] = "write_snapshot" in src or "pickle." in src
        if (
            can_serialize[relpath]
            or "payload" in simple
            or simple == "__getstate__"
        ):
            out.extend(_check_payload(analyzer, relpath, qual, fndef))
    dedup: Dict[Tuple[str, str, str, str], Finding] = {}
    for f in out:
        dedup.setdefault(f.baseline_key, f)
    return sorted(dedup.values(), key=lambda f: (f.path, f.line, f.message))


def _check_getstate(
    analyzer: _Analyzer,
    relpath: str,
    class_key: Tuple[str, str],
    qual: str,
    fndef,
) -> List[Finding]:
    attrs = _sync_attrs(analyzer, class_key)
    if not attrs:
        return []
    out: List[Finding] = []
    for node in ast.walk(fndef):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        val = node.value
        whole_dict = False
        if isinstance(val, ast.Attribute) and val.attr == "__dict__":
            whole_dict = True
        if (
            isinstance(val, ast.Call)
            and dotted_name(val.func) == "dict"
            and val.args
            and isinstance(val.args[0], ast.Attribute)
            and val.args[0].attr == "__dict__"
        ):
            whole_dict = True
        if whole_dict:
            out.append(Finding(
                "process-boundary", relpath, node.lineno, qual,
                f"__getstate__ serializes self.__dict__ of a class holding "
                f"synchronization primitives ({', '.join(attrs)}) — strip "
                f"them before crossing the process boundary",
            ))
            continue
        leaked = sorted({
            sub.attr
            for sub in ast.walk(val)
            if isinstance(sub, ast.Attribute)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == "self"
            and sub.attr in attrs
        })
        if leaked:
            out.append(Finding(
                "process-boundary", relpath, node.lineno, qual,
                f"__getstate__ payload embeds synchronization primitives "
                f"({', '.join(leaked)}) — they do not survive a process "
                f"boundary",
            ))
    return out


def _base_name(expr) -> Optional[str]:
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _check_payload(
    analyzer: _Analyzer, relpath: str, qual: str, fndef
) -> List[Finding]:
    simple = qual.rsplit(".", 1)[-1]
    roots: Set[str] = set()
    body_nodes = [n for n in ast.walk(fndef) if not isinstance(n, ast.arguments)]
    for node in body_nodes:
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            last = fname.split(".")[-1] if fname else (
                node.func.attr if isinstance(node.func, ast.Attribute) else ""
            )
            if last in _SERIALIZER_NAMES and (
                last == "write_snapshot" or fname.startswith("pickle.")
            ):
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Name):
                        roots.add(arg.id)
    if "payload" in simple or simple == "__getstate__":
        for node in body_nodes:
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Name):
                roots.add(node.value.id)
    if not roots:
        return []

    # stores: (target name, value expr, line) — assigns, subscript
    # stores, and container-mutator calls, nested defs excluded
    stores: List[Tuple[str, ast.expr, int]] = []

    def collect(node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                name = _base_name(t)
                if name is not None:
                    stores.append((name, node.value, node.lineno))
        elif isinstance(node, ast.AugAssign):
            name = _base_name(node.target)
            if name is not None:
                stores.append((name, node.value, node.lineno))
        elif isinstance(node, ast.AnnAssign):
            # `payload: dict = {...}` — without this the reach analysis
            # stops at any annotated assignment and everything flowing
            # into the payload through it goes unchecked
            if node.value is not None:
                name = _base_name(node.target)
                if name is not None:
                    stores.append((name, node.value, node.lineno))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _REACH_MUTATORS:
                name = _base_name(node.func.value)
                if name is not None:
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords if kw.value is not None
                    ]:
                        stores.append((name, arg, node.lineno))
        for child in ast.iter_child_nodes(node):
            collect(child)

    for stmt in fndef.body:
        collect(stmt)

    # reverse reach: names whose contents can flow into a root
    reach = set(roots)
    changed = True
    while changed:
        changed = False
        for target, value, _line in stores:
            if target not in reach:
                continue
            for sub in ast.walk(value):
                if isinstance(sub, ast.Name) and sub.id not in reach:
                    reach.add(sub.id)
                    changed = True

    # ordinal taint: names passed through a sig_for_id() translator
    translators: Set[str] = set()
    for target, value, _line in stores:
        if isinstance(value, ast.Call):
            fname = dotted_name(value.func)
            if fname.split(".")[-1] == "sig_for_id":
                translators.add(target)
    tainted: Set[str] = set()
    for node in body_nodes:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if (
                node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in translators
            ):
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        tainted.add(arg.id)
        elif isinstance(node, ast.Subscript):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id in translators
                and isinstance(node.slice, ast.Name)
            ):
                tainted.add(node.slice.id)
    # names holding TRANSLATED content are clean even if later re-used
    clean: Set[str] = set()
    for target, value, _line in stores:
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute):
            if (
                value.func.attr == "get"
                and isinstance(value.func.value, ast.Name)
                and value.func.value.id in translators
            ):
                clean.add(target)
    tainted -= clean

    def walk_skipping_translations(node):
        """Like ast.walk, but does not descend into translator lookups
        (``sig_names.get(sid)`` / ``sig_names[sid]``) — the sanctioned
        ordinal→content translation is exactly where ordinals appear."""
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if (
                node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in translators
            ):
                return
        if isinstance(node, ast.Subscript):
            if isinstance(node.value, ast.Name) and node.value.id in translators:
                return
        yield node
        for child in ast.iter_child_nodes(node):
            yield from walk_skipping_translations(child)

    out: List[Finding] = []
    for target, value, line in stores:
        if target not in reach:
            continue
        for sub in walk_skipping_translations(value):
            if isinstance(sub, ast.Call):
                fname = dotted_name(sub.func)
                if fname == "id":
                    out.append(Finding(
                        "process-boundary", relpath, line, qual,
                        "serialized payload embeds id() — process-local "
                        "identity does not survive a process boundary",
                    ))
                elif fname in _LOCK_CTORS or fname in (
                    "threading.Event", "threading.Semaphore",
                ):
                    out.append(Finding(
                        "process-boundary", relpath, line, qual,
                        f"serialized payload embeds a threading primitive "
                        f"({fname})",
                    ))
                elif fname == "open":
                    out.append(Finding(
                        "process-boundary", relpath, line, qual,
                        "serialized payload embeds an open handle",
                    ))
            elif isinstance(sub, ast.Name) and sub.id in tainted:
                out.append(Finding(
                    "process-boundary", relpath, line, qual,
                    f"serialized payload stores process-local interned "
                    f"ordinal '{sub.id}' — persist the signature content "
                    f"and re-intern on load",
                ))
    return out


# ---------------------------------------------------------------------------
# shared analyzer + rule registration


def _shared(pctx: ProjectContext) -> _Analyzer:
    cached = getattr(pctx, "_concurrency_analyzer", None)
    if cached is not None:
        return cached
    analyzer = _Analyzer(pctx)
    analyzer.run()
    pctx._concurrency_analyzer = analyzer  # type: ignore[attr-defined]
    return analyzer


@project_rule(
    "lock-order",
    "the global lock-order graph must be acyclic and sink locks must stay leaves",
)
def lock_order_rule(pctx: ProjectContext):
    return _shared(pctx).lock_order_findings()


@project_rule(
    WAIT_RULE,
    "no blocking operation (I/O, device dispatch, queue handoff, join, "
    "cross-lock wait) while holding a coordination lock; every join/Event "
    "wait is bounded",
)
def wait_under_lock_rule(pctx: ProjectContext):
    return _shared(pctx).wait_findings()


@project_rule(
    "process-boundary",
    "values crossing a serialization boundary must be content-addressed: "
    "no id(), threading primitives, open handles, or process ordinals",
)
def process_boundary_rule(pctx: ProjectContext):
    return _process_boundary_findings(_shared(pctx))


# ---------------------------------------------------------------------------
# runtime-witness surface (consumed by analysis/lockwitness.py)

_WITNESS_CACHE: Dict[Tuple[str, AnalysisConfig], _Analyzer] = {}


def _repo_analyzer(root: Optional[str] = None, config: Optional[AnalysisConfig] = None) -> _Analyzer:
    root = root or repo_root()
    config = config or DEFAULT_CONFIG
    hit = _WITNESS_CACHE.get((root, config))
    if hit is not None:
        return hit
    pctx = ProjectContext([], root, config)
    analyzer = _shared(pctx)
    _WITNESS_CACHE[(root, config)] = analyzer
    return analyzer


def witness_inventory(
    root: Optional[str] = None, config: Optional[AnalysisConfig] = None
) -> Dict[Tuple[str, int], Tuple[str, str]]:
    """(relpath, creation line) -> (lock_id, ctor kind) for every
    non-sink lock: what the runtime witness instruments."""
    analyzer = _repo_analyzer(root, config)
    return {
        (d.relpath, d.line): (d.lock_id, d.kind)
        for d in analyzer.locks.values()
        if not d.sink
    }


def static_order_graph(
    root: Optional[str] = None, config: Optional[AnalysisConfig] = None
) -> Set[Tuple[str, str]]:
    """Every static lock-order edge (src held when dst acquired) —
    the superset the runtime witness checks observed edges against."""
    analyzer = _repo_analyzer(root, config)
    return set(analyzer.edges.keys())


def lock_inventory(
    root: Optional[str] = None, config: Optional[AnalysisConfig] = None
) -> List[LockDef]:
    """The full discovered inventory (sinks included), sorted — for
    docs and the witness tests."""
    analyzer = _repo_analyzer(root, config)
    return sorted(analyzer.locks.values(), key=lambda d: d.lock_id)
