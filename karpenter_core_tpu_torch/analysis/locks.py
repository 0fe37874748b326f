"""lock-discipline: guarded-field accesses outside ``with self._mu``.

The Go reference leans on ``go vet`` and the race detector for its
controller concurrency; the Python port's equivalent hazard is a method
touching ``Cluster.nodes`` (or a registry's ``values`` dict) without the
class's lock. The rule is self-calibrating per class:

1. A class participates iff some method assigns ``self.X =
   threading.Lock()`` / ``RLock()`` (any attribute name).
2. Its *guarded fields* are the ``self.*`` attributes MUTATED at least
   once inside a ``with self.<lock>`` block in a non-``__init__`` method
   (attribute assignment, ``self.x[k] = v`` subscript stores, or a
   mutating method call like ``.append``/``.pop``) — the code's own
   locking behavior defines the protected set, so read-only config
   fields (clients, clocks, bucket bounds set once in ``__init__``)
   never false-positive even when they happen to be read under the
   lock.
3. Every other access to a guarded field must be inside a ``with
   self.<lock>`` block, EXCEPT in private helpers (single leading
   underscore) whose intra-class call sites are all lock-held — the
   "caller holds the lock" convention, verified by a fixpoint over the
   call graph. Public methods must lock lexically: they are callable
   from anywhere.

``__init__``/``__new__`` are construction-time and exempt. Nested
functions reset the lock state (they run later, lock unknown) and
nested classes are skipped entirely (``self`` rebinds).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .engine import FileContext, dotted_name, rule
from .findings import SEV_ERROR, Finding

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "Lock",
    "RLock",
}

_EXEMPT_METHODS = {"__init__", "__new__"}

_MUTATORS = {
    "append",
    "extend",
    "insert",
    "pop",
    "popitem",
    "remove",
    "discard",
    "add",
    "clear",
    "update",
    "setdefault",
    "sort",
    "reverse",
    "appendleft",
    "popleft",
}


def _self_field_root(node: ast.AST, locks: Set[str]) -> str:
    """Field name when an Attribute/Subscript chain roots at ``self.X``
    (X not a lock), else ''."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr if node.attr not in locks else ""
        node = node.value
    return ""


@dataclass
class _Access:
    field: str
    line: int
    locked: bool
    write: bool = False


@dataclass
class _MethodInfo:
    name: str
    accesses: List[_Access] = field(default_factory=list)
    # self-method calls: (callee, locked, line)
    calls: List[Tuple[str, bool, int]] = field(default_factory=list)


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names assigned a Lock/RLock anywhere in the class."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if dotted_name(node.value.func) in _LOCK_CTORS:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.add(t.attr)
    return out


def _is_lock_expr(expr: ast.AST, locks: Set[str]) -> bool:
    return (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
        and expr.attr in locks
    )


def _scan_method(fn: ast.AST, locks: Set[str]) -> _MethodInfo:
    info = _MethodInfo(fn.name)

    call_funcs: Set[int] = set()  # self.<m>(...) func nodes — call edges, not field reads

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.ClassDef):
            return  # 'self' rebinds inside a nested class
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a nested function runs later — lock state unknown, so
            # require it to lock (or be suppressed) on its own
            for child in ast.iter_child_nodes(node):
                visit(child, False)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquires = any(_is_lock_expr(i.context_expr, locks) for i in node.items)
            for item in node.items:
                visit(item, locked)
            for stmt in node.body:
                visit(stmt, locked or acquires)
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr not in locks
            and id(node) not in call_funcs
        ):
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            info.accesses.append(_Access(node.attr, node.lineno, locked, write))
        # self.x[k] = v / del self.x[k]: a write to field x
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, (ast.Store, ast.Del)):
            root = _self_field_root(node, locks)
            if root:
                info.accesses.append(_Access(root, node.lineno, locked, True))
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
            ):
                info.calls.append((f.attr, locked, node.lineno))
                call_funcs.add(id(f))
            elif isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                # self.x.append(...) / self.x[k].update(...): mutation of x
                root = _self_field_root(f.value, locks)
                if root:
                    info.accesses.append(_Access(root, node.lineno, locked, True))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in fn.body:
        visit(stmt, False)
    return info


@rule(
    "lock-discipline",
    "guarded self.* fields must be accessed under the owning class's lock",
)
def check_lock_discipline(ctx: FileContext):
    for cls in ctx.walk():
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods: Dict[str, _MethodInfo] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[item.name] = _scan_method(item, locks)

        # "caller holds the lock" fixpoint for private helpers:
        # - assumed: ALL intra-class call sites lock-held -> accesses ok
        # - locked_ctx: AT LEAST ONE lock-held call site -> the helper's
        #   writes mark fields as guarded (a field mutated on a locked
        #   path is meant to be lock-protected, even when a second,
        #   unlocked path exists — that second path is the bug)
        callsites: Dict[str, List[Tuple[str, bool]]] = {}
        for caller, m in methods.items():
            for callee, locked, _line in m.calls:
                callsites.setdefault(callee, []).append((caller, locked))
        private = {
            n
            for n in methods
            if n.startswith("_") and not n.startswith("__") and callsites.get(n)
        }
        assumed = set(private)
        changed = True
        while changed:
            changed = False
            for n in list(assumed):
                for caller, locked in callsites.get(n, ()):
                    if not locked and caller not in assumed:
                        assumed.discard(n)
                        changed = True
                        break
        locked_ctx = set(assumed)
        changed = True
        while changed:
            changed = False
            for n in private - locked_ctx:
                if any(
                    locked or caller in locked_ctx
                    for caller, locked in callsites.get(n, ())
                ):
                    locked_ctx.add(n)
                    changed = True

        guarded: Set[str] = set()
        for name, m in methods.items():
            if name in _EXEMPT_METHODS:
                continue
            in_locked_ctx = name in locked_ctx
            for a in m.accesses:
                if a.write and (a.locked or in_locked_ctx):
                    guarded.add(a.field)
        if not guarded:
            continue

        lock_name = sorted(locks)[0]
        for name, m in methods.items():
            if name in _EXEMPT_METHODS or name in assumed:
                continue
            seen: Set[Tuple[str, int]] = set()
            for a in m.accesses:
                if a.locked or a.field not in guarded:
                    continue
                key = (a.field, a.line)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    rule="lock-discipline",
                    path=ctx.relpath,
                    line=a.line,
                    symbol=f"{cls.name}.{name}",
                    message=(
                        f"field '{a.field}' accessed without holding "
                        f"'self.{lock_name}' (guarded: used under the lock elsewhere "
                        f"in {cls.name})"
                    ),
                    severity=SEV_ERROR,
                )
