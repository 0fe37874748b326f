"""pipeline-safety: no shared mutable state across serving-stage
threads without a lock or a handoff queue.

The serving pipeline (``karpenter_core_tpu/serving/``) is the one
package where multiple long-lived threads cooperate by design. Its
concurrency discipline is explicit:

- work items cross stage boundaries only through ``StageQueue``
  (ownership transfers at put/get);
- everything else shared between threads is either immutable after
  ``__init__``, a synchronization primitive, or guarded by the owning
  class's lock/condition.

This rule enforces the discipline per class:

1. A class participates iff it spawns threads on its own methods
   (``threading.Thread(target=self.m)``) — those methods and their
   intra-class transitive callees form per-entry *thread contexts*;
   every other method (public API, watch callbacks, debug routes) is
   the *external* context.
2. A field participates iff it is MUTATED outside ``__init__``
   (assignment, ``self.x[k] = v``, or a mutating method call like
   ``.append``/``.pop``) and is accessed from two or more contexts —
   that is exactly "mutable state crossing a stage boundary".
3. Every access (read or write) to a participating field must be
   lexically under ``with self.<lock>`` (Lock/RLock/Condition), unless
   the field holds a synchronization/handoff object (constructed from
   ``StageQueue``/``queue.Queue``/``threading.Event``/...), whose own
   methods are the safe crossing.

Known under-approximation: two accesses that both fall in the
*external* context can still race each other (two foreign threads);
the rule targets the stage-crossing hazard class, which is what the
serving design must keep structurally impossible.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .engine import FileContext, dotted_name, rule
from .findings import SEV_ERROR, Finding
from .locks import _MUTATORS, _self_field_root

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock",
               "threading.Condition", "Condition"}

# constructors whose instances are themselves the legal crossing: their
# methods synchronize internally (handoff queues, events, semaphores)
_SYNC_CTOR_SUFFIXES = (
    "StageQueue",
    "Queue",
    "LifoQueue",
    "SimpleQueue",
    "Event",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
    "Barrier",
    "Lock",
    "RLock",
    # trace-context handoff objects: a TraceContext is
    # immutable after construction and ``tracer.capture()`` returns one
    # (or None) — publishing the reference across stage threads is a
    # single GIL-atomic store of an immutable value, the tracer's
    # documented crossing discipline. Known under-approximation: any
    # ``.capture()`` call matches, not just the tracer's.
    "TraceContext",
    "capture",
)

_EXEMPT = {"__init__", "__new__"}


def _in_scope(ctx: FileContext) -> bool:
    rel = ctx.relpath
    if ctx.config.in_package(rel):
        return any(
            rel.startswith(p) for p in getattr(ctx.config, "serving_prefixes", ())
        )
    return True  # fixture snippets opt in by living outside the package


def _ctor_fields(cls: ast.ClassDef, suffixes) -> Set[str]:
    """self.X fields assigned a call whose callee name ends with one of
    ``suffixes`` (anywhere in the class — re-assignment in start() of
    the same type keeps the exemption)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = dotted_name(node.value.func)
            if name and any(name.split(".")[-1] == s for s in suffixes):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.add(t.attr)
    return out


def _thread_entries(cls: ast.ClassDef) -> Set[str]:
    """Method names passed as Thread(target=self.<m>)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        if dotted_name(node.func).split(".")[-1] != "Thread":
            continue
        for kw in node.keywords:
            if kw.arg == "target" and isinstance(kw.value, ast.Attribute):
                v = kw.value
                if isinstance(v.value, ast.Name) and v.value.id == "self":
                    out.add(v.attr)
    return out


class _Access:
    __slots__ = ("field", "line", "locked", "write")

    def __init__(self, field: str, line: int, locked: bool, write: bool):
        self.field = field
        self.line = line
        self.locked = locked
        self.write = write


def _scan(fn: ast.AST, locks: Set[str]) -> Tuple[List[_Access], Set[str]]:
    """(field accesses with lexical lock state, self-method callees)."""
    accesses: List[_Access] = []
    callees: Set[str] = set()
    call_funcs: Set[int] = set()

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            for child in ast.iter_child_nodes(node):
                visit(child, False)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquires = any(
                isinstance(i.context_expr, ast.Attribute)
                and isinstance(i.context_expr.value, ast.Name)
                and i.context_expr.value.id == "self"
                and i.context_expr.attr in locks
                for i in node.items
            )
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
            accesses.append(_Access(node.attr, node.lineno, locked, write))
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, (ast.Store, ast.Del)):
            root = _self_field_root(node, locks)
            if root:
                accesses.append(_Access(root, node.lineno, locked, True))
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
            ):
                callees.add(f.attr)
                call_funcs.add(id(f))
            elif isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                root = _self_field_root(f.value, locks)
                if root:
                    accesses.append(_Access(root, node.lineno, locked, True))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in getattr(fn, "body", ()):
        visit(stmt, False)
    return accesses, callees


@rule(
    "pipeline-safety",
    "serving-stage classes: mutable state crossing thread contexts must be "
    "lock-guarded or a handoff queue",
)
def check_pipeline_safety(ctx: FileContext):
    if not _in_scope(ctx):
        return
    for cls in ctx.walk():
        if not isinstance(cls, ast.ClassDef):
            continue
        entries = _thread_entries(cls)
        if not entries:
            continue
        locks = _ctor_fields(cls, ("Lock", "RLock", "Condition"))
        sync_fields = _ctor_fields(cls, _SYNC_CTOR_SUFFIXES)
        methods: Dict[str, Tuple[List[_Access], Set[str]]] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[item.name] = _scan(item, locks)

        # per-entry thread contexts = transitive intra-class closure
        def reach(entry: str) -> Set[str]:
            seen: Set[str] = set()
            stack = [entry]
            while stack:
                m = stack.pop()
                if m in seen or m not in methods:
                    continue
                seen.add(m)
                stack.extend(methods[m][1])
            return seen

        contexts: Dict[str, Set[str]] = {e: reach(e) for e in entries if e in methods}
        in_thread = set().union(*contexts.values()) if contexts else set()
        # the external context: public API, callbacks, debug routes —
        # anything not exclusively a thread-entry internals. A public
        # method reachable from an entry lives in BOTH contexts.
        field_ctx: Dict[str, Set[str]] = {}
        field_written: Set[str] = set()
        for name, (accesses, _callees) in methods.items():
            mctx: Set[str] = {e for e, r in contexts.items() if name in r}
            if not name.startswith("_") or name not in in_thread:
                mctx.add("external")
            if name in _EXEMPT:
                continue
            for a in accesses:
                field_ctx.setdefault(a.field, set()).update(mctx)
                if a.write:
                    field_written.add(a.field)
        shared = {
            f
            for f, ctxs in field_ctx.items()
            if len(ctxs) > 1 and f in field_written and f not in sync_fields
        }
        if not shared:
            continue
        lock_name = sorted(locks)[0] if locks else "<lock>"
        for name, (accesses, _callees) in methods.items():
            if name in _EXEMPT:
                continue
            seen: Set[Tuple[str, int]] = set()
            for a in accesses:
                if a.locked or a.field not in shared:
                    continue
                key = (a.field, a.line)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    rule="pipeline-safety",
                    path=ctx.relpath,
                    line=a.line,
                    symbol=f"{cls.name}.{name}",
                    message=(
                        f"field '{a.field}' is mutable state shared across "
                        f"stage-thread contexts ({', '.join(sorted(field_ctx[a.field]))}) "
                        f"— access it under 'self.{lock_name}' or hand it off "
                        f"through a StageQueue"
                    ),
                    severity=SEV_ERROR,
                )
