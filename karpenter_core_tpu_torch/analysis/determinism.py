"""Iteration-order determinism: unordered producers must not
feed order-bearing outputs in the solver/fleet/native/warmstore planes.

Plans, fingerprints/stable hashes, and warmstore payloads all cross a
process boundary; anything order-unstable that reaches them breaks the
repo's plan-identity invariant in exactly the way the PR-5
``_selector_keys`` sort and PR-8 stable argmin tie-breaks hand-fixed.
This rule generalizes those fixes:

- ``os.listdir`` / ``glob.glob`` / ``glob.iglob`` / ``os.scandir`` not
  wrapped in ``sorted(...)`` — filesystem enumeration order is
  arbitrary across kernels and filesystems.
- bare ``.popitem()`` — pops the *last* item, an insertion-order
  artifact; ``popitem(last=False)`` (FIFO eviction) is the repo idiom
  and stays clean.
- iterating a set produced in-expression (``for x in {...}``,
  ``tuple(set(...))``) without ``sorted(...)`` — PYTHONHASHSEED
  reorders sets across processes.
- ``.items()`` / ``.keys()`` / ``.values()`` or set producers feeding a
  ``stable_hash`` / ``*fingerprint*`` / ``*digest*`` call (through the
  local def-use slice) without ``sorted(...)`` — dict insertion order
  is deterministic in-process but *arrival-order-bearing*, which is
  exactly what a content digest must normalize away.

Deliberate order-bearing walks (e.g. warmstore's LRU payload emission,
where recency order IS the payload semantics) declare a scoped
``# analysis: allow-determinism(<why>)`` marker — the rationale is
mandatory; a bare marker still blanket-suppresses but review rejects it.

Dict iteration outside hash sinks is NOT flagged: insertion order is
deterministic for a single process's plan emission.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .engine import FileContext, dotted_name, rule
from .findings import SEV_ERROR, Finding, scoped_marker_args

_FS_PRODUCERS = {"os.listdir", "listdir", "glob.glob", "glob.iglob", "os.scandir", "scandir"}
_HASH_SINKS = ("stable_hash", "fingerprint", "digest")
_ORDER_METHODS = {"items", "keys", "values"}


def _in_scope(ctx: FileContext) -> bool:
    if not ctx.config.in_package(ctx.relpath):
        return True  # fixture opt-in (same convention as ProjectContext.matching)
    return any(
        ctx.relpath.startswith(p) or ctx.relpath == p
        for p in ctx.config.determinism_prefixes
    )


def _parents_of(ctx: FileContext) -> Dict[ast.AST, ast.AST]:
    cached = getattr(ctx, "_analysis_parents", None)
    if cached is None:
        cached = {}
        for node in ctx.walk():
            for child in ast.iter_child_nodes(node):
                cached[child] = node
        object.__setattr__(ctx, "_analysis_parents", cached)
    return cached


def _under_sorted(ctx: FileContext, node: ast.AST) -> bool:
    parents = _parents_of(ctx)
    cur: Optional[ast.AST] = node
    for _ in range(12):
        cur = parents.get(cur)
        if cur is None:
            return False
        if isinstance(cur, ast.Call):
            base = dotted_name(cur.func).split(".")[-1]
            if base in ("sorted", "min", "max", "sum", "len", "set", "frozenset", "Counter"):
                return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
    return False


def _allowed(ctx: FileContext, line: int) -> bool:
    return scoped_marker_args(ctx.lines, line, "determinism") is not None


def _is_set_producer(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        base = dotted_name(node.func).split(".")[-1]
        return base in ("set", "frozenset")
    return False


def _finding(ctx: FileContext, node: ast.AST, symbols: dict, msg: str) -> Finding:
    from .engine import symbol_at

    return Finding(
        rule="determinism",
        path=ctx.relpath,
        line=node.lineno,
        symbol=symbol_at(ctx.tree, node, symbols),
        message=msg,
        severity=SEV_ERROR,
    )


def _assign_map(tree: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(node.value)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            out.setdefault(node.target.id, []).append(node.value)
    return out


def _hash_sink_slice(
    fn_node: ast.AST, call: ast.Call
) -> List[ast.AST]:
    """Def-use closure of a hash-sink call's arguments within the
    enclosing function — the material the digest actually covers."""
    assigns = _assign_map(fn_node)
    out: List[ast.AST] = []
    seen: Set[int] = set()
    work: List[ast.AST] = list(call.args) + [k.value for k in call.keywords]
    while work and len(out) < 300:
        n = work.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        out.append(n)
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                for rhs in assigns.get(sub.id, []):
                    if id(rhs) not in seen:
                        work.append(rhs)
    return out


@rule(
    "determinism",
    "no unordered producers (unsorted listdir/glob, bare popitem, set iteration) feeding plans, digests, or warmstore payloads",
)
def check_determinism(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope(ctx):
        return
    symbols: dict = {}
    flagged: Set[int] = set()

    def emit(node: ast.AST, msg: str):
        if id(node) in flagged:
            return None
        flagged.add(id(node))
        return _finding(ctx, node, symbols, msg)

    # hash/fingerprint sinks first: their slices flag dict-order material
    # that the producer checks below deliberately leave alone
    has_sinks = any(s in ctx.source for s in _HASH_SINKS)
    parents = _parents_of(ctx) if has_sinks else {}

    def _host_fn(node: ast.AST) -> Optional[ast.AST]:
        cur: Optional[ast.AST] = node
        while cur is not None:
            cur = parents.get(cur)
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
        return None

    for node in ctx.walk() if has_sinks else ():
        if not isinstance(node, ast.Call):
            continue
        base = dotted_name(node.func).split(".")[-1]
        if not (base == "stable_hash" or any(s in base for s in _HASH_SINKS[1:])):
            continue
        host = _host_fn(node)
        if host is None:
            continue
        for n in _hash_sink_slice(host, node):
            for sub in ast.walk(n):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _ORDER_METHODS
                    and not sub.args
                    and not _under_sorted(ctx, sub)
                    and not _allowed(ctx, sub.lineno)
                ):
                    f = emit(
                        sub,
                        f".{sub.func.attr}() order reaches the {base}() digest "
                        f"unsorted: dict order is arrival-order-bearing, so "
                        f"two processes observing the same world in different "
                        f"orders digest differently — wrap in sorted(...) or "
                        f"declare `# analysis: allow-determinism(<why>)`",
                    )
                    if f:
                        yield f

    for node in ctx.walk():
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            base = name.split(".")[-1]
            if (name in _FS_PRODUCERS or base in ("listdir", "scandir")) and not (
                _under_sorted(ctx, node) or _allowed(ctx, node.lineno)
            ):
                f = emit(
                    node,
                    f"{base}() enumeration order is filesystem-arbitrary — "
                    f"wrap in sorted(...) so restarts and replicas walk the "
                    f"same sequence, or declare "
                    f"`# analysis: allow-determinism(<why>)`",
                )
                if f:
                    yield f
            elif base in ("glob", "iglob") and name in ("glob.glob", "glob.iglob") and not (
                _under_sorted(ctx, node) or _allowed(ctx, node.lineno)
            ):
                f = emit(
                    node,
                    "glob() match order is filesystem-arbitrary — wrap in "
                    "sorted(...), or declare "
                    "`# analysis: allow-determinism(<why>)`",
                )
                if f:
                    yield f
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "popitem"
                and not node.args
                and not node.keywords
                and not _allowed(ctx, node.lineno)
            ):
                f = emit(
                    node,
                    "bare .popitem() pops by insertion-order recency — an "
                    "arrival-order artifact; use popitem(last=False) (FIFO, "
                    "the repo's eviction idiom) or an explicit key, or "
                    "declare `# analysis: allow-determinism(<why>)`",
                )
                if f:
                    yield f
            elif (
                base in ("tuple", "list")
                and node.args
                and _is_set_producer(node.args[0])
                and not _under_sorted(ctx, node)
                and not _allowed(ctx, node.lineno)
            ):
                f = emit(
                    node,
                    f"{base}() materializes a set's iteration order — "
                    f"PYTHONHASHSEED reorders it across processes; wrap in "
                    f"sorted(...), or declare "
                    f"`# analysis: allow-determinism(<why>)`",
                )
                if f:
                    yield f
        elif isinstance(node, ast.For):
            if (
                _is_set_producer(node.iter)
                and not _allowed(ctx, node.lineno)
            ):
                f = emit(
                    node,
                    "iterating a set literal/constructor — PYTHONHASHSEED "
                    "reorders it across processes; iterate sorted(...), or "
                    "declare `# analysis: allow-determinism(<why>)`",
                )
                if f:
                    yield f
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            for gen in node.generators:
                if _is_set_producer(gen.iter) and not (
                    _under_sorted(ctx, node) or _allowed(ctx, node.lineno)
                ):
                    f = emit(
                        node,
                        "comprehension over a set producer — PYTHONHASHSEED "
                        "reorders it across processes; iterate sorted(...), "
                        "or declare `# analysis: allow-determinism(<why>)`",
                    )
                    if f:
                        yield f
