"""clock-discipline: wall-clock time in control-loop duration logic.

The chaos pack injects clock skew; any duration, timeout, or
expiry computed from ``time.time()`` / ``datetime.now()`` in a control
loop silently breaks under skew or NTP step (a lease that "expires" an
hour early, a backoff that never fires). Durations must come from
``time.monotonic()``.

Wall clock remains legitimate in exactly two places:

- **stamps that leave the process** — lease ``renew_time``,
  ``deletionTimestamp``, condition ``last_transition_time``: other
  processes compare them, so they must be wall clock by protocol;
- **logging / record keeping** — a ``wall_clock`` field on a trace
  record is data, not control flow.

Both are annotated with a scoped ``# analysis: allow-clock(<reason>)``
marker on (or directly above) the flagged line; the reason after
`` — `` documents why wall clock is semantically required.

Flagged in ``config.control_loop_modules``:

- a wall-clock call (``time.time()``, ``datetime.now()``,
  ``datetime.utcnow()``) appearing inside arithmetic (``+``/``-``) or a
  comparison — the shape of duration/timeout/expiry math;
- ``time.time`` (the function object) as an injectable-clock default —
  a parameter default or a ``clock = time.time`` class/module
  assignment — because every downstream ``self.clock() - start``
  inherits the skew sensitivity.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .engine import FileContext, dotted_name, rule
from .findings import SEV_ERROR, Finding, allowed_rules_for_line, scoped_marker_args

# the marker slug (``# analysis: allow-clock(...)``) — deliberately the
# short form from RULES.md rather than the full rule name
MARKER = "clock"

_WALL_EXACT = {"time.time"}
_DATETIME_METHODS = {"now", "utcnow", "today"}


def _wall_call_name(func: ast.AST) -> Optional[str]:
    """The dotted name when ``func`` resolves to a wall-clock source."""
    name = dotted_name(func)
    if not name:
        return None
    if name in _WALL_EXACT:
        return name
    parts = name.split(".")
    if parts[-1] in _DATETIME_METHODS and "datetime" in parts[:-1]:
        return name
    return None


def _in_scope(ctx: FileContext) -> bool:
    rel = ctx.relpath
    return any(rel == m or rel.startswith(m) for m in ctx.config.control_loop_modules)


def _marked(ctx: FileContext, line: int) -> bool:
    """Scoped ``allow-clock(reason)`` or bare ``allow-clock`` at line."""
    if scoped_marker_args(ctx.lines, line, MARKER) is not None:
        return True
    return MARKER in allowed_rules_for_line(ctx.lines, line)


def _wall_calls_in(expr: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and _wall_call_name(node.func):
            yield node


def _clock_default_sites(nodes) -> Iterable[ast.AST]:
    """Expressions that install ``time.time`` (the function, not a call)
    as a stored/injectable clock: parameter defaults and
    ``clock = time.time``-shaped assignments. ``nodes`` is the
    file's cached preorder walk."""
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            args = node.args
            for d in list(args.defaults) + [d for d in args.kw_defaults if d]:
                if dotted_name(d) in _WALL_EXACT:
                    yield d
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None and dotted_name(node.value) in _WALL_EXACT:
                yield node.value
        elif isinstance(node, ast.Assign):
            if dotted_name(node.value) in _WALL_EXACT:
                yield node.value


@rule(
    "clock-discipline",
    "wall-clock time in control-loop duration/timeout/expiry logic "
    "(monotonic only; scoped allow-clock for persisted stamps)",
)
def clock_discipline(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope(ctx):
        return
    from .engine import qualify

    qual = None
    seen: Set[int] = set()
    findings: List[Finding] = []

    def emit(node: ast.AST, message: str) -> None:
        nonlocal qual
        if id(node) in seen:
            return
        seen.add(id(node))
        line = getattr(node, "lineno", 1)
        if _marked(ctx, line):
            return
        if qual is None:
            qual = qualify(ctx.tree)
        findings.append(
            Finding(
                rule="clock-discipline",
                path=ctx.relpath,
                line=line,
                symbol=qual.get(node, ""),
                message=message,
                severity=SEV_ERROR,
            )
        )

    # wall-clock reads participating in duration/expiry math
    for node in ctx.walk():
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Sub)):
            exprs: List[ast.AST] = [node.left, node.right]
        elif isinstance(node, ast.Compare):
            exprs = [node.left, *node.comparators]
        else:
            continue
        for expr in exprs:
            for call in _wall_calls_in(expr):
                name = _wall_call_name(call.func)
                emit(
                    call,
                    f"'{name}()' in duration/expiry arithmetic — wall clock "
                    f"jumps under skew/NTP step; use time.monotonic() (or a "
                    f"scoped '# analysis: allow-clock(reason)' for persisted "
                    f"wall-clock stamps)",
                )

    # wall clock installed as the injectable clock
    for site in _clock_default_sites(ctx.walk()):
        emit(
            site,
            "'time.time' installed as an injectable clock default — every "
            "downstream 'clock() - start' inherits wall-clock skew; default "
            "to time.monotonic (or mark '# analysis: allow-clock(reason)' "
            "when the stamps are persisted/cross-process by protocol)",
        )

    for f in sorted(findings, key=lambda f: f.line):
        yield f
