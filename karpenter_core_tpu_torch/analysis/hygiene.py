"""General hygiene rules: silent broad excepts, mutable default args,
torch imports in host-only control-plane modules.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from .engine import FileContext, dotted_name, rule
from .findings import SEV_ERROR, SEV_WARNING, Finding

# ---------------------------------------------------------------------------
# broad-except


def _is_broad(handler: ast.ExceptHandler) -> Optional[str]:
    """'Exception'/'BaseException'/bare — else None."""
    t = handler.type
    if t is None:
        return "bare except"
    name = dotted_name(t)
    if name in ("Exception", "BaseException", "builtins.Exception"):
        return f"except {name}"
    return None


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body only passes/continues/breaks or returns
    a constant — the exception vanishes with no logging, re-raise, or
    handling of any kind."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return):
            v = stmt.value
            if v is None or isinstance(v, ast.Constant):
                continue
            if isinstance(v, (ast.List, ast.Tuple)) and not v.elts:
                continue
            if isinstance(v, ast.Dict) and not v.keys:
                continue
            return False
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


@rule(
    "broad-except",
    "'except Exception' must not swallow silently — narrow it, log it, re-raise, or mark allow-broad-except",
)
def check_broad_except(ctx: FileContext):
    from .engine import qualify

    qual = None
    for node in ctx.walk():
        if not isinstance(node, ast.ExceptHandler):
            continue
        kind = _is_broad(node)
        if kind is None or not _swallows(node):
            continue
        if qual is None:
            qual = qualify(ctx.tree)
        yield Finding(
            rule="broad-except",
            path=ctx.relpath,
            line=node.lineno,
            symbol=qual.get(node, ""),
            message=(
                f"'{kind}' swallows the exception silently (handler only "
                f"passes/continues/returns a constant) — narrow the type, log, "
                f"or re-raise"
            ),
            severity=SEV_ERROR,
        )


# ---------------------------------------------------------------------------
# mutable defaults

_MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
_MUTABLE_CALLS = {"list", "dict", "set", "defaultdict", "OrderedDict"}


@rule("mutable-default", "no mutable default arguments")
def check_mutable_default(ctx: FileContext):
    from .engine import qualify

    qual = None
    for node in ctx.walk():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        a = node.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults) :], a.defaults))
        pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
        for p, d in pairs:
            bad = isinstance(d, _MUTABLE) or (
                isinstance(d, ast.Call) and dotted_name(d.func) in _MUTABLE_CALLS
            )
            if not bad:
                continue
            if qual is None:
                qual = qualify(ctx.tree)
            name = getattr(node, "name", "<lambda>")
            yield Finding(
                rule="mutable-default",
                path=ctx.relpath,
                line=d.lineno,
                symbol=qual.get(node, name),
                message=(
                    f"parameter '{p.arg}' of '{name}' has a mutable default — "
                    f"shared across calls; use None and construct inside"
                ),
                severity=SEV_WARNING,
            )


# ---------------------------------------------------------------------------
# torch in host-only modules


@rule(
    "torch-host-only",
    "control-plane modules must not import torch — device init belongs to the solver",
)
def check_torch_host_only(ctx: FileContext):
    if not ctx.is_host_only():
        return
    banned = ctx.config.forbidden_import
    for node in ctx.walk():
        mods: List[str] = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [node.module]
        for m in mods:
            if m == banned or m.startswith(banned + "."):
                yield Finding(
                    rule="torch-host-only",
                    path=ctx.relpath,
                    line=node.lineno,
                    symbol="",
                    message=(
                        f"host-only module imports '{m}' — {banned}/backend init must "
                        f"stay behind the solver boundary (solver/backend.py)"
                    ),
                    severity=SEV_ERROR,
                )
