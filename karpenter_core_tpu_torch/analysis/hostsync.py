"""host-sync: host<->device synchronization inside device-hot modules.

The port's counterpart of ``karpenter_core_tpu/analysis/hostsync.py``.
Every read of a card's tensor on the host waits for the stream: an
accidental ``.cpu()`` or ``.item()`` inside ``solver/pack.py``'s class
loop silently re-introduces the per-job serialization the batched
launches exist to remove. Intended sync points (the one download after a
batched launch) carry a scoped ``# analysis: allow-host-sync(<why>)``
marker, which this rule reads; a bare ``# analysis: allow-host-sync``
suppresses the line as every rule's marker does.

Detection is a linear, order-aware dataflow over each function body:
names assigned from calls to device-value producers (the config's
``device_producers``, and the functions of the same module decorated with
one of its ``producer_decorators`` or ``device_code_decorators``) become
*device values*; reassignment from anything else clears them. Bodies of
functions decorated with a ``device_code_decorators`` entry are device
code and are not scanned. Flagged operations:

- the config's ``sync_methods`` (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``) and ``sync_calls`` (``torch.cuda.synchronize``), always:
  they exist only to synchronize. ``.cpu()`` on a tensor that already
  lies on the host is flagged all the same: the rule reads source, not
  devices;
- ``np.asarray / np.array / np.ascontiguousarray / float / int / bool``
  applied to an expression referencing a device value.

Given the reference's vocabulary (``.block_until_ready()``,
``jax.device_get``, jit and vmap bodies as device code) the rule reads
the JAX package as the reference's does.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from .engine import FileContext, decorator_named, dotted_name, rule
from .findings import SEV_ERROR, Finding, scoped_marker_args

_NP_CONVERTERS = {"asarray", "array", "ascontiguousarray"}
_SCALAR_CASTS = {"float", "int", "bool"}


def module_producers(ctx: FileContext) -> Set[str]:
    """The config's cross-module producers and the functions of this
    module that return device values (decorated as producers or as device
    code)."""
    decorators = tuple(ctx.config.producer_decorators) + tuple(ctx.config.device_code_decorators)
    out = set(ctx.config.device_producers)
    for node in ctx.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and decorator_named(node, decorators) is not None:
            out.add(node.name)
    return out


def callee_basename(call: ast.Call) -> str:
    name = dotted_name(call.func)
    return name.split(".")[-1] if name else ""


def _refs_any(expr: ast.AST, names: Set[str]) -> Optional[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in names:
            return node.id
    return None


def assign_targets(node: ast.AST) -> List[str]:
    out: List[str] = []

    def collect(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            collect(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        collect(node.target)
    return out


class _FunctionScan:
    def __init__(self, ctx: FileContext, producers: Set[str], symbol: str):
        self.ctx = ctx
        self.producers = producers
        self.symbol = symbol
        self.device: Set[str] = set()
        self.findings: List[Finding] = []
        self.methods = set(ctx.config.sync_methods)
        self.calls = set(ctx.config.sync_calls)

    def flag(self, line: int, what: str) -> None:
        if scoped_marker_args(self.ctx.lines, line, "host-sync") is not None:
            return  # a marked, intended sync
        self.findings.append(
            Finding(
                rule="host-sync",
                path=self.ctx.relpath,
                line=line,
                symbol=self.symbol,
                message=(
                    f"{what} in device-hot module — host<->device sync; if this "
                    f"is an intentional post-dispatch sync point, mark it "
                    f"'# analysis: allow-host-sync'"
                ),
                severity=SEV_ERROR,
            )
        )

    def check_expr(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in self.methods:
                self.flag(node.lineno, f"'.{f.attr}()'")
                continue
            name = dotted_name(f)
            if name in self.calls:
                self.flag(node.lineno, f"'{name}'")
                continue
            base = name.split(".")[-1] if name else ""
            if base in _NP_CONVERTERS and name.split(".")[0] in ("np", "numpy") and node.args:
                var = _refs_any(node.args[0], self.device)
                if var:
                    self.flag(node.lineno, f"'{name}' on device value '{var}'")
            elif name in _SCALAR_CASTS and node.args:
                var = _refs_any(node.args[0], self.device)
                if var:
                    self.flag(node.lineno, f"'{name}()' on device value '{var}'")

    def run_body(self, body: Iterable[ast.AST]) -> None:
        for stmt in body:
            self.run_stmt(stmt)

    def run_stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested functions are scanned as their own scope
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = stmt.value
            if value is not None:
                self.check_expr(value)
            produced = isinstance(value, ast.Call) and callee_basename(value) in self.producers
            for t in assign_targets(stmt):
                self.device.discard(t)
                if produced:
                    self.device.add(t)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self.check_expr(stmt.test)
            self.run_body(stmt.body)
            self.run_body(stmt.orelse)
            return
        if isinstance(stmt, ast.For):
            self.check_expr(stmt.iter)
            self.run_body(stmt.body)
            self.run_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.check_expr(item.context_expr)
            self.run_body(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.run_body(stmt.body)
            for h in stmt.handlers:
                self.run_body(h.body)
            self.run_body(stmt.orelse)
            self.run_body(stmt.finalbody)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)) and stmt.value is not None:
            self.check_expr(stmt.value)
            return
        # default: scan any expressions hanging off the statement
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self.check_expr(child)


@rule(
    "host-sync",
    "no unmarked host<->device syncs (.cpu()/.item()/np.asarray/...) in device-hot modules",
)
def check_host_sync(ctx: FileContext):
    if not ctx.is_device_hot():
        return
    producers = module_producers(ctx)
    device_code = tuple(ctx.config.device_code_decorators)
    symbols: Dict[ast.AST, str] = {}

    def visit(node: ast.AST, sym: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # device-code bodies (and everything nested in them) are
                # not host code: conversions inside are device ops
                if decorator_named(child, device_code) is not None:
                    continue
                child_sym = f"{sym}.{child.name}" if sym else child.name
                symbols[child] = child_sym
                visit(child, child_sym)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{sym}.{child.name}" if sym else child.name)
            else:
                visit(child, sym)

    visit(ctx.tree, "")
    for fn, sym in symbols.items():
        scan = _FunctionScan(ctx, producers, sym)
        scan.run_body(fn.body)
        yield from scan.findings
