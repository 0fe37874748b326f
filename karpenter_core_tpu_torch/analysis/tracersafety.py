"""tensor-branch: Python control flow on a tensor's value in device-hot
modules, and the device plane's statics.

The port's counterpart of ``karpenter_core_tpu/analysis/tracersafety.py``
(rule ``tracer-safety``). The port traces nothing, so a branch on a
tensor's value raises nothing; it reads the value on the host instead.
On a card's tensor that is an implicit sync in the middle of the device
path, and it is a branch the plain version, run on other inputs or
another device, may take differently. Two checks:

- **(a)** in a device-hot module, an ``if``/``while``/``assert`` test, a
  ternary's test or a ``for`` iterable that reads a device tensor's value
  is a finding. The *device set* of a function starts with its
  parameters annotated ``torch.Tensor`` and the names assigned from a
  device-value producer (as ``host-sync`` reads them), and grows through
  assignments (a value computed from a device tensor is one). ``.shape``,
  ``.ndim``, ``.dtype``, ``.device``, ``.size()``, ``.numel()``,
  ``len()``, ``isinstance()`` and ``is``/``is not`` comparisons read no
  value and end the search, as shape reads do in the reference. An
  explicit conversion (``.item()``, ``.cpu()``, ``int(...)``,
  ``np.asarray(...)``, ...) ends it too: that line is ``host-sync``'s, so
  no line is found twice;
- **(b)** every ``static_names`` entry of ``@deviceplane.observe`` is a
  real parameter of the wrapped function, and none has a mutable
  default: the plane hashes the statics into each call's signature key
  (``tracing/deviceplane.py``), so a typo silently keys the argument as
  a tensor, and a list default cannot be hashed. Checked in every
  module, as the reference checks ``static_argnames``.

Deliberate branches carry ``# analysis: allow-tensor-branch(<why>)``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from .engine import FileContext, decorator_named, dotted_name, rule
from .findings import SEV_ERROR, Finding, scoped_marker_args
from .hostsync import assign_targets, callee_basename, module_producers

_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "itemsize"}
_SHAPE_METHODS = {"size", "numel", "dim", "element_size", "is_contiguous", "stride", "data_ptr"}
_STATIC_FNS = {"len", "isinstance", "type", "hasattr", "getattr", "id", "callable"}
_CONVERTERS = {"int", "float", "bool", "str"}
_NP_CONVERTERS = {"asarray", "array", "ascontiguousarray"}
_MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
_OBSERVE = ("deviceplane.observe",)
_DISPLAYS = (ast.Tuple, ast.List, ast.Set, ast.Dict, ast.ListComp, ast.SetComp, ast.DictComp)


def _params(fn: ast.AST) -> List[ast.arg]:
    a = fn.args
    out = list(a.posonlyargs + a.args + a.kwonlyargs)
    if a.vararg:
        out.append(a.vararg)
    if a.kwarg:
        out.append(a.kwarg)
    return out


def _tensor_annotation(ann) -> bool:
    """``torch.Tensor`` (or ``Tensor``), bare or as an ``Optional[...]``."""
    if ann is None:
        return False
    if isinstance(ann, ast.Subscript) and dotted_name(ann.value).split(".")[-1] == "Optional":
        return _tensor_annotation(ann.slice)
    return dotted_name(ann).split(".")[-1] == "Tensor"


class _Reader:
    def __init__(self, sync_methods: Iterable[str]) -> None:
        self.sync_methods = set(sync_methods)

    def refs(self, expr: ast.AST, device: Set[str]) -> str:
        """The device tensor whose value ``expr`` reads, or ''."""
        if isinstance(expr, ast.Attribute):
            if expr.attr in _SHAPE_ATTRS:
                return ""
            return self.refs(expr.value, device)
        if isinstance(expr, ast.Compare) and all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return ""
        if isinstance(expr, _DISPLAYS):
            return ""  # a container: its truth and its iteration read no tensor's value
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in _STATIC_FNS | _CONVERTERS:
                return ""  # a shape read, or an explicit conversion (host-sync's)
            if isinstance(f, ast.Attribute) and f.attr in _SHAPE_METHODS | self.sync_methods:
                return ""
            name = dotted_name(f)
            if name.split(".")[-1] in _NP_CONVERTERS and name.split(".")[0] in ("np", "numpy"):
                return ""
            for child in list(expr.args) + [kw.value for kw in expr.keywords]:
                hit = self.refs(child, device)
                if hit:
                    return hit
            return "" if isinstance(f, ast.Name) else self.refs(f, device)
        if isinstance(expr, ast.Name):
            return expr.id if expr.id in device else ""
        for child in ast.iter_child_nodes(expr):
            hit = self.refs(child, device)
            if hit:
                return hit
        return ""


def _scan(ctx: FileContext, fn: ast.AST, symbol: str, producers: Set[str]) -> Iterable[Finding]:
    reader = _Reader(ctx.config.sync_methods)

    def finding(line: int, kind: str, name: str):
        if scoped_marker_args(ctx.lines, line, "tensor-branch") is not None:
            return None
        return Finding(
            rule="tensor-branch",
            path=ctx.relpath,
            line=line,
            symbol=symbol,
            message=(
                f"Python {kind} on device tensor '{name}' in a device-hot module — an implicit "
                f"host sync, and a branch the plain version may take apart; keep it on the card "
                f"(torch.where), read it once explicitly, or mark '# analysis: allow-tensor-branch(<why>)'"
            ),
            severity=SEV_ERROR,
        )

    def ternaries(expr: ast.AST, device: Set[str]) -> Iterable[Finding]:
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp):
                name = reader.refs(node.test, device)
                if name:
                    yield finding(node.lineno, "ternary", name)

    def visit(body: Iterable[ast.AST], device: Set[str]) -> Iterable[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # scanned as their own scope
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = stmt.value
                if value is not None:
                    yield from ternaries(value, device)
                targets = assign_targets(stmt)
                from_device = value is not None and (
                    (isinstance(value, ast.Call) and callee_basename(value) in producers)
                    or bool(reader.refs(value, device))
                )
                for t in targets:
                    if from_device:
                        device.add(t)
                    elif not isinstance(stmt, ast.AugAssign):
                        device.discard(t)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                name = reader.refs(stmt.test, device)
                if name:
                    yield finding(stmt.lineno, "'if'" if isinstance(stmt, ast.If) else "'while'", name)
                yield from ternaries(stmt.test, device)
                yield from visit(stmt.body, device)
                yield from visit(stmt.orelse, device)
                continue
            if isinstance(stmt, ast.Assert):
                name = reader.refs(stmt.test, device)
                if name:
                    yield finding(stmt.lineno, "'assert'", name)
                continue
            if isinstance(stmt, ast.For):
                name = reader.refs(stmt.iter, device)
                if name:
                    yield finding(stmt.lineno, "'for' iteration", name)
                for t in assign_targets(ast.Assign(targets=[stmt.target], value=None)):
                    device.discard(t)
                yield from visit(stmt.body, device)
                yield from visit(stmt.orelse, device)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from visit(stmt.body, device)
                continue
            if isinstance(stmt, ast.Try):
                yield from visit(stmt.body, device)
                for h in stmt.handlers:
                    yield from visit(h.body, device)
                yield from visit(stmt.orelse, device)
                yield from visit(stmt.finalbody, device)
                continue
            if isinstance(stmt, (ast.Return, ast.Expr)) and stmt.value is not None:
                yield from ternaries(stmt.value, device)

    device = {p.arg for p in _params(fn) if _tensor_annotation(p.annotation)}
    for f in visit(fn.body, device):
        if f is not None:
            yield f


def _check_statics(ctx: FileContext, fn: ast.AST, symbol: str) -> Iterable[Finding]:
    dec = decorator_named(fn, _OBSERVE)
    if not isinstance(dec, ast.Call):
        return
    statics: List[str] = []
    for kw in dec.keywords:
        if kw.arg == "static_names" and isinstance(kw.value, (ast.Tuple, ast.List)):
            statics = [e.value for e in kw.value.elts if isinstance(e, ast.Constant) and isinstance(e.value, str)]
        elif kw.arg == "static_names" and isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
            statics = [kw.value.value]
    params = [p.arg for p in _params(fn)]
    for name in statics:
        if name not in params:
            yield Finding(
                rule="tensor-branch",
                path=ctx.relpath,
                line=fn.lineno,
                symbol=symbol,
                message=(
                    f"static_names entry '{name}' is not a parameter of '{fn.name}' — the device "
                    f"plane keys the argument it meant to pin as a tensor"
                ),
                severity=SEV_ERROR,
            )
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
    defaults += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
    for p, d in defaults:
        if p.arg in statics and isinstance(d, _MUTABLE_DEFAULTS):
            yield Finding(
                rule="tensor-branch",
                path=ctx.relpath,
                line=d.lineno,
                symbol=symbol,
                message=(
                    f"static parameter '{p.arg}' has an unhashable default — the device plane "
                    f"hashes statics into its signature key"
                ),
                severity=SEV_ERROR,
            )


@rule(
    "tensor-branch",
    "no Python control flow on a device tensor's value in device-hot modules; "
    "deviceplane.observe statics must be real, hashable params",
)
def check_tensor_branch(ctx: FileContext):
    hot = ctx.is_device_hot()
    producers = module_producers(ctx) if hot else set()
    for fn, sym in _functions(ctx.tree.body, ""):
        yield from _check_statics(ctx, fn, sym)
        if hot:
            yield from _scan(ctx, fn, sym, producers)


def _functions(body: List[ast.stmt], sym: str) -> List[tuple]:
    """(function, qualified symbol) for every def in ``body`` and the
    statements nested in it: functions are statements, so no expression
    is walked."""
    out: List[tuple] = []
    stack = [(body, sym)]
    while stack:
        stmts, prefix = stack.pop()
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                child = f"{prefix}.{stmt.name}" if prefix else stmt.name
                if not isinstance(stmt, ast.ClassDef):
                    out.append((stmt, child))
                stack.append((stmt.body, child))
                continue
            for name in ("body", "orelse", "finalbody"):
                nested = getattr(stmt, name, None)
                if nested:
                    stack.append((nested, prefix))
            for h in getattr(stmt, "handlers", ()):
                stack.append((h.body, prefix))
    return out
