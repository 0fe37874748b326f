"""kernel-registry: every hand-kernel launch in the kernel modules is
counted under the device plane's name of its kernel.

The port's counterpart of ``karpenter_core_tpu/analysis/jitregistry.py``
(rule ``jit-registry``: every jit entry point registers with the device
plane). The port compiles nothing at a call: each kernel is a
``buildlib.CudaKernel`` whose ``launch`` counts, and each wrapper that
launches one is a ``tracing.deviceplane`` entry point. The device plane
sets each kernel's launch counter beside its own per-entry registry and
beside torch.profiler's count; a launch from an unregistered function,
or under another name, breaks that equality without a test noticing. In
``kernel_registry_modules``:

- every ``CudaKernel(...)`` (and every ``super().__init__(...)`` of a
  ``CudaKernel`` subclass) passes ``name=``: the device plane's name of
  the kernel;
- every function that launches a kernel (``<kernel>.launch(...)`` on a
  module-level kernel, or a method of a ``CudaKernel`` subclass that
  calls ``super().launch``, called on a module-level instance) is
  decorated ``@deviceplane.observe("<the kernel's name>", ...)``. The
  subclass's own method (``compat_kernels.py``'s ``super().launch``) is
  reached only through such calls, which this rule holds instead.

A deliberate bypass carries ``# analysis: allow-kernel-registry(<why>)``
on the flagged line or the line above.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import FileContext, decorator_named, dotted_name, rule
from .findings import SEV_ERROR, Finding, scoped_marker_args

_OBSERVE = ("deviceplane.observe",)


def _is_scoped(ctx: FileContext) -> bool:
    return any(ctx.relpath.endswith(m) for m in ctx.config.kernel_registry_modules)


def _marker_present(ctx: FileContext, lines: Iterable[int]) -> bool:
    return any(scoped_marker_args(ctx.lines, ln, "kernel-registry") is not None for ln in lines)


def _is_kernel_ctor(call: ast.Call, subclasses: Set[str]) -> bool:
    name = dotted_name(call.func)
    return name.split(".")[-1] == "CudaKernel" or name in subclasses


def _name_kw(call: ast.Call) -> Tuple[bool, Optional[str]]:
    """(``name=`` given, its value when a string constant)."""
    for kw in call.keywords:
        if kw.arg == "name":
            value = kw.value.value if isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str) else None
            return True, value
    return False, None


def _observed_name(fn: ast.AST) -> Tuple[bool, Optional[str]]:
    """(``fn`` is a device-plane entry point, its name when a constant)."""
    dec = decorator_named(fn, _OBSERVE)
    if dec is None:
        return False, None
    if isinstance(dec, ast.Call) and dec.args and isinstance(dec.args[0], ast.Constant):
        return True, dec.args[0].value
    return True, None


def _super_call(call: ast.Call, method: str) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == method and isinstance(f.value, ast.Call)
            and dotted_name(f.value.func) == "super")


class _Kernels:
    """The module's kernels: ``CudaKernel`` subclasses (their names and
    launching methods) and module-level instances (their names)."""

    def __init__(self, tree: ast.Module) -> None:
        self.subclasses: Dict[str, Optional[str]] = {}  # class → kernel name
        self.launch_methods: Dict[str, Set[str]] = {}  # class → methods calling super().launch
        self.instances: Dict[str, Tuple[str, Optional[str]]] = {}  # module name → (class, kernel name)
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and any(dotted_name(b).split(".")[-1] == "CudaKernel"
                                                      for b in node.bases):
                self.subclasses[node.name] = None
                methods = set()
                for item in node.body:
                    if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    for call in (n for n in ast.walk(item) if isinstance(n, ast.Call)):
                        if _super_call(call, "__init__"):
                            self.subclasses[node.name] = _name_kw(call)[1]
                        elif _super_call(call, "launch"):
                            methods.add(item.name)
                self.launch_methods[node.name] = methods
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(node.value, ast.Call) \
                    and _is_kernel_ctor(node.value, set(self.subclasses)):
                cls = dotted_name(node.value.func)
                name = self.subclasses.get(cls) if cls in self.subclasses else _name_kw(node.value)[1]
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.instances[t.id] = (cls, name)

    def launched(self, call: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
        """(kernel variable, kernel name) when ``call`` launches a
        module-level kernel, else None."""
        f = call.func
        if not (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and f.value.id in self.instances):
            return None
        cls, name = self.instances[f.value.id]
        return (f.value.id, name) if f.attr in self.launch_methods.get(cls, set()) | {"launch"} else None


def _finding(ctx: FileContext, line: int, symbol: str, message: str) -> Finding:
    return Finding(rule="kernel-registry", path=ctx.relpath, line=line, symbol=symbol, message=message,
                   severity=SEV_ERROR)


@rule(
    "kernel-registry",
    "hand-kernel launches in the kernel modules must be device-plane entry points "
    "(@deviceplane.observe under the kernel's name); every CudaKernel is named",
)
def check_kernel_registry(ctx: FileContext):
    if not _is_scoped(ctx):
        return
    kernels = _Kernels(ctx.tree)
    scopes: List[Tuple[ast.AST, str, Optional[str]]] = []  # (function, symbol, enclosing class)

    def visit(node: ast.AST, sym: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_sym = f"{sym}.{child.name}" if sym else child.name
                scopes.append((child, child_sym, cls))
                visit(child, child_sym, None)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{sym}.{child.name}" if sym else child.name, child.name)
            else:
                visit(child, sym, cls)

    visit(ctx.tree, "", None)
    owner: Dict[int, Tuple[ast.AST, str, Optional[str]]] = {}
    for fn, sym, cls in scopes:
        for node in ast.walk(fn):
            owner[id(node)] = (fn, sym, cls)  # innermost wins: scopes are outer-first

    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        fn, sym, cls = owner.get(id(node), (None, "", None))
        if _is_kernel_ctor(node, set()) or (cls in kernels.subclasses and _super_call(node, "__init__")):
            if not _name_kw(node)[0] and not _marker_present(ctx, [node.lineno]):
                yield _finding(ctx, node.lineno, sym, (
                    "CudaKernel built without name= — the device plane counts its launches under no "
                    "entry point's name; pass name=\"<module>.<kernel>\", or mark "
                    "'# analysis: allow-kernel-registry(<why>)'"))
            continue
        if cls in kernels.subclasses and _super_call(node, "launch"):
            continue  # the subclass's launch: its callers are held below
        hit = kernels.launched(node)
        if hit is None:
            continue
        var, kernel_name = hit
        observed, observed_as = _observed_name(fn) if fn is not None else (False, None)
        lines = [node.lineno] + ([fn.lineno] + [d.lineno for d in fn.decorator_list] if fn is not None else [])
        if _marker_present(ctx, lines):
            continue
        if not observed:
            yield _finding(ctx, node.lineno, sym, (
                f"'{var}.{node.func.attr}(...)' launches a hand kernel outside a device-plane entry point — "
                f"decorate the function @deviceplane.observe(\"{kernel_name or '<name>'}\", ...), or mark "
                f"'# analysis: allow-kernel-registry(<why>)'"))
        elif kernel_name is not None and observed_as is not None and observed_as != kernel_name:
            yield _finding(ctx, node.lineno, sym, (
                f"'{var}' (kernel '{kernel_name}') launches under the entry point '{observed_as}' — the "
                f"device plane counts its launches under its own name; observe it as '{kernel_name}'"))
