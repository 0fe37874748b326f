"""cachesound: prove every cross-solve memo key witnesses its read-set.

The incremental solver rests on one invariant — a warm solve is
plan-identical to a cold solve because every cache is content-addressed
by the exact inputs of a deterministic computation. Until this rule
family, that invariant was defended only by test coverage (the bench-7
oracle, the invalidation matrix). These project rules turn it into a
static gate, the same way salsa/Adapton-style incremental systems make
key/read-set discipline structural:

- **cache-key** (key-completeness): for every memo site on a registered
  cross-solve container (the ``LRU`` caches of ``solver/incremental.py``,
  ``runtime_caches``/``sig_rows`` on catalog entries, ``_CATALOG_CACHE``,
  the podcache intern maps and pod memo, the cross-engine intersects
  memo, and the ``seeds_get``/``seeds_put`` accessor pair), compute the
  read-set of the cached computation by AST dataflow (free variables,
  attribute/subscript paths on solver/cluster/catalog state, values
  flowing through one level of same-project calls) and report any input
  not witnessed by the key expressions, a declared generation guard, or
  a scoped ``# analysis: allow-cache-key(<input>, ...) — reason`` marker.
  The get-side and put-side key expressions must also witness the same
  input roots (a key edited at one end of a split site is exactly the
  kind of bug that corrupts plans under churn).

- **cache-invalidation** (invalidation-completeness): every mutator of
  ``state/cluster.py`` informer state that writes fields the solver's
  caches can observe (derived from the cluster API the consumer modules
  actually call) must bump ``Cluster.generation()`` — directly, through
  a bump helper, or through the "all callers bump" fixpoint for private
  helpers. Symmetrically, any provider class maintaining a
  ``catalog_generation()`` must bump (or reset) it in every method that
  writes catalog-backing fields (the fields ``get_instance_types``
  reads).

- **cache-determinism** (key-determinism): process-unstable material in
  key/digest construction — builtin ``hash()`` anywhere in the cache
  modules (PYTHONHASHSEED), ``id()`` in key material (recycled
  addresses), iteration order of sets materialized without ``sorted``,
  ``repr`` of objects, float-through-``str`` feeding digests, and
  traced/device values flowing into a key (a tracer leak AND a soundness
  bug).

- **cache-persist** (persisted-key re-anchoring): the
  warm-state snapshot/restore seam (``solver/warmstore.py``) must
  re-anchor restored planes against the LIVE world — never install a
  persisted generation counter (another process's ordinal), never drop
  the tenant scope while rebinding persisted keys, and never trust a
  payload whose schema id / key-layout contract hash it has not
  verified.

The analysis is necessarily an approximation; its residual assumptions
are (a) one level of call inlining — deeper callees are modeled as
reading their arguments, and (b) ALL_CAPS module constants are process
config, not per-tick inputs. Both are documented in RULES.md; the
mutation-kill meta-test (tests/test_cachesound.py) demonstrates the
approximation still kills the realistic bug classes: a dropped key
component per cache, a deleted generation bump, a salted fingerprint.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import FileContext, ProjectContext, dotted_name, project_rule
from .findings import SEV_ERROR, Finding, scoped_marker_args

Path = Tuple[str, ...]

_WILD = "*"

# builtins whose calls read only their arguments
_PURE_BUILTINS = {
    "len", "range", "enumerate", "zip", "sorted", "reversed", "min", "max",
    "sum", "abs", "round", "tuple", "list", "dict", "set", "frozenset",
    "int", "float", "bool", "str", "bytes", "id", "hash", "repr", "iter",
    "next", "map", "filter", "any", "all", "isinstance", "issubclass",
    "callable", "print", "format", "vars", "type", "hasattr", "divmod",
}

# module roots that never carry per-tick solve inputs
_BENIGN_ROOTS = {
    "np", "jnp", "jax", "torch", "math", "os", "hashlib", "struct", "threading",
    "itertools", "functools", "collections", "time", "logging", "re",
}

_INLINE_DEPTH = 2
_INLINE_STMT_CAP = 400


def _is_const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def render(path: Path) -> str:
    parts = [p for p in path if p != _WILD]
    return ".".join(parts) if parts else path[0]


def parse_marker_path(text: str) -> Path:
    parts = [p for p in re.split(r"[.\[\]]+", text) if p]
    return tuple(parts)


def paths_match(a: Path, b: Path) -> bool:
    """True when one path is a (wildcard-tolerant) prefix of the other."""
    for x, y in zip(a, b):
        if x != y and x != _WILD and y != _WILD:
            return False
    return True


def rootkey(path: Path) -> Path:
    """Comparison granularity for roots: ``self``-rooted paths compare on
    the first attribute (``self._a`` vs ``self._b`` are distinct roots)."""
    if path and path[0] == "self":
        return path[:2]
    return path[:1]


# ---------------------------------------------------------------------------
# project symbol index


@dataclass
class FnInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    ctx: FileContext
    cls: Optional[str]
    symbol: str

    @property
    def name(self) -> str:
        return self.node.name


@dataclass
class ClassInfo:
    node: ast.ClassDef
    ctx: FileContext
    methods: Dict[str, FnInfo] = field(default_factory=dict)
    properties: Set[str] = field(default_factory=set)


@dataclass
class ModuleInfo:
    ctx: FileContext
    functions: Dict[str, FnInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    # import alias -> repo relpath (project modules) or None (external)
    imports: Dict[str, Optional[str]] = field(default_factory=dict)
    # name imported via `from .mod import name` -> (relpath, name)
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    globals_caps: Set[str] = field(default_factory=set)  # ALL_CAPS constants


def _index_module(ctx: FileContext) -> ModuleInfo:
    mi = ModuleInfo(ctx)
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mi.functions[node.name] = FnInfo(node, ctx, None, node.name)
        elif isinstance(node, ast.ClassDef):
            ci = ClassInfo(node, ctx)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # a property setter/deleter must not shadow the
                    # getter (same def name): reads resolve to the getter
                    accessor = any(
                        dotted_name(d).endswith((".setter", ".deleter"))
                        for d in item.decorator_list
                    )
                    if not (accessor and item.name in ci.methods):
                        ci.methods[item.name] = FnInfo(
                            item, ctx, node.name, f"{node.name}.{item.name}"
                        )
                    for dec in item.decorator_list:
                        if dotted_name(dec) in ("property", "cached_property"):
                            ci.properties.add(item.name)
            mi.classes[node.name] = ci
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id.upper() == t.id:
                    mi.globals_caps.add(t.id)
    for node in ctx.walk():
        if isinstance(node, ast.Import):
            for a in node.names:
                mi.imports[a.asname or a.name.split(".")[0]] = None
        elif isinstance(node, ast.ImportFrom):
            pkg = ctx.relpath.split("/")[:-1]
            if node.level > 1:
                pkg = pkg[: len(pkg) - (node.level - 1)]
            for a in node.names:
                local = a.asname or a.name
                if not node.level:
                    mi.imports[local] = None
                elif node.module is None:
                    # `from . import merge [as merge_mod]`: submodule alias
                    mi.imports[local] = "/".join(pkg + [a.name]) + ".py"
                else:
                    rel = "/".join(pkg + node.module.split(".")) + ".py"
                    mi.from_imports[local] = (rel, a.name)
    return mi


# ---------------------------------------------------------------------------
# registered cross-solve containers


@dataclass(frozen=True)
class ContainerSpec:
    name: str  # human cache name (finding messages)
    owner_scoped: bool = False  # owner object is a content address


class Registry:
    def __init__(self) -> None:
        self.attrs: Dict[str, ContainerSpec] = {}
        self.globals: Dict[str, ContainerSpec] = {}
        # container factories: module functions that make and return an
        # ``LRU("name")`` (one per device, say); a local assigned from a
        # call to one is that container
        self.factories: Dict[str, ContainerSpec] = {}

    def for_receiver(self, path: Optional[Path]) -> Optional[ContainerSpec]:
        if not path:
            return None
        last = path[-1]
        spec = self.attrs.get(last)
        if spec is not None and len(path) > 1:
            return spec
        if len(path) == 1:
            return self.globals.get(path[0])
        return None


def _build_registry(files: Sequence[FileContext]) -> Registry:
    reg = Registry()
    # fixed containers: catalog-entry scoped rows, the catalog cache, the
    # podcache intern maps, the cross-engine intersects memo
    reg.attrs["runtime_caches"] = ContainerSpec("runtime_caches", owner_scoped=True)
    reg.attrs["sig_rows"] = ContainerSpec("sig_rows", owner_scoped=True)
    reg.attrs["_intersects_cache"] = ContainerSpec("intersects")
    for g in ("_CATALOG_CACHE", "_REQ_INTERN", "_SIG_INTERN"):
        reg.globals[g] = ContainerSpec(g.strip("_").lower())
    # discovered: every `self.X = LRU("name")` is a cross-solve cache
    for f in files:
        for node in f.walk():
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and dotted_name(node.value.func) in ("LRU", "incremental.LRU")
            ):
                cname = None
                if node.value.args:
                    cname = _is_const_str(node.value.args[0])
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        reg.attrs[t.attr] = ContainerSpec(cname or t.attr)
        for fn in f.tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            made = [
                _is_const_str(n.args[0])
                for n in ast.walk(fn)
                if isinstance(n, ast.Call)
                and dotted_name(n.func) in ("LRU", "incremental.LRU")
                and n.args
                and _is_const_str(n.args[0])
            ]
            if made and any(isinstance(n, ast.Return) and n.value is not None for n in ast.walk(fn)):
                reg.factories[fn.name] = ContainerSpec(made[0])
    return reg


def _factory_locals(an: "Analyzer", fn: "FnInfo") -> Dict[str, Tuple[ContainerSpec, ast.Call]]:
    """Locals of ``fn`` assigned from a container factory's call → (the
    container, owner-scoped: the factory's arguments pick the instance and
    so witness every entry in it; the call)."""
    out: Dict[str, Tuple[ContainerSpec, ast.Call]] = {}
    if not an.registry.factories:
        return out
    for node in ast.walk(fn.node):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
        ):
            spec = an.registry.factories.get(dotted_name(node.value.func).split(".")[-1])
            if spec is not None:
                out[node.targets[0].id] = (ContainerSpec(spec.name, owner_scoped=True), node.value)
    return out


# skip cache-plumbing scopes: the containers' own implementation
# (SkeletonPlane is the fleet content plane's accessor pair — its
# call sites in solver._pack_and_finalize are the analyzed sites,
# exactly like WarmState's seeds_get/seeds_put)
_PLUMBING_CLASSES = {"LRU", "CacheStats", "WarmState", "SkeletonPlane"}
_PLUMBING_FNS = {"warm_state_for", "reset", "cache_cap", "enabled"}

# tenant-scoped caches: their validity guards are PER-OBJECT
# generation counters (a cluster's informer generation, a provider's
# catalog generation), so the key must also witness WHICH tenant's
# object the guard belongs to — equal counter values from two tenants'
# objects witness nothing about each other, and a key without the
# tenant component would serve one tenant's entries to another.
_TENANT_SCOPED_SPECS = {"seeds", "fleetenv"}
_TENANT_WITNESS_SEGMENTS = {"_tenant_scope", "tenant_id", "tenant"}


def _own_nodes(fn: ast.AST):
    """Walk a function's own statements/expressions, NOT descending into
    nested functions/lambdas/classes (their locals are a separate scope
    and their bodies run at call time)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


# ---------------------------------------------------------------------------
# per-function dataflow scope


class Scope:
    """Function-local def-use environment with path substitution."""

    def __init__(self, analyzer: "Analyzer", fn: FnInfo):
        self.analyzer = analyzer
        self.fn = fn
        node = fn.node
        a = node.args
        self.params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            self.params.append(a.vararg.arg)
        if a.kwarg:
            self.params.append(a.kwarg.arg)
        self.assigns: Dict[str, List[ast.AST]] = {}
        # values flowing INTO a container (x[k] = v, x.append(v)): part
        # of the container's dataflow but NOT a rebinding of the name —
        # kept apart so receiver alias-chasing stays sound
        self.elem_assigns: Dict[str, List[ast.AST]] = {}
        # (self, X) attribute assignments within this function
        self.attr_assigns: Dict[Tuple[str, str], List[ast.AST]] = {}
        # name -> (iterable expr, extra wildcard) loop/with bindings
        self.loop_binds: Dict[str, Tuple[ast.AST, bool]] = {}
        # names provably bound to pure indices (enumerate counters):
        # free-path-less by construction
        self.void: Set[str] = set()
        self._collect(node)

    def _bind_target(self, t: ast.AST, value: Optional[ast.AST]) -> None:
        if isinstance(t, ast.Name):
            if value is not None:
                self.assigns.setdefault(t.id, []).append(value)
        elif isinstance(t, ast.Subscript):
            # keys[i] = v: v flows into the container
            base = t.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and value is not None:
                self.elem_assigns.setdefault(base.id, []).append(value)
        elif isinstance(t, (ast.Tuple, ast.List)) and value is not None:
            if isinstance(value, ast.Tuple) and len(value.elts) == len(t.elts):
                for sub, v in zip(t.elts, value.elts):
                    self._bind_target(sub, v)
            elif (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "zip"
                and len(value.args) == len(t.elts)
            ):
                for sub, v in zip(t.elts, value.args):
                    if isinstance(sub, ast.Name):
                        self.loop_binds[sub.id] = (v, True)
                    else:
                        self._bind_target(sub, v)
            elif (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "enumerate"
                and value.args
                and len(t.elts) == 2
            ):
                # index binds to nothing; element to the container
                if isinstance(t.elts[0], ast.Name):
                    self.void.add(t.elts[0].id)
                if isinstance(t.elts[1], ast.Name):
                    self.loop_binds[t.elts[1].id] = (value.args[0], True)
                else:
                    self._bind_target(t.elts[1], value.args[0])
            else:
                for sub in t.elts:
                    if isinstance(sub, ast.Name):
                        self.loop_binds[sub.id] = (value, True)
        elif isinstance(t, ast.Attribute):
            if (
                isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and value is not None
            ):
                self.attr_assigns.setdefault(("self", t.attr), []).append(value)

    def _collect(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested scopes don't rebind ours
            if isinstance(child, ast.ClassDef):
                continue
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    self._bind_target(t, child.value)
            elif isinstance(child, ast.AnnAssign) and child.value is not None:
                self._bind_target(child.target, child.value)
            elif isinstance(child, ast.AugAssign):
                self._bind_target(child.target, child.value)
            elif isinstance(child, ast.For):
                self._bind_loop(child.target, child.iter)
            elif isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    if item.optional_vars is not None:
                        self._bind_target(item.optional_vars, item.context_expr)
            elif isinstance(child, ast.Expr) and isinstance(child.value, ast.Call):
                call = child.value
                f = call.func
                if isinstance(f, ast.Attribute) and f.attr in (
                    "append",
                    "add",
                    "extend",
                    "appendleft",
                    "insert",
                ):
                    if isinstance(f.value, ast.Name):
                        for arg in call.args:
                            self.elem_assigns.setdefault(f.value.id, []).append(arg)
            if isinstance(child, ast.NamedExpr):
                self._bind_target(child.target, child.value)
            self._collect(child)

    def _bind_loop(self, target: ast.AST, it: ast.AST) -> None:
        if (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id == "range"
        ):
            for t in ast.walk(target):
                if isinstance(t, ast.Name):
                    self.void.add(t.id)
            return
        if isinstance(target, ast.Name):
            self.loop_binds[target.id] = (it, True)
        else:
            self._bind_target(target, it)


# ---------------------------------------------------------------------------
# free-path extraction


class Analyzer:
    """Shared cross-file machinery for the three cachesound rules."""

    def __init__(self, pctx: ProjectContext):
        self.pctx = pctx
        self.modules: Dict[str, ModuleInfo] = {}
        files = pctx.matching(pctx.config.cache_modules)
        extra = pctx.matching(
            tuple(pctx.config.state_modules)
            + tuple(pctx.config.provider_modules)
            + tuple(pctx.config.cluster_consumer_modules)
        )
        seen = set()
        self.cache_files: List[FileContext] = []
        for f in files:
            if f.relpath not in seen:
                seen.add(f.relpath)
                self.cache_files.append(f)
                self.modules[f.relpath] = _index_module(f)
        for f in extra:
            if f.relpath not in seen:
                seen.add(f.relpath)
                self.modules[f.relpath] = _index_module(f)
        self.registry = _build_registry(self.cache_files)
        self._scopes: Dict[int, Scope] = {}
        self._free_memo: Dict[tuple, Tuple[Set[Path], Set[Path]]] = {}
        # key mode: witness extraction UNDER-approximates — a subscript
        # index's own provenance (``groups[gi]`` with gi from a cache-
        # state-derived list) selects an element but is not key content;
        # folding it in would let cache state witness keys, masking
        # dropped components. Reads keep the index paths (over-approx is
        # the safe direction for the read-set).
        self._key_mode = False
        # cycle-guard bookkeeping: a memo entry records the guard keys
        # that fired while computing it; the entry is valid exactly when
        # those guards would fire again (fired ⊆ current visiting), so
        # cyclic chains stay correct without poisoning the memo
        self._fired_stack: List[set] = []
        self._name_memo: Dict[tuple, tuple] = {}
        # comprehension overlays rebind names temporarily: memo entries
        # carry the active overlay stack (comp node ids) so a resolution
        # under overlay bindings is cached for — and only served back to
        # — the same comprehension context
        self._overlay_token: tuple = ()
        self._callee_memo: Dict[tuple, tuple] = {}
        self._fn_size: Dict[int, int] = {}

    def scope_for(self, fn: FnInfo) -> Scope:
        s = self._scopes.get(id(fn.node))
        if s is None:
            s = Scope(self, fn)
            self._scopes[id(fn.node)] = s
        return s

    def module_of(self, fn: FnInfo) -> ModuleInfo:
        return self.modules[fn.ctx.relpath]

    # -- call resolution -------------------------------------------------

    def resolve_call(self, call: ast.Call, fn: FnInfo) -> Optional[FnInfo]:
        f = call.func
        mi = self.module_of(fn)
        if isinstance(f, ast.Name):
            if f.id in mi.functions:
                return mi.functions[f.id]
            tgt = mi.from_imports.get(f.id)
            if tgt is not None:
                tmi = self.modules.get(tgt[0])
                if tmi is not None:
                    return tmi.functions.get(tgt[1])
            return None
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name):
                if f.value.id in ("self", "cls") and fn.cls is not None:
                    ci = mi.classes.get(fn.cls)
                    if ci is not None:
                        return ci.methods.get(f.attr)
                mod_rel = mi.imports.get(f.value.id)
                if mod_rel is not None:
                    tmi = self.modules.get(mod_rel)
                    if tmi is not None:
                        return tmi.functions.get(f.attr)
        return None

    def resolve_property(self, base: str, attr: str, fn: FnInfo) -> Optional[FnInfo]:
        if base != "self" or fn.cls is None:
            return None
        ci = self.module_of(fn).classes.get(fn.cls)
        if ci is not None and attr in ci.properties:
            return ci.methods.get(attr)
        return None

    # -- free paths ------------------------------------------------------
    #
    # Two-set model: ``objs`` are paths that still denote the object a
    # name is bound to (attribute/subscript suffixes remain meaningful:
    # ``m -> merged[*]`` means ``m["enc"] -> merged[*].enc``). ``derived``
    # are reads that merely fed the value's construction (a constructor
    # argument, an arithmetic operand) — suffixing them would invent
    # paths that don't exist (``b = Bucket(solver); b.k`` is NOT
    # ``solver.k``).

    def free(self, expr: ast.AST, fn: FnInfo, depth: int = 0) -> Set[Path]:
        o, d = self._split(expr, fn, depth, frozenset())
        return o | d

    def _free(
        self, expr: ast.AST, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Set[Path]:
        o, d = self._split(expr, fn, depth, visiting)
        return o | d

    def free_key(self, expr: ast.AST, fn: FnInfo) -> Set[Path]:
        """Witness-side extraction (key mode: no index provenance)."""
        saved = self._key_mode
        self._key_mode = True
        try:
            return self.free(expr, fn)
        finally:
            self._key_mode = saved

    def _split(
        self, expr: ast.AST, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Tuple[Set[Path], Set[Path]]:
        key = (id(expr), id(fn.node), depth, self._key_mode, self._overlay_token)
        hit = self._memo_get(self._free_memo, key, visiting)
        if hit is not None:
            return hit
        self._fired_stack.append(set())
        try:
            out = self._split_uncached(expr, fn, depth, visiting)
        finally:
            fired = self._fired_stack.pop()
        self._memo_put(self._free_memo, key, out, fired)
        return out

    def _memo_get(self, memo: dict, key: tuple, visiting: frozenset):
        hit = memo.get(key)
        if hit is None:
            return None
        out, fired = hit
        if not fired <= visiting:
            return None  # different cycle context: recompute
        if fired and self._fired_stack:
            self._fired_stack[-1] |= fired
        return out

    def _memo_put(self, memo: dict, key: tuple, out, fired: set) -> None:
        memo[key] = (out, frozenset(fired))
        if fired and self._fired_stack:
            self._fired_stack[-1] |= fired

    def _guard_fired(self, vkey) -> None:
        if self._fired_stack:
            self._fired_stack[-1].add(vkey)

    def _name_split(
        self, name: str, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Tuple[Set[Path], Set[Path]]:
        mkey = (id(fn.node), name, depth, self._key_mode, self._overlay_token)
        hit = self._memo_get(self._name_memo, mkey, visiting)
        if hit is not None:
            return hit
        self._fired_stack.append(set())
        try:
            out = self._name_split_uncached(name, fn, depth, visiting)
        finally:
            fired = self._fired_stack.pop()
        fired.discard((id(fn.node), name))  # own cycle: fixpoint reached
        self._memo_put(self._name_memo, mkey, out, fired)
        return out

    def _name_split_uncached(
        self, name: str, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Tuple[Set[Path], Set[Path]]:
        none: Set[Path] = set()
        if name in _PURE_BUILTINS or name == "cls":
            return none, none
        if name == "self":
            return {("self",)}, none
        mi = self.module_of(fn)
        if name in mi.imports or name in ("tracer",):
            return none, none
        scope = self.scope_for(fn)
        if name in scope.void:
            return none, none
        vkey = (id(fn.node), name)
        if vkey in visiting:
            self._guard_fired(vkey)
            return none, none
        visiting = visiting | {vkey}
        objs: Set[Path] = set()
        derived: Set[Path] = set()
        resolved = False
        if name in scope.params:
            # the identity path dominates: element-writes into a param
            # (m["zone"] = ...) don't dissolve the object into the
            # written values
            return {(name,)}, none
        if name in scope.loop_binds:
            it, wild = scope.loop_binds[name]
            o, d = self._split(it, fn, depth, visiting)
            objs |= {p + ((_WILD,) if wild else ()) for p in o}
            derived |= d
            resolved = True
        if name in scope.assigns:
            for v in scope.assigns[name]:
                o, d = self._split(v, fn, depth, visiting)
                objs |= o
                derived |= d
            resolved = True
        if name in scope.elem_assigns:
            for v in scope.elem_assigns[name]:
                o, d = self._split(v, fn, depth, visiting)
                objs |= o
                derived |= d
            resolved = True
        if resolved:
            return objs, derived
        if name in mi.functions or name in mi.classes or name in mi.from_imports:
            return none, none
        if name in mi.globals_caps:
            return none, none  # process config, stable for the process
        return {(name,)}, none

    def _chain(self, expr: ast.AST) -> Optional[Tuple[str, Path]]:
        """(base name, suffix path) for Name/Attribute/const-Subscript
        chains, else None."""
        full = self._chain_full(expr)
        return None if full is None else (full[0], full[1])

    def _chain_full(
        self, expr: ast.AST
    ) -> Optional[Tuple[str, Path, List[ast.AST]]]:
        """Like ``_chain`` plus the non-constant index expressions met
        along the spine (their reads are selection provenance)."""
        parts: List[str] = []
        indices: List[ast.AST] = []
        node = expr
        while True:
            if isinstance(node, ast.Attribute):
                parts.append(node.attr)
                node = node.value
            elif isinstance(node, ast.Subscript):
                c = node.slice
                if isinstance(c, ast.Constant) and isinstance(c.value, (str, int)):
                    parts.append(str(c.value))
                else:
                    parts.append(_WILD)
                    indices.append(c)
                node = node.value
            elif isinstance(node, ast.Name):
                return node.id, tuple(reversed(parts)), indices
            else:
                return None

    # constructors that hand back (a view of) their first argument:
    # suffixes on the result still address the argument's content
    _COPY_CALLS = {"dict", "list", "tuple", "sorted", "reversed"}

    def _split_uncached(
        self, expr: ast.AST, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Tuple[Set[Path], Set[Path]]:
        none: Set[Path] = set()
        if expr is None or isinstance(expr, ast.Constant):
            return none, none
        if isinstance(expr, ast.Name):
            return self._name_split(expr.id, fn, depth, visiting)
        if isinstance(expr, ast.Starred):
            return self._split(expr.value, fn, depth, visiting)
        if isinstance(expr, (ast.Attribute, ast.Subscript)):
            chain = self._chain_full(expr)
            if chain is not None:
                base, suffix, indices = chain
                # property inlining: self.<prop> resolves to its body
                if base == "self" and suffix:
                    prop = self.resolve_property(base, suffix[0], fn)
                    if prop is not None and depth < _INLINE_DEPTH:
                        body = self._callee_free(prop, depth + 1, visiting)
                        mapped = self._map_paths(
                            body, prop, [], {}, ("self",), fn, depth, visiting
                        )
                        return none, ({p + suffix[1:] for p in mapped} or mapped)
                    # self-attr assigned in this function: substitute
                    scope = self.scope_for(fn)
                    akey = ("self", suffix[0])
                    if akey in scope.attr_assigns:
                        vkey = (id(fn.node), "attr:" + suffix[0])
                        if vkey in visiting:
                            self._guard_fired(vkey)
                        if vkey not in visiting:
                            v2 = visiting | {vkey}
                            objs: Set[Path] = set()
                            derived: Set[Path] = set()
                            for v in scope.attr_assigns[akey]:
                                o, d = self._split(v, fn, depth, v2)
                                objs |= {p + suffix[1:] for p in o}
                                derived |= d
                            if objs or derived:
                                return objs, derived
                o, d = self._name_split(base, fn, depth, visiting)
                objs = {bp + suffix for bp in o}
                derived = set(d)
                # non-const subscript indices contribute their own reads
                # (suppressed in key mode — selection, not key content)
                if not self._key_mode:
                    for idx in indices:
                        derived |= self._free(idx, fn, depth, visiting)
                return objs, derived
            # complex base (call result etc.): suffixes don't survive
            derived = set()
            for child in ast.iter_child_nodes(expr):
                derived |= self._free(child, fn, depth, visiting)
            return none, derived
        if isinstance(expr, ast.Call):
            return self._call_split(expr, fn, depth, visiting)
        if isinstance(expr, (ast.Tuple, ast.List)):
            objs, derived = set(), set()
            for e in expr.elts:
                o, d = self._split(e, fn, depth, visiting)
                objs |= o
                derived |= d
            return objs, derived
        if isinstance(expr, ast.BoolOp):
            objs, derived = set(), set()
            for e in expr.values:
                o, d = self._split(e, fn, depth, visiting)
                objs |= o
                derived |= d
            return objs, derived
        if isinstance(expr, ast.IfExp):
            o1, d1 = self._split(expr.body, fn, depth, visiting)
            o2, d2 = self._split(expr.orelse, fn, depth, visiting)
            d = d1 | d2
            if not self._key_mode:  # the test selects a branch, it is
                d |= self._free(expr.test, fn, depth, visiting)  # not key content
            return o1 | o2, d
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            return self._comp_split(expr, fn, depth, visiting)
        if isinstance(expr, (ast.SetComp, ast.DictComp)):
            o, d = self._comp_split(expr, fn, depth, visiting)
            return none, o | d  # unordered containers: nothing addressable
        if isinstance(expr, ast.Lambda):
            return none, none
        derived = set()
        for child in ast.iter_child_nodes(expr):
            derived |= self._free(child, fn, depth, visiting)
        return none, derived

    def _comp_split(
        self, expr: ast.AST, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Tuple[Set[Path], Set[Path]]:
        # overlay the generator bindings on a shallow scope copy
        scope = self.scope_for(fn)
        saved_loop = dict(scope.loop_binds)
        saved_assigns = {k: list(v) for k, v in scope.assigns.items()}
        saved_elems = {k: list(v) for k, v in scope.elem_assigns.items()}
        saved_void = set(scope.void)
        self._overlay_token = self._overlay_token + (id(expr),)
        try:
            for gen in expr.generators:
                scope._bind_loop(gen.target, gen.iter)
            objs: Set[Path] = set()
            derived: Set[Path] = set()
            elts = (
                [expr.key, expr.value]
                if isinstance(expr, ast.DictComp)
                else [expr.elt]
            )
            for e in elts:
                o, d = self._split(e, fn, depth, visiting)
                objs |= o
                derived |= d
            for gen in expr.generators:
                derived |= self._free(gen.iter, fn, depth, visiting)
                for cond in gen.ifs:
                    derived |= self._free(cond, fn, depth, visiting)
            return objs, derived
        finally:
            self._overlay_token = self._overlay_token[:-1]
            scope.loop_binds = saved_loop
            scope.assigns = saved_assigns
            scope.elem_assigns = saved_elems
            scope.void = saved_void

    def _call_split(
        self, call: ast.Call, fn: FnInfo, depth: int, visiting: frozenset
    ) -> Tuple[Set[Path], Set[Path]]:
        none: Set[Path] = set()
        f = call.func
        # a read from a registered container is cache plumbing, not input
        if isinstance(f, ast.Attribute) and f.attr in ("get",):
            recv = self._receiver_path(f.value, fn)
            if self.registry.for_receiver(recv) is not None:
                return none, none
        # getattr(self, "x", d) -> self.x plus default reads
        if (
            isinstance(f, ast.Name)
            and f.id == "getattr"
            and len(call.args) >= 2
            and _is_const_str(call.args[1]) is not None
        ):
            o, d = self._split(call.args[0], fn, depth, visiting)
            objs = {bp + (_is_const_str(call.args[1]),) for bp in o}
            for extra in call.args[2:]:
                d |= self._free(extra, fn, depth, visiting)
            return objs, d
        # copy-shaped constructors keep the first argument addressable
        if (
            isinstance(f, ast.Name)
            and f.id in self._COPY_CALLS
            and call.args
        ):
            o, d = self._split(call.args[0], fn, depth, visiting)
            for extra in call.args[1:]:
                d |= self._free(extra, fn, depth, visiting)
            for k in call.keywords:
                d |= self._free(k.value, fn, depth, visiting)
            return o, d
        if isinstance(f, ast.Attribute) and f.attr == "copy" and not call.args:
            return self._split(f.value, fn, depth, visiting)
        target = self.resolve_call(call, fn)
        if target is not None and depth < _INLINE_DEPTH:
            body = self._callee_free(target, depth + 1, visiting)
            recv: Optional[Path] = ("self",)
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                if f.value.id not in ("self", "cls"):
                    # module-function via alias: no receiver
                    recv = None
            elif isinstance(f, ast.Name):
                recv = None
            kw = {k.arg: k.value for k in call.keywords if k.arg}
            return none, self._map_paths(
                body, target, list(call.args), kw, recv, fn, depth, visiting
            )
        derived: Set[Path] = set()
        for a in call.args:
            if isinstance(a, ast.Starred):
                a = a.value
            derived |= self._free(a, fn, depth, visiting)
        for k in call.keywords:
            derived |= self._free(k.value, fn, depth, visiting)
        if isinstance(f, ast.Attribute):
            derived |= self._free(f.value, fn, depth, visiting)
        return none, derived

    def _receiver_path(self, expr: ast.AST, fn: FnInfo) -> Optional[Path]:
        """Resolved path of a container receiver, chasing single local
        aliases (``sr = e.sig_rows``)."""
        chain = self._chain(expr)
        if chain is None:
            return None
        base, suffix = chain
        scope = self.scope_for(fn)
        hops = 0
        while (
            not suffix
            and base in scope.assigns
            and len(scope.assigns[base]) == 1
            and hops < 4
        ):
            nxt = self._chain(scope.assigns[base][0])
            if nxt is None:
                break
            base, suffix = nxt[0], nxt[1] + suffix
            hops += 1
        if base in scope.loop_binds and not suffix:
            it, _ = scope.loop_binds[base]
            nxt = self._chain(it)
            if nxt is not None:
                base, suffix = nxt[0], nxt[1] + (_WILD,) + suffix
        return (base,) + suffix

    def _callee_free(
        self, target: FnInfo, depth: int, visiting: frozenset
    ) -> Set[Path]:
        """Free paths of a callee's result: the backward slice of its
        return expressions, or (for procedures) of its whole body."""
        vkey = (id(target.node), "<fn>")
        if vkey in visiting:
            self._guard_fired(vkey)
            return set()
        mkey = (id(target.node), depth, self._key_mode, self._overlay_token)
        hit = self._memo_get(self._callee_memo, mkey, visiting)
        if hit is not None:
            return hit
        self._fired_stack.append(set())
        try:
            out = self._callee_free_uncached(target, depth, visiting | {vkey})
        finally:
            fired = self._fired_stack.pop()
        fired.discard(vkey)  # our own guard key is satisfied by entry
        self._memo_put(self._callee_memo, mkey, out, fired)
        return out

    def _callee_free_uncached(
        self, target: FnInfo, depth: int, visiting: frozenset
    ) -> Set[Path]:
        node = target.node
        stmts = self._fn_size.get(id(node))
        if stmts is None:
            stmts = sum(1 for _ in ast.walk(node))
            self._fn_size[id(node)] = stmts
        if stmts > _INLINE_STMT_CAP * 4:
            # too big to model: reads ~= its parameters
            scope = self.scope_for(target)
            return {(p,) for p in scope.params}
        own = list(_own_nodes(node))
        returns = [
            n.value
            for n in own
            if isinstance(n, ast.Return) and n.value is not None
        ]
        out: Set[Path] = set()
        if returns:
            for r in returns:
                out |= self._free(r, target, depth, visiting)
        else:
            # procedures: every expression statement / call argument
            for stmt in own:
                if isinstance(stmt, ast.Expr):
                    out |= self._free(stmt.value, target, depth, visiting)
                elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    v = stmt.value
                    if v is not None:
                        out |= self._free(v, target, depth, visiting)
                elif isinstance(stmt, (ast.If, ast.While)):
                    out |= self._free(stmt.test, target, depth, visiting)
                elif isinstance(stmt, ast.For):
                    out |= self._free(stmt.iter, target, depth, visiting)
        return out

    def _map_paths(
        self,
        body: Set[Path],
        target: FnInfo,
        args: List[ast.AST],
        kwargs: Dict[str, ast.AST],
        recv: Optional[Path],
        fn: FnInfo,
        depth: int,
        visiting: frozenset,
    ) -> Set[Path]:
        """Substitute a callee's formal-rooted paths with caller argument
        paths; ``self``-rooted paths map onto the receiver."""
        node = target.node
        a = node.args
        pos = [p.arg for p in a.posonlyargs + a.args]
        is_method = target.cls is not None and pos and pos[0] in ("self", "cls")
        formals = pos[1:] if is_method else pos
        actual: Dict[str, ast.AST] = {}
        for name, arg in zip(formals, args):
            if isinstance(arg, ast.Starred):
                continue
            actual[name] = arg
        actual.update({k: v for k, v in kwargs.items() if k in set(pos)})
        out: Set[Path] = set()
        for p in body:
            root = p[0]
            if root in ("self", "cls") and is_method:
                if recv is not None:
                    out.add(recv + p[1:] if recv != ("self",) else p)
                continue
            if root in actual:
                for bp in self._free(actual[root], fn, depth, visiting):
                    out.add(bp + p[1:])
                continue
            if root in [x.arg for x in a.kwonlyargs] and root in kwargs:
                for bp in self._free(kwargs[root], fn, depth, visiting):
                    out.add(bp + p[1:])
                continue
            if root in formals or root in [x.arg for x in a.kwonlyargs]:
                continue  # unbound formal (default): no caller reads
            tmi = self.modules.get(target.ctx.relpath)
            if tmi is not None and root in tmi.globals_caps:
                continue
            out.add(p)  # callee-module global
        return out


# ---------------------------------------------------------------------------
# memo-site detection


@dataclass
class CacheEvent:
    kind: str  # 'get' | 'put'
    spec: ContainerSpec
    fn: FnInfo  # host function (after lifting)
    line: int  # line in the host function (marker anchor)
    key_exprs: List[ast.AST] = field(default_factory=list)
    value_exprs: List[ast.AST] = field(default_factory=list)
    guard_exprs: List[ast.AST] = field(default_factory=list)
    owner_expr: Optional[ast.AST] = None
    origin: Optional[int] = None  # helper fn id for lifted events


@dataclass
class Site:
    spec: ContainerSpec
    fn: FnInfo
    gets: List[CacheEvent]
    puts: List[CacheEvent]


def _fn_events(an: Analyzer, fn: FnInfo) -> List[CacheEvent]:
    """Raw get/put events on registered containers inside ``fn``."""
    out: List[CacheEvent] = []
    made = _factory_locals(an, fn)
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in ("get", "put", "setdefault"):
                recv = an._receiver_path(node.func.value, fn)
                spec = an.registry.for_receiver(recv)
                owner = node.func.value
                if spec is None and isinstance(node.func.value, ast.Name) and node.func.value.id in made:
                    spec, owner = made[node.func.value.id]
                if spec is not None and node.args:
                    ev = CacheEvent(
                        "get" if attr == "get" else "put",
                        spec,
                        fn,
                        node.lineno,
                        key_exprs=[node.args[0]],
                        owner_expr=owner,
                    )
                    if attr in ("put", "setdefault") and len(node.args) > 1:
                        ev.value_exprs = [node.args[1]]
                    out.append(ev)
                # pod-memo convention: d.get("_karp_memo")
                elif (
                    attr == "get"
                    and node.args
                    and _is_const_str(node.args[0]) == "_karp_memo"
                ):
                    out.append(
                        CacheEvent(
                            "get",
                            _PODMEMO_SPEC,
                            fn,
                            node.lineno,
                            key_exprs=[],
                            owner_expr=node.func.value,
                        )
                    )
            elif attr in ("seeds_get", "seeds_put") and node.args:
                spec = ContainerSpec("seeds")
                ev = CacheEvent(
                    "get" if attr == "seeds_get" else "put",
                    spec,
                    fn,
                    node.lineno,
                    key_exprs=[node.args[0]],
                )
                if len(node.args) > 1:
                    ev.guard_exprs = [node.args[1]]
                if attr == "seeds_put" and len(node.args) > 2:
                    ev.value_exprs = [node.args[2]]
                out.append(ev)
            elif attr in ("skeleton_get", "skeleton_put") and node.args:
                # fleet content plane accessor pair (fleet/megasolve.py
                # SkeletonPlane): key arg 0, stored skeleton arg 1
                spec = ContainerSpec("fleetjob")
                ev = CacheEvent(
                    "get" if attr == "skeleton_get" else "put",
                    spec,
                    fn,
                    node.lineno,
                    key_exprs=[node.args[0]],
                )
                if attr == "skeleton_put" and len(node.args) > 1:
                    ev.value_exprs = [node.args[1]]
                out.append(ev)
        elif isinstance(node, ast.Assign) and isinstance(
            node.targets[0], ast.Subscript
        ):
            tgt = node.targets[0]
            recv = an._receiver_path(tgt.value, fn)
            spec = an.registry.for_receiver(recv)
            if spec is not None:
                out.append(
                    CacheEvent(
                        "put",
                        spec,
                        fn,
                        node.lineno,
                        key_exprs=[tgt.slice],
                        value_exprs=[node.value],
                        owner_expr=tgt.value,
                    )
                )
            elif _is_const_str(tgt.slice) == "_karp_memo":
                out.append(
                    CacheEvent(
                        "put",
                        _PODMEMO_SPEC,
                        fn,
                        node.lineno,
                        key_exprs=[],
                        value_exprs=[node.value],
                        owner_expr=tgt.value,
                    )
                )
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            recv = an._receiver_path(node.value, fn)
            spec = an.registry.for_receiver(recv)
            if spec is not None:
                out.append(
                    CacheEvent(
                        "get",
                        spec,
                        fn,
                        node.lineno,
                        key_exprs=[node.slice],
                        owner_expr=node.value,
                    )
                )
    return out


_PODMEMO_SPEC = ContainerSpec("podmemo", owner_scoped=True)


def _skip_fn(fn: FnInfo) -> bool:
    if fn.cls in _PLUMBING_CLASSES:
        return True
    if fn.cls is None and fn.name in _PLUMBING_FNS:
        return True
    return False


def _lift_events(an: Analyzer) -> Dict[Tuple[int, str], Site]:
    """Collect events per function, then lift events out of put-helper
    functions into their callers (``_cache_put``, ``_sig_rows_put``,
    ``_cache_compat_rows`` — any function whose cache events root at its
    own formals), so split sites pair up where the real inputs live."""
    raw: Dict[int, List[CacheEvent]] = {}
    fns: Dict[int, FnInfo] = {}
    for mi in an.modules.values():
        for fi in list(mi.functions.values()) + [
            m for c in mi.classes.values() for m in c.methods.values()
        ]:
            if fi.ctx.relpath not in {f.relpath for f in an.cache_files}:
                continue
            if _skip_fn(fi):
                continue
            fns[id(fi.node)] = fi
            evs = _fn_events(an, fi)
            if evs:
                raw[id(fi.node)] = evs

    def formal_rooted(ev: CacheEvent, fi: FnInfo) -> Optional[Set[str]]:
        """The set of formals an event's key+value read — or None when
        the event also reads non-formal state (not liftable)."""
        scope = an.scope_for(fi)
        roots: Set[str] = set()
        for e in ev.key_exprs + ev.value_exprs + (
            [ev.owner_expr] if ev.owner_expr is not None else []
        ):
            for p in an.free(e, fi):
                r = p[0]
                if r in scope.params and r not in ("self", "cls"):
                    roots.add(r)
                elif r in ("self", "cls"):
                    return None
                else:
                    return None
        return roots

    def classify_helpers() -> Dict[int, List[CacheEvent]]:
        """Put-helper functions: every cache event is a put whose key,
        value and owner root at the function's own formals — callers own
        the real inputs, so the events lift to the call sites."""
        out: Dict[int, List[CacheEvent]] = {}
        for fid, evs in raw.items():
            fi = fns[fid]
            if all(
                ev.kind == "put" and formal_rooted(ev, fi) is not None
                for ev in evs
            ):
                out[fid] = evs
        return out

    helpers: Dict[int, List[CacheEvent]] = {}

    def lift_into_callers(rounds: int) -> None:
        nonlocal helpers
        for _ in range(rounds):
            helpers = classify_helpers()
            changed = False
            for fid, fi in fns.items():
                if fid in helpers:
                    continue  # a helper's own call sites lift elsewhere
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    target = an.resolve_call(node, fi)
                    if target is None or id(target.node) not in helpers:
                        continue
                    if id(target.node) == fid:
                        continue
                    # substitute each helper event's exprs with caller args
                    a = target.node.args
                    pos = [p.arg for p in a.posonlyargs + a.args]
                    is_method = target.cls is not None and pos[:1] == ["self"]
                    formals = pos[1:] if is_method else pos
                    amap = dict(zip(formals, node.args))
                    amap.update(
                        {k.arg: k.value for k in node.keywords if k.arg in formals}
                    )
                    for ev in helpers[id(target.node)]:
                        lifted = CacheEvent(
                            ev.kind,
                            ev.spec,
                            fi,
                            node.lineno,
                            origin=ev.origin or id(target.node),
                        )
                        for bucket, src, extract in (
                            (lifted.key_exprs, ev.key_exprs, an.free_key),
                            (lifted.value_exprs, ev.value_exprs, an.free),
                        ):
                            for e in src:
                                roots = {
                                    p[0]
                                    for p in extract(e, target)
                                    if p[0] in formals
                                }
                                for r in sorted(roots):
                                    if r in amap:
                                        bucket.append(amap[r])
                        if ev.owner_expr is not None:
                            o = an._chain(ev.owner_expr)
                            if o is not None and o[0] in amap:
                                lifted.owner_expr = amap[o[0]]
                        key = id(fi.node)
                        evs2 = raw.setdefault(key, [])
                        marker = (ev.spec.name, node.lineno, ev.kind)
                        if not any(
                            (e2.spec.name, e2.line, e2.kind) == marker
                            for e2 in evs2
                        ):
                            evs2.append(lifted)
                            changed = True
            if not changed:
                return

    lift_into_callers(_INLINE_DEPTH)

    sites: Dict[Tuple[int, str], Site] = {}
    for fid, evs in raw.items():
        if fid in helpers:
            continue  # analyzed at the lifted site
        fi = fns[fid]
        by_spec: Dict[str, List[CacheEvent]] = {}
        for ev in evs:
            by_spec.setdefault(ev.spec.name, []).append(ev)
        for cname, group in by_spec.items():
            puts = [e for e in group if e.kind == "put"]
            gets = [e for e in group if e.kind == "get"]
            if not puts:
                continue
            own_puts = [e for e in puts if e.origin is None]
            if own_puts:
                # lifted puts are a DIFFERENT code path (e.g. a replay
                # helper re-caching from a skeleton): keep them as their
                # own site so they cannot witness the main site's reads
                sites[(fid, cname)] = Site(puts[0].spec, fi, gets, own_puts)
                lifted = [e for e in puts if e.origin is not None]
                by_origin: Dict[int, List[CacheEvent]] = {}
                for e in lifted:
                    by_origin.setdefault(e.origin, []).append(e)
                for origin, group2 in by_origin.items():
                    sites[(fid, f"{cname}#{origin}")] = Site(
                        group2[0].spec, fi, [], group2
                    )
            else:
                sites[(fid, cname)] = Site(puts[0].spec, fi, gets, puts)
    return sites


# ---------------------------------------------------------------------------
# rule 1: cache-key (key-completeness)

# cache plumbing that is never a solve input
_PLUMBING_SELF_ATTRS = {"_cstats", "_warm", "_seed_cache"}
_PLUMBING_NAMES = {"stats", "tracer", "ws"}


#: analyzers reused across runs while their module set's parsed trees
#: are identical (the engine parse cache hands back the same tree object
#: for an unchanged file, so tree identity IS content identity) — the
#: mutation harness and the tier-1 meta-tests re-analyze near-identical
#: sets dozens of times
_ANALYZERS: Dict[frozenset, Analyzer] = {}


def _shared_analyzer(pctx: ProjectContext) -> Analyzer:
    an = getattr(pctx, "_cachesound", None)
    if an is not None:
        return an
    cfg = pctx.config
    probe = pctx.matching(
        tuple(cfg.cache_modules)
        + tuple(cfg.state_modules)
        + tuple(cfg.provider_modules)
        + tuple(cfg.cluster_consumer_modules)
    )
    key = frozenset((f.relpath, id(f.tree)) for f in probe)
    an = _ANALYZERS.get(key)
    if an is None:
        an = Analyzer(pctx)
        if len(_ANALYZERS) >= 8:
            _ANALYZERS.clear()
        _ANALYZERS[key] = an
    pctx._cachesound = an
    return an


def _shared_sites(an: Analyzer) -> Dict[Tuple[int, str], Site]:
    sites = getattr(an, "_sites", None)
    if sites is None:
        sites = _lift_events(an)
        an._sites = sites
    return sites


def _marker_exclusions(site: Site) -> List[Path]:
    out: List[Path] = []
    lines = site.fn.ctx.lines
    for ev in site.gets + site.puts:
        args = scoped_marker_args(lines, ev.line, "cache-key")
        if args:
            out.extend(parse_marker_path(a) for a in args)
    return out


def _witness_of(an: Analyzer, events: List[CacheEvent]) -> Set[Path]:
    out: Set[Path] = set()
    for ev in events:
        for e in ev.key_exprs:
            out |= an.free_key(e, ev.fn)
        for e in ev.guard_exprs:
            out |= an.free_key(e, ev.fn)
    return out


def _drop_plumbing(paths: Set[Path], receivers: Set[str]) -> Set[Path]:
    out = set()
    for p in paths:
        if not p:
            continue
        if p[0] in _BENIGN_ROOTS or p[0] in _PLUMBING_NAMES or p[0] in receivers:
            continue
        if len(p) > 1 and p[1] in _PLUMBING_SELF_ATTRS:
            continue
        out.add(p)
    return out


def _minimal(paths: Set[Path]) -> Set[Path]:
    """Shortest-prefix form: a read of ``x`` subsumes ``x.anything``."""
    out: Set[Path] = set()
    for p in sorted(paths, key=len):
        if not any(len(q) < len(p) and paths_match(q, p) for q in out):
            out.add(p)
    return out


def _check_site(an: Analyzer, site: Site) -> Iterable[Finding]:
    fn = site.fn
    receivers: Set[str] = set()
    for ev in site.gets + site.puts:
        if ev.owner_expr is not None:
            rp = an._receiver_path(ev.owner_expr, fn)
            if rp:
                receivers.add(rp[0])
    witness_get = _drop_plumbing(_witness_of(an, site.gets), receivers)
    witness_put = _drop_plumbing(_witness_of(an, site.puts), receivers)
    witness = witness_get | witness_put
    # owner-scoped containers: the owner object is a content address
    # (catalog entries, encodings, the pod itself) — its root witnesses
    # everything reachable from it
    if site.spec.owner_scoped:
        for ev in site.gets + site.puts:
            if ev.owner_expr is not None:
                for p in an.free(ev.owner_expr, fn):
                    witness.add((p[0],))
    exclusions = _marker_exclusions(site)
    put_line = max(ev.line for ev in site.puts)

    def excluded(path: Path) -> bool:
        # declared exclusions compare against the wildcard-stripped path:
        # allow-cache-key(meta.alloc) covers meta[*]["alloc"] but must not
        # swallow meta[*]["reqs"]
        squeezed = tuple(part for part in path if part != _WILD)
        return any(squeezed[: len(e)] == e for e in exclusions)

    # -- split-site key drift: get and put must witness the same roots --
    if site.gets and witness_get and witness_put:
        g_roots = {rootkey(p) for p in witness_get}
        p_roots = {rootkey(p) for p in witness_put}
        for root in sorted(g_roots ^ p_roots):
            if excluded(root):
                continue
            side = "get" if root in g_roots else "put"
            other = "put" if side == "get" else "get"
            yield Finding(
                rule="cache-key",
                path=fn.ctx.relpath,
                line=put_line,
                symbol=fn.symbol,
                message=(
                    f"cache '{site.spec.name}': key input '{render(root)}' is "
                    f"witnessed by the {side} key but not the {other} key — "
                    f"split-site key drift serves entries across a changed input"
                ),
                severity=SEV_ERROR,
            )

    # -- read-set vs witness --------------------------------------------
    reads: Set[Path] = set()
    for ev in site.puts:
        for e in ev.value_exprs:
            reads |= an.free(e, fn)
    # side effects: calls in the get..put region that share state with
    # the slice feed the cached value through mutation
    lo = min(ev.line for ev in site.gets + site.puts)
    hi = put_line
    for _ in range(2):
        roots = {rootkey(p) for p in reads}
        for node in ast.walk(fn.node):
            if (
                isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and lo <= node.lineno <= hi
            ):
                a = an.free(node.value, fn)
                if {rootkey(p) for p in a} & roots:
                    reads |= a
    reads = _minimal(_drop_plumbing(reads, receivers))

    # tenant-scope witness: generation-guarded caches that can
    # serve multiple tenants must carry the tenant scope in their key —
    # the generation guard is a per-object counter, so equal values from
    # two tenants' objects would otherwise alias their entries
    if site.spec.name in _TENANT_SCOPED_SPECS:
        raw_witness = _witness_of(an, site.gets + site.puts)
        has_tenant = any(
            seg in _TENANT_WITNESS_SEGMENTS for p in raw_witness for seg in p
        )
        if not has_tenant and not excluded(("_tenant_scope",)):
            yield Finding(
                rule="cache-key",
                path=fn.ctx.relpath,
                line=put_line,
                symbol=fn.symbol,
                message=(
                    f"cache '{site.spec.name}': key does not witness the tenant "
                    f"scope — its generation guard is a per-tenant counter, so "
                    f"equal generations from different tenants' objects would "
                    f"alias entries across tenants (add the solver's "
                    f"_tenant_scope / the tenant id to the key)"
                ),
                severity=SEV_ERROR,
            )

    # pod-memo rv guard: the stored tuple's first element must witness
    # the pod's resource_version (the memo's only validity check)
    if site.spec.name == "podmemo":
        for ev in site.puts:
            ok = False
            for e in ev.value_exprs:
                if isinstance(e, ast.Tuple) and e.elts:
                    for p in an.free(e.elts[0], fn):
                        if p and p[-1] == "resource_version":
                            ok = True
            if not ok and not excluded(("resource_version",)):
                yield Finding(
                    rule="cache-key",
                    path=fn.ctx.relpath,
                    line=ev.line,
                    symbol=fn.symbol,
                    message=(
                        "cache 'podmemo': stored memo does not witness the "
                        "pod's resource_version — in-place spec mutation "
                        "would serve a stale memo"
                    ),
                    severity=SEV_ERROR,
                )

    seen: Set[Path] = set()
    for p in sorted(reads):
        if p in seen:
            continue
        seen.add(p)
        if excluded(p):
            continue
        if any(paths_match(p, w) for w in witness):
            continue
        yield Finding(
            rule="cache-key",
            path=fn.ctx.relpath,
            line=put_line,
            symbol=fn.symbol,
            message=(
                f"cache '{site.spec.name}': input '{render(p)}' is read by the "
                f"cached computation but not witnessed by the key — add it to "
                f"the key, guard it with a generation, or declare "
                f"`# analysis: allow-cache-key({render(p)}) — <why sound>`"
            ),
            severity=SEV_ERROR,
        )


@project_rule(
    "cache-key",
    "every cross-solve memo key must witness the cached computation's read-set",
)
def check_cache_key(pctx: ProjectContext):
    an = _shared_analyzer(pctx)
    sites = _shared_sites(an)
    out: List[Finding] = []
    for _, site in sorted(sites.items(), key=lambda kv: (kv[1].fn.ctx.relpath, kv[1].fn.symbol, kv[0][1])):
        out.extend(_check_site(an, site))
    dedup: Dict[tuple, Finding] = {}
    for f in out:
        dedup.setdefault((f.path, f.symbol, f.message), f)
    yield from sorted(dedup.values(), key=lambda f: (f.path, f.line, f.message))


# ---------------------------------------------------------------------------
# rule 2: cache-invalidation (invalidation-completeness)

_WRITE_METHOD_PREFIXES = (
    "update_", "set_", "add_", "remove_", "delete_", "cleanup_", "clear",
    "mark_", "unmark_", "pop_", "insert_", "carry_",
)
_MUTATOR_CALLS = {
    "append", "extend", "insert", "pop", "popitem", "remove", "discard",
    "add", "clear", "update", "setdefault", "sort", "reverse",
    "appendleft", "popleft",
}
_EXEMPT = {"__init__", "__new__", "__post_init__"}


def _gen_fields(ci: ClassInfo, gen_method: str) -> Set[str]:
    m = ci.methods.get(gen_method)
    if m is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(m.node):
        if isinstance(node, ast.Return) and node.value is not None:
            for sub in ast.walk(node.value):
                if (
                    isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"
                ):
                    out.add(sub.attr)
    return out


def _writes_gen(an: Analyzer, m: FnInfo, gen_fields: Set[str]) -> bool:
    """A method bumps when it writes a generation field with a value
    derived from the field itself (+=, old+1 read through generation(),
    verified by dataflow) — a plain constant write is a RESET that can
    repeat past values, not a bump. Writing None is accepted: it
    deactivates the generation and hands invalidation back to content
    fingerprinting."""
    for node in ast.walk(m.node):
        tgt = None
        if isinstance(node, ast.AugAssign):
            tgt, val = node.target, node.value
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
        else:
            continue
        if not (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
            and tgt.attr in gen_fields
        ):
            continue
        if isinstance(node, ast.AugAssign):
            return True
        if isinstance(val, ast.Constant) and val.value is None:
            return True  # deactivates the generation: fingerprint resumes
        for p in an.free(val, m):
            if p[:1] == ("self",) and len(p) > 1 and p[1] in gen_fields:
                return True
    return False


def _self_calls(m: FnInfo) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(m.node):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if (
                isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
            ):
                out.add(node.func.attr)
    return out


def _fields_read(ci: ClassInfo, method: str, depth: int = 0) -> Set[str]:
    m = ci.methods.get(method)
    if m is None or depth > 2:
        return set()
    out: Set[str] = set()
    for node in ast.walk(m.node):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            if node.attr in ci.methods:
                if node.attr != method:
                    out |= _fields_read(ci, node.attr, depth + 1)
            else:
                out.add(node.attr)
    return out


@dataclass
class _MethodWrites:
    fields: Set[str] = field(default_factory=set)
    first_line: int = 0


def _method_writes(an: Analyzer, m: FnInfo, relevant: Set[str]) -> _MethodWrites:
    """Relevant fields ``m`` writes: direct stores, subscript stores,
    mutator calls, and write-shaped calls/stores through local aliases
    of relevant fields."""
    w = _MethodWrites()

    def hit(f: str, line: int) -> None:
        if f in relevant:
            w.fields.add(f)
            if not w.first_line or line < w.first_line:
                w.first_line = line

    tainted: Dict[str, str] = {}  # local name -> field it aliases
    for node in ast.walk(m.node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    roots = {
                        p[:2]
                        for p in an.free(node.value, m, depth=_INLINE_DEPTH)
                        if p[:1] == ("self",) and len(p) > 1
                    }
                    for r in roots:
                        if r[1] in relevant:
                            tainted[t.id] = r[1]
                elif isinstance(t, ast.Attribute):
                    if isinstance(t.value, ast.Name):
                        if t.value.id == "self":
                            hit(t.attr, node.lineno)
                        elif t.value.id in tainted:
                            hit(tainted[t.value.id], node.lineno)
                elif isinstance(t, ast.Subscript):
                    base = t.value
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                    ):
                        hit(base.attr, node.lineno)
                    elif isinstance(base, ast.Name) and base.id in tainted:
                        hit(tainted[base.id], node.lineno)
        elif isinstance(node, ast.AugAssign):
            t = node.target
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                hit(t.attr, node.lineno)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                sub = t
                while isinstance(sub, ast.Subscript):
                    sub = sub.value
                if (
                    isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"
                ):
                    hit(sub.attr, node.lineno)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            name = f.attr
            recv = f.value
            if name in _MUTATOR_CALLS or name.startswith(_WRITE_METHOD_PREFIXES):
                base = recv
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                    ):
                        if base.attr in relevant:
                            hit(base.attr, node.lineno)
                        base = None
                        break
                    base = base.value
                if isinstance(base, ast.Name) and base.id in tainted:
                    hit(tainted[base.id], node.lineno)
    return w


def _check_generation_class(
    an: Analyzer,
    ci: ClassInfo,
    gen_method: str,
    relevant: Set[str],
    kind: str,
) -> Iterable[Finding]:
    gen_fields = _gen_fields(ci, gen_method)
    if not gen_fields:
        return
    relevant = relevant - gen_fields
    bumpers = {
        name
        for name, m in ci.methods.items()
        if _writes_gen(an, m, gen_fields)
    }
    calls = {name: _self_calls(m) for name, m in ci.methods.items()}
    # transitive bump closure over intra-class calls
    changed = True
    while changed:
        changed = False
        for name, callees in calls.items():
            if name not in bumpers and callees & bumpers:
                bumpers.add(name)
                changed = True

    writes: Dict[str, _MethodWrites] = {}
    for name, m in ci.methods.items():
        if name in _EXEMPT or name == gen_method:
            continue
        mw = _method_writes(an, m, relevant)
        if mw.fields:
            writes[name] = mw

    # private helpers whose intra-class callers ALL bump are covered
    callers: Dict[str, List[str]] = {}
    for caller, callees in calls.items():
        for callee in callees:
            callers.setdefault(callee, []).append(caller)
    covered = set()
    changed = True
    while changed:
        changed = False
        for name in writes:
            if name in bumpers or name in covered:
                continue
            if not name.startswith("_"):
                continue
            cs = callers.get(name, [])
            if cs and all(
                c in bumpers or c in covered or c in _EXEMPT for c in cs
            ):
                covered.add(name)
                changed = True

    for name, mw in sorted(writes.items()):
        if name in bumpers or name in covered:
            continue
        m = ci.methods[name]
        fields = ", ".join(f"'{f}'" for f in sorted(mw.fields))
        yield Finding(
            rule="cache-invalidation",
            path=ci.ctx.relpath,
            line=mw.first_line or m.node.lineno,
            symbol=m.symbol,
            message=(
                f"{kind} mutator writes {fields} (observable by cross-solve "
                f"caches) without bumping {gen_method}() — a warm solve keyed "
                f"on the stale generation would replay pre-mutation state"
            ),
            severity=SEV_ERROR,
        )


@project_rule(
    "cache-invalidation",
    "informer/catalog mutators must bump the generation their caches key on",
)
def check_cache_invalidation(pctx: ProjectContext):
    an = _shared_analyzer(pctx)
    cfg = pctx.config
    # generation-relevant cluster fields = what the consumer modules
    # actually reach through the cluster API
    consumer_ctxs = pctx.matching(cfg.cluster_consumer_modules)
    api: Set[str] = set()
    for ctx in consumer_ctxs:
        for node in ctx.walk():
            if isinstance(node, ast.Attribute):
                dn = dotted_name(node)
                if dn:
                    parts = dn.split(".")
                    for i, part in enumerate(parts[:-1]):
                        if part == "cluster":
                            api.add(parts[i + 1])
    out: List[Finding] = []
    for relpath in sorted(an.modules):
        mi = an.modules[relpath]
        in_state = any(relpath.endswith(s) for s in cfg.state_modules)
        in_provider = any(relpath.endswith(s) for s in cfg.provider_modules)
        fixture = not cfg.in_package(relpath)
        if not (in_state or in_provider or fixture):
            continue
        for ci in mi.classes.values():
            if "generation" in ci.methods and (in_state or fixture):
                relevant: Set[str] = set()
                for a in api:
                    if a in ci.methods:
                        relevant |= _fields_read(ci, a)
                    else:
                        relevant.add(a)
                relevant -= {m for m in ci.methods}
                if relevant:
                    out.extend(
                        _check_generation_class(
                            an, ci, "generation", relevant, "informer-state"
                        )
                    )
            if "catalog_generation" in ci.methods and (in_provider or fixture):
                relevant = _fields_read(ci, "get_instance_types")
                relevant -= {m for m in ci.methods}
                if relevant:
                    out.extend(
                        _check_generation_class(
                            an, ci, "catalog_generation", relevant, "catalog"
                        )
                    )
    yield from sorted(out, key=lambda f: (f.path, f.line, f.message))


# ---------------------------------------------------------------------------
# rule 3: cache-determinism (key-determinism)

_NAME_CONTEXT_RE = re.compile(
    r"fingerprint|digest|signature|intern|(^|_)key(s)?($|_)"
)


def _slice_nodes(
    an: Analyzer,
    expr: ast.AST,
    fn: FnInfo,
    depth: int,
    out: List[Tuple[FnInfo, ast.AST]],
    visited: Set[int],
) -> None:
    """Syntactic slice: the expression, the assignments its names chase
    to, and (depth-limited) the bodies of resolvable key-builder calls —
    the nodes whose constructs determine the key's process stability."""
    if id(expr) in visited:
        return
    visited.add(id(expr))
    scope = an.scope_for(fn)
    for node in ast.walk(expr):
        out.append((fn, node))
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            for v in scope.assigns.get(node.id, []):
                _slice_nodes(an, v, fn, depth, out, visited)
            for v in scope.elem_assigns.get(node.id, []):
                # a tuple/list literal flowing into a container lost its
                # positions (x rode the container next to unrelated
                # values) — descending would attribute every sibling
                # element's constructs to this key
                if isinstance(v, (ast.Tuple, ast.List)):
                    continue
                _slice_nodes(an, v, fn, depth, out, visited)
            lb = scope.loop_binds.get(node.id)
            if lb is not None and not isinstance(lb[0], (ast.Tuple, ast.List)):
                _slice_nodes(an, lb[0], fn, depth, out, visited)
        elif isinstance(node, ast.Call) and depth < _INLINE_DEPTH:
            target = an.resolve_call(node, fn)
            if target is not None and id(target.node) not in visited:
                visited.add(id(target.node))
                for sub in ast.walk(target.node):
                    if isinstance(sub, ast.Return) and sub.value is not None:
                        _slice_nodes(an, sub.value, target, depth + 1, out, visited)


def _set_typed(an: Analyzer, expr: ast.AST, fn: FnInfo, hops: int = 0) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        if isinstance(f, ast.Attribute) and f.attr in (
            "intersection", "union", "difference", "symmetric_difference",
            "keys_set",
        ):
            return True
        return False
    if isinstance(expr, ast.BinOp) and isinstance(
        expr.op, (ast.BitAnd, ast.BitOr, ast.Sub)
    ):
        return _set_typed(an, expr.left, fn, hops) or _set_typed(
            an, expr.right, fn, hops
        )
    if isinstance(expr, ast.Name) and hops < 3:
        scope = an.scope_for(fn)
        vals = scope.assigns.get(expr.id, [])
        return bool(vals) and all(
            _set_typed(an, v, fn, hops + 1)
            or (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr in ("copy", "union", "intersection"))
            for v in vals
        )
    return False


def _float_evidence(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, float):
            return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Div):
            return True
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "float"
        ):
            return True
    return False


def _det_allowed(fn: FnInfo, line: int, token: str) -> bool:
    args = scoped_marker_args(fn.ctx.lines, line, "cache-determinism")
    return bool(args) and token in args


def _det_findings_for_context(
    an: Analyzer,
    nodes: List[Tuple[FnInfo, ast.AST]],
    where: str,
) -> Iterable[Finding]:
    producers = set()
    for f in an.cache_files:
        producers |= set(f.config.device_producers)

    def finding(fn: FnInfo, line: int, msg: str) -> Finding:
        return Finding(
            rule="cache-determinism",
            path=fn.ctx.relpath,
            line=line,
            symbol=fn.symbol,
            message=msg,
            severity=SEV_ERROR,
        )

    for fn, node in nodes:
        if isinstance(node, ast.Call):
            f = node.func
            fname = f.id if isinstance(f, ast.Name) else ""
            if fname == "id" and not _det_allowed(fn, node.lineno, "id"):
                yield finding(
                    fn,
                    node.lineno,
                    f"id() in {where} is a process address, not a content "
                    f"address — a recycled id aliases a freed object onto a "
                    f"live key; hold a strong ref + revalidate, then declare "
                    f"`# analysis: allow-cache-determinism(id) — <why>`",
                )
            elif fname in ("tuple", "list", "frozenset") and node.args:
                if _set_typed(an, node.args[0], fn) and not _det_allowed(
                    fn, node.lineno, "set-iteration"
                ):
                    yield finding(
                        fn,
                        node.lineno,
                        f"set iteration order reaches {where} — wrap in "
                        f"sorted() (PYTHONHASHSEED reorders sets across "
                        f"processes)",
                    )
            elif fname == "repr" and node.args and not isinstance(
                node.args[0], ast.Constant
            ):
                if not _det_allowed(fn, node.lineno, "repr"):
                    yield finding(
                        fn,
                        node.lineno,
                        f"repr() of an object in {where} embeds memory "
                        f"addresses/ordering artifacts — use an explicit "
                        f"content tuple",
                    )
            elif fname == "str" and node.args and not isinstance(
                node.args[0], ast.Constant
            ):
                if _float_evidence(node.args[0]) and not _det_allowed(
                    fn, node.lineno, "float"
                ):
                    yield finding(
                        fn,
                        node.lineno,
                        f"float stringification in {where} — normalize "
                        f"floats (struct.pack / float.hex / stablehash) "
                        f"before digesting",
                    )
            elif fname in producers and not _det_allowed(
                fn, node.lineno, "traced"
            ):
                yield finding(
                    fn,
                    node.lineno,
                    f"device/traced value from '{fname}' flows into {where} "
                    f"— a traced value in a key is a tracer leak AND a "
                    f"soundness bug (sync to host + normalize first)",
                )
            elif fname == "map" and node.args and isinstance(
                node.args[0], ast.Name
            ) and node.args[0].id == "id":
                if not _det_allowed(fn, node.lineno, "id"):
                    yield finding(
                        fn,
                        node.lineno,
                        f"id() in {where} is a process address, not a content "
                        f"address — a recycled id aliases a freed object onto a "
                        f"live key; hold a strong ref + revalidate, then declare "
                        f"`# analysis: allow-cache-determinism(id) — <why>`",
                    )
        elif isinstance(node, ast.FormattedValue) and node.conversion == 114:
            if not _det_allowed(fn, node.lineno, "repr"):
                yield finding(
                    fn,
                    node.lineno,
                    f"!r formatting in {where} embeds memory addresses — "
                    f"use an explicit content tuple",
                )
        elif isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            for gen in node.generators:
                if _set_typed(an, gen.iter, fn) and not _det_allowed(
                    fn, node.lineno, "set-iteration"
                ):
                    yield finding(
                        fn,
                        node.lineno,
                        f"set iteration order reaches {where} — wrap in "
                        f"sorted() (PYTHONHASHSEED reorders sets across "
                        f"processes)",
                    )


@project_rule(
    "cache-determinism",
    "no process-unstable material (hash()/id()/set order/repr/raw floats/traced values) in cache keys or digests",
)
def check_cache_determinism(pctx: ProjectContext):
    an = _shared_analyzer(pctx)
    out: List[Finding] = []

    # builtin hash() anywhere in the cache modules: content addresses
    # here must survive a process restart, and hash() never does
    for f in an.cache_files:
        symbols: Dict[ast.AST, str] = {}

        def sym_walk(node: ast.AST, cur: str) -> None:
            for child in ast.iter_child_nodes(node):
                nxt = cur
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    nxt = f"{cur}.{child.name}" if cur else child.name
                symbols[child] = nxt
                sym_walk(child, nxt)

        sym_walk(f.tree, "")
        for node in f.walk():
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "hash"
            ):
                args = scoped_marker_args(f.lines, node.lineno, "cache-determinism")
                if args and "hash" in args:
                    continue
                out.append(
                    Finding(
                        rule="cache-determinism",
                        path=f.relpath,
                        line=node.lineno,
                        symbol=symbols.get(node, ""),
                        message=(
                            "builtin hash() in a cache module is salted per "
                            "process (PYTHONHASHSEED) — use "
                            "solver/stablehash.stable_hash for content "
                            "fingerprints"
                        ),
                        severity=SEV_ERROR,
                    )
                )

    # key slices of every detected memo site
    sites = _shared_sites(an)
    ctx_nodes: List[Tuple[FnInfo, ast.AST]] = []
    visited: Set[int] = set()
    for _, site in sorted(
        sites.items(), key=lambda kv: (kv[1].fn.ctx.relpath, kv[1].fn.symbol, kv[0][1])
    ):
        for ev in site.gets + site.puts:
            for e in ev.key_exprs + ev.guard_exprs:
                _slice_nodes(an, e, site.fn, 0, ctx_nodes, visited)
    out.extend(
        _det_findings_for_context(an, ctx_nodes, "key/digest construction")
    )

    # named key/digest builders (fingerprint, digest, signature, intern)
    named: List[Tuple[FnInfo, ast.AST]] = []
    for relpath in sorted(an.modules):
        if relpath not in {f.relpath for f in an.cache_files}:
            continue
        mi = an.modules[relpath]
        for fi in list(mi.functions.values()) + [
            m for c in mi.classes.values() for m in c.methods.values()
        ]:
            if _skip_fn(fi) or not _NAME_CONTEXT_RE.search(fi.name):
                continue
            for node in ast.walk(fi.node):
                named.append((fi, node))
    out.extend(_det_findings_for_context(an, named, "key/digest construction"))

    dedup: Dict[tuple, Finding] = {}
    for f in out:
        dedup.setdefault((f.path, f.line, f.symbol, f.message), f)
    yield from sorted(
        dedup.values(), key=lambda f: (f.path, f.line, f.message)
    )


# ---------------------------------------------------------------------------
# rule 4: cache-persist (persisted-key re-anchoring)
#
# solver/warmstore.py serializes the memo planes to disk and restores
# them into a DIFFERENT process. The in-memory rules above prove keys
# witness their read-sets; persistence adds five ways to break the
# same invariant that no in-memory analysis can see:
#
# - trusting a PERSISTED generation counter: generation guards are
#   per-process ordinals — a restore must re-anchor to the LIVE world's
#   counter (after a content-witness check), never install the dead
#   process's value;
# - dropping the tenant scope while rebinding persisted keys: a
#   restored entry whose key lost its scope aliases scope-free lookups
#   onto another tenant's state;
# - trusting a payload without verifying the writer's schema id and
#   key-layout contract hash: a reader that re-anchors keys it would
#   misparse restores garbage silently;
# - restoring the compile-cache plane without comparing the stored
#   toolchain/device/source fingerprint (the config's
#   ``compile_fingerprint_keys``) against the live process — a library
#   built by another toolchain for another device is the one payload
#   whose digests cannot witness compatibility, only provenance;
# - restoring the warm-dual plane without parsing its key
#   components as what the writer's contract claims — a price-table
#   fingerprint that isn't a finite float table, or an iteration
#   budget that isn't a sane int, lands duals under keys a live solve
#   could alias after a budget or price-model change.


_PAYLOAD_PARAM_RE = re.compile(
    r"(^|_)(payload|plane|snap|snapshot|entries|handoff|blob)($|_)"
)


def _payload_params(fn_node: ast.AST) -> Set[str]:
    """Parameter names that carry persisted (snapshot-side) data, by
    the warmstore naming contract."""
    out: Set[str] = set()
    args = getattr(fn_node, "args", None)
    if args is None:
        return out
    for a in list(args.args) + list(args.kwonlyargs) + list(args.posonlyargs or []):
        if _PAYLOAD_PARAM_RE.search(a.arg):
            out.add(a.arg)
    return out


def _warmstore_functions(f: FileContext):
    """(symbol, FunctionDef) pairs, nested included."""
    out = []

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = f"{prefix}.{child.name}" if prefix else child.name
                out.append((sym, child))
                walk(child, sym)
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}.{child.name}" if prefix else child.name)

    walk(f.tree, "")
    return out


def _module_constant_names(f: FileContext) -> Set[str]:
    names: Set[str] = set()
    for node in f.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


@project_rule(
    "cache-persist",
    "persisted cache planes re-anchor on restore: live generations only, tenant scope preserved, schema/contract verified",
)
def check_cache_persist(pctx: ProjectContext):
    files = pctx.matching(pctx.config.warmstore_modules)
    for f in files:
        fns = _warmstore_functions(f)

        # (1) generation re-anchoring: any write to a ``seed_generation``
        # attribute must not be rooted in a persisted payload — the
        # stored counter value is another process's ordinal and
        # witnesses nothing in this one
        for sym, fn_node in fns:
            payload = _payload_params(fn_node)
            if not payload:
                continue
            for node in ast.walk(fn_node):
                if not isinstance(node, (ast.Assign, ast.AugAssign)):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                if not any(
                    isinstance(t, ast.Attribute) and t.attr == "seed_generation"
                    for t in targets
                ):
                    continue
                roots = {
                    n.id
                    for n in ast.walk(node.value)
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                }
                bad = roots & payload
                if bad:
                    yield Finding(
                        rule="cache-persist",
                        path=f.relpath,
                        line=node.lineno,
                        symbol=sym,
                        message=(
                            f"restore trusts the PERSISTED generation counter "
                            f"(rooted at {sorted(bad)}) — generation guards are "
                            f"per-process ordinals; re-anchor to the live "
                            f"world's generation after its content witness "
                            f"checks out"
                        ),
                        severity=SEV_ERROR,
                    )

        # (2) tenant-scope preservation: a restore/rebind helper that
        # takes the snapshot's tenant scope must actually thread it into
        # the keys it rebuilds — an unused scope parameter means the
        # restored keys silently dropped their tenant
        for sym, fn_node in fns:
            args = fn_node.args
            scope_params = [
                a.arg
                for a in list(args.args) + list(args.kwonlyargs)
                if a.arg == "tenant_scope" or a.arg.endswith("_tenant_scope")
            ]
            if not scope_params:
                continue
            used = {
                n.id
                for n in ast.walk(fn_node)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            }
            for p in scope_params:
                if p not in used:
                    yield Finding(
                        rule="cache-persist",
                        path=f.relpath,
                        line=fn_node.lineno,
                        symbol=sym,
                        message=(
                            f"'{p}' is never threaded into the rebuilt keys — "
                            f"restored entries would drop their tenant scope, "
                            f"and a scope-free lookup would alias another "
                            f"tenant's persisted state"
                        ),
                        severity=SEV_ERROR,
                    )

        # (3) contract verification: a module that declares a snapshot
        # schema/contract must compare BOTH against every payload it
        # reads (somewhere in the module) — a reader that skips either
        # check re-anchors keys it may misparse
        consts = _module_constant_names(f)
        declared = {c for c in ("SCHEMA", "CONTRACT") if c in consts}
        if declared and any(
            sym.split(".")[-1].startswith(("read_", "restore")) for sym, _ in fns
        ):
            compared: Set[str] = set()
            for node in f.walk():
                if isinstance(node, ast.Compare):
                    for n in ast.walk(node):
                        if isinstance(n, ast.Name) and n.id in declared:
                            compared.add(n.id)
            for missing in sorted(declared - compared):
                yield Finding(
                    rule="cache-persist",
                    path=f.relpath,
                    line=1,
                    symbol="",
                    message=(
                        f"snapshot reader never compares a payload against "
                        f"{missing} — version/key-layout drift would restore "
                        f"entries the reader misparses (drop the whole "
                        f"snapshot on mismatch, and count it)"
                    ),
                    severity=SEV_ERROR,
                )

        # (4) compile-cache fingerprint witnessing: a restore unit that
        # handles the "compilecache" plane is trusting another process's
        # compiled kernels — it must take the live environment
        # fingerprint (compile_cache_fingerprint) AND actually
        # compare its components (compile_fingerprint_keys) against the
        # stored ones. A restore that skips the comparison would load
        # kernels built by another toolchain for another device into this
        # process — the one corruption the byte-level digests cannot
        # see, because the stored digests still match the stored bytes
        fp_fn = "compile_cache_fingerprint"
        fp_keys = tuple(pctx.config.compile_fingerprint_keys)
        fp_names = "/".join(fp_keys)
        for sym, fn_node in fns:
            leaf = sym.split(".")[-1]
            if not leaf.startswith(("restore", "_restore")):
                continue
            touches_plane = any(
                isinstance(n, ast.Constant) and n.value == "compilecache"
                for n in ast.walk(fn_node)
            )
            if not touches_plane:
                continue
            takes_fingerprint = any(
                isinstance(n, ast.Call)
                and (
                    (isinstance(n.func, ast.Attribute) and n.func.attr == fp_fn)
                    or (isinstance(n.func, ast.Name) and n.func.id == fp_fn)
                )
                for n in ast.walk(fn_node)
            )
            compares_env = any(
                isinstance(node, ast.Compare)
                and any(
                    isinstance(n, ast.Constant) and n.value in fp_keys
                    for n in ast.walk(node)
                )
                for node in ast.walk(fn_node)
            )
            if takes_fingerprint and compares_env:
                continue
            missing_bits = []
            if not takes_fingerprint:
                missing_bits.append(f"never takes the live {fp_fn}")
            if not compares_env:
                missing_bits.append(
                    f"never compares the stored {fp_names} against the live ones"
                )
            yield Finding(
                rule="cache-persist",
                path=f.relpath,
                line=fn_node.lineno,
                symbol=sym,
                message=(
                    "compile-cache plane restored blind: "
                    + " and ".join(missing_bits)
                    + f" — a snapshot from a different {fp_names} "
                    "would load foreign compiled kernels (drop the plane "
                    "counted on mismatch, never trust it)"
                ),
                severity=SEV_ERROR,
            )

        # (5) warm-dual plane witnessing: a restore unit
        # that handles the "lprelax" plane installs another process's
        # converged dual weights as memo values keyed by a price-table
        # fingerprint and an iteration budget. Both key components must
        # be witnessed before a row lands: the price bytes must parse
        # as a FINITE float table (a non-finite price in the key means
        # the stored bound certifies a price model the live guard never
        # prices with), and the iteration budget must survive a sanity
        # comparison (the budget is a first-class key/job-token
        # component — restoring rows with a bogus budget would let a
        # future budget change alias a foreign solve's duals)
        for sym, fn_node in fns:
            leaf = sym.split(".")[-1]
            if not leaf.startswith(("restore", "_restore")):
                continue
            touches_plane = any(
                isinstance(n, ast.Constant) and n.value == "lprelax"
                for n in ast.walk(fn_node)
            )
            if not touches_plane:
                continue
            witnesses_prices = any(
                isinstance(n, ast.Call)
                and (
                    (isinstance(n.func, ast.Attribute) and n.func.attr == "isfinite")
                    or (isinstance(n.func, ast.Name) and n.func.id == "isfinite")
                )
                # the finiteness witness must hold the PRICE table —
                # an isfinite on some other field doesn't witness it
                and any(
                    isinstance(a, ast.Name) and "price" in a.id
                    for arg in n.args
                    for a in ast.walk(arg)
                )
                for n in ast.walk(fn_node)
            )
            checks_budget = any(
                isinstance(node, ast.Compare)
                and any(
                    isinstance(n, ast.Name) and "iters" in n.id
                    for n in ast.walk(node)
                )
                for node in ast.walk(fn_node)
            )
            if witnesses_prices and checks_budget:
                continue
            missing_bits = []
            if not witnesses_prices:
                missing_bits.append(
                    "never witnesses the stored price-table fingerprint as finite"
                )
            if not checks_budget:
                missing_bits.append(
                    "never sanity-compares the stored iteration budget"
                )
            yield Finding(
                rule="cache-persist",
                path=f.relpath,
                line=fn_node.lineno,
                symbol=sym,
                message=(
                    "warm-dual plane restored blind: "
                    + " and ".join(missing_bits)
                    + " — restored duals would ride keys whose components "
                    "were never parsed as what the writer's contract "
                    "claims (drop the row counted, never trust it)"
                ),
                severity=SEV_ERROR,
            )
