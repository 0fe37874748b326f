"""Config-provenance plane: the machine-checked knob surface.

Three rule families plus the registry the runtime knob witness and the
CLI ``--knobs`` view consume:

``knob-inventory``
    AST-discovers every ``os.environ`` / ``os.getenv`` read of a
    ``KARPENTER_TPU_*`` name repo-wide into an authoritative registry —
    name, default expression, parse/clamp shape, reading module, and
    read time (import vs call). Findings: numeric parses with neither a
    ``ValueError`` guard nor a clamp (a typo'd env value must degrade to
    the default, never crash a solve), and import-time reads in
    warmstore-restorable modules (a restored process cannot re-decide
    them). Scoped escape: ``# analysis: allow-knob-inventory(NAME — why)``.

``knob-docs``
    The README "Configuration" table between ``<!-- knobs:begin -->`` /
    ``<!-- knobs:end -->`` must equal ``knob_table_lines()`` exactly —
    drift (an undocumented knob, a stale row, a hand-edited default) is
    a finding against README.md, deliberately unsuppressable.

``config-provenance``
    For every cachesound-discovered memo site, the semantic env knobs
    reachable from the cached computation's body (call-graph fixpoint
    over the shared cachesound index, ``*_token()`` helpers resolved by
    name when the receiver is opaque) must be witnessed in the key
    slice. Plus a contract table for the three historically
    read-set-invisible tokens: ``pack_engine_token`` must ride the
    pod-shard config, a ``route`` memo key must carry the
    constraint-engine token, and ``_job_key`` must keep its
    ``port_features`` / pack-engine / backend ``job_token`` components.
    Scoped escape: ``# analysis: allow-config-provenance(TOKEN — why)``.

The registry doubles as the static side of the runtime knob witness
(``analysis/knobwitness.py``): every ``KARPENTER_TPU_*`` name observed
at runtime must be in ``static_knob_names()`` (observed ⊆ static).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import (
    DEFAULT_CONFIG,
    PACKAGE,
    FileContext,
    ProjectContext,
    dotted_name,
    iter_python_files,
    parse_file,
    project_rule,
    repo_root,
    symbol_at,
)
from .findings import SEV_ERROR, Finding, scoped_marker_args

def semantic_knobs(config) -> frozenset:
    """The knobs that select an engine / algorithm / budget and therefore
    change memo *content*, not just performance (the config's
    ``semantic_knobs``, named without the prefix) — any memo whose body
    reaches one of these must witness it in the key slice (or ride a
    ``*_token()``)."""
    return frozenset(config.knob_prefix + s for s in config.semantic_knobs)


SEMANTIC_KNOBS = semantic_knobs(DEFAULT_CONFIG)


# ---------------------------------------------------------------------------
# knob registry


@dataclass(frozen=True)
class KnobSite:
    """One static read site of a ``KARPENTER_TPU_*`` name."""

    name: str  # concrete env name, or a regex when pattern=True
    pattern: bool  # dynamic (f-string) knob family
    module: str  # repo-relative path of the *reading* module (call site for helpers)
    line: int
    symbol: str
    default: str  # unparsed default expression ('' = no default)
    parse: str  # int | float | flag | enum | str
    clamp: str  # '' or e.g. 'max(1, ·)'
    guarded: bool  # a ValueError-catching try wraps the parse
    read_time: str  # 'import' | 'call'
    via: str  # helper function name for expanded sites, '' for direct


_ENV_GET = {"os.environ.get", "environ.get", "os.getenv", "getenv"}
_GUARD_EXCS = {"ValueError", "TypeError", "Exception", "BaseException", "KeyError"}


def _parents_of(ctx: FileContext) -> Dict[ast.AST, ast.AST]:
    cached = getattr(ctx, "_analysis_parents", None)
    if cached is None:
        cached = {}
        for node in ctx.walk():
            for child in ast.iter_child_nodes(node):
                cached[child] = node
        object.__setattr__(ctx, "_analysis_parents", cached)
    return cached


def _unparse(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — registry rendering must never crash the rule
        return "<expr>"


def _catches_value_error(t: ast.Try) -> bool:
    for h in t.handlers:
        if h.type is None:
            return True
        names = []
        if isinstance(h.type, ast.Tuple):
            names = [dotted_name(e) for e in h.type.elts]
        else:
            names = [dotted_name(h.type)]
        if any(n.split(".")[-1] in _GUARD_EXCS for n in names):
            return True
    return False


def _read_shape(
    ctx: FileContext, node: ast.AST
) -> Tuple[str, str, bool, str, Optional[ast.AST]]:
    """(parse, clamp, guarded, read_time, enclosing_fn) for an env-read
    call node, from its ancestor chain up to the enclosing scope."""
    parents = _parents_of(ctx)
    parse = "str"
    clamps: List[str] = []
    guarded = False
    enclosing: Optional[ast.AST] = None
    cur: ast.AST = node
    p = parents.get(cur)
    hops = 0
    while p is not None and hops < 40:
        hops += 1
        if isinstance(p, ast.Call):
            base = dotted_name(p.func).split(".")[-1]
            if base in ("int", "float") and parse == "str":
                parse = base
            elif base in ("max", "min"):
                bound = next(
                    (a for a in p.args if a is not cur and not isinstance(a, ast.Starred)),
                    None,
                )
                clamps.append(f"{base}({_unparse(bound)}, ·)")
        elif isinstance(p, ast.Compare) and parse == "str":
            parse = "flag"
        elif isinstance(p, ast.Attribute) and p.attr in ("strip", "lower", "upper"):
            if parse == "str":
                parse = "enum"
        elif isinstance(p, ast.Try) and _catches_value_error(p):
            guarded = True
        elif isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            enclosing = p
            break
        cur, p = p, parents.get(p)
    read_time = "call" if enclosing is not None else "import"
    return parse, " ".join(clamps), guarded, read_time, enclosing


def _module_consts(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``NAME = "KARPENTER_TPU_..."`` string constants."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str)
        ):
            out[stmt.targets[0].id] = stmt.value.value
    return out


def _module_dicts(tree: ast.Module) -> Dict[str, List[Tuple[List[str], List[ast.AST]]]]:
    """Module-level dicts whose values are tuples carrying env names —
    ``_CAPS = {"route": ("KARPENTER_TPU_ROUTE_CACHE_MAX", 512), ...}``.
    Maps dict name → list of (tuple-elt strings-or-'', tuple-elt nodes)."""
    out: Dict[str, List[Tuple[List[str], List[ast.AST]]]] = {}
    for stmt in tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Dict)
        ):
            continue
        rows: List[Tuple[List[str], List[ast.AST]]] = []
        for v in stmt.value.values:
            if isinstance(v, ast.Tuple):
                strs = [
                    e.value if isinstance(e, ast.Constant) and isinstance(e.value, str) else ""
                    for e in v.elts
                ]
                rows.append((strs, list(v.elts)))
        if rows:
            out[stmt.targets[0].id] = rows
    return out


def _env_read_call(node: ast.AST) -> Optional[Tuple[ast.AST, Optional[ast.AST]]]:
    """(name_expr, default_expr) when ``node`` reads the environment."""
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn in _ENV_GET and node.args:
            default = node.args[1] if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "default":
                    default = kw.value
            return node.args[0], default
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if dotted_name(node.value) in ("os.environ", "environ"):
            return node.slice, None
    return None


def _fn_params(fn: Optional[ast.AST]) -> List[str]:
    if fn is None or isinstance(fn, ast.Lambda):
        args = fn.args if fn is not None else None
    else:
        args = fn.args
    if args is None:
        return []
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


@dataclass
class _Helper:
    """A function reading the env through a parameter-supplied name."""

    fn_name: str
    module: str
    param: str
    param_index: int
    default_index: Optional[int]  # positional index of a 'default' param
    template: str  # '' for plain helpers, 'KARPENTER_TPU_X_{}_Y' for f-string ones
    upper: bool  # the placeholder is .upper()'d
    parse: str
    clamp: str
    guarded: bool
    read_default: str  # default expr at the read site ('' when param-supplied)


def _tuple_unpack_sites(
    fn: ast.AST, name: str, dicts: Dict[str, List[Tuple[List[str], List[ast.AST]]]], prefix: str
) -> Optional[List[Tuple[str, str]]]:
    """Resolve ``env, default = _CAPS[key]``-style names: when ``name``
    is tuple-unpacked from a module dict inside ``fn``, return the
    (env_name, default_expr) expansion over every dict row."""
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Tuple):
            continue
        idx = next(
            (i for i, e in enumerate(tgt.elts) if isinstance(e, ast.Name) and e.id == name),
            None,
        )
        if idx is None:
            continue
        if not (
            isinstance(node.value, ast.Subscript)
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id in dicts
        ):
            continue
        out: List[Tuple[str, str]] = []
        for strs, elts in dicts[node.value.value.id]:
            if idx < len(strs) and strs[idx].startswith(prefix):
                default = _unparse(elts[1]) if idx == 0 and len(elts) > 1 else ""
                out.append((strs[idx], default))
        if out:
            return out
    return None


def _joined_template(
    expr: ast.JoinedStr, params: Sequence[str], prefix: str
) -> Optional[Tuple[str, bool, bool]]:
    """(template, references_param, upper) for an f-string env name.
    Placeholders become ``{}``; returns None when the literal part does
    not carry the knob prefix."""
    parts: List[str] = []
    references_param = False
    upper = False
    for v in expr.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        elif isinstance(v, ast.FormattedValue):
            parts.append("{}")
            inner = v.value
            if (
                isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Attribute)
                and inner.func.attr == "upper"
            ):
                upper = True
                inner = inner.func.value
            if isinstance(inner, ast.Name) and inner.id in params:
                references_param = True
    template = "".join(parts)
    if not template.startswith(prefix):
        return None
    return template, references_param, upper


def _module_def_and_imported_names(ctx: FileContext) -> Set[str]:
    out: Set[str] = set()
    for node in ctx.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                out.add((a.asname or a.name).split(".")[0])
    return out


def build_registry(files: Sequence[FileContext]) -> Dict[str, List[KnobSite]]:
    """The authoritative knob registry over ``files`` — two passes:
    direct reads (constants / module constants / dict-unpacks /
    f-strings), then expansion of parameter-name helper reads at their
    constant-argument call sites."""
    sites: List[KnobSite] = []
    helpers: Dict[str, _Helper] = {}
    symcaches: Dict[str, dict] = {}

    def add(ctx: FileContext, node: ast.AST, **kw) -> None:
        sites.append(
            KnobSite(
                module=ctx.relpath,
                line=node.lineno,
                symbol=symbol_at(ctx.tree, node, symcaches.setdefault(ctx.relpath, {})),
                **kw,
            )
        )

    for ctx in files:
        prefix = ctx.config.knob_prefix
        consts = _module_consts(ctx.tree)
        dicts = _module_dicts(ctx.tree)
        for node in ctx.walk():
            read = _env_read_call(node)
            if read is None:
                continue
            name_expr, default_expr = read
            parse, clamp, guarded, read_time, enclosing = _read_shape(ctx, node)
            params = _fn_params(enclosing)
            common = dict(
                pattern=False,
                default=_unparse(default_expr),
                parse=parse,
                clamp=clamp,
                guarded=guarded,
                read_time=read_time,
                via="",
            )
            if isinstance(name_expr, ast.Constant) and isinstance(name_expr.value, str):
                if name_expr.value.startswith(prefix):
                    add(ctx, node, name=name_expr.value, **common)
            elif isinstance(name_expr, ast.Name):
                nm = name_expr.id
                if nm in consts:
                    if consts[nm].startswith(prefix):
                        add(ctx, node, name=consts[nm], **common)
                elif nm in params and isinstance(
                    enclosing, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    plist = _fn_params(enclosing)
                    didx = next(
                        (i for i, a in enumerate(plist) if a == "default"), None
                    )
                    helpers[enclosing.name] = _Helper(
                        fn_name=enclosing.name,
                        module=ctx.relpath,
                        param=nm,
                        param_index=plist.index(nm),
                        default_index=didx,
                        template="",
                        upper=False,
                        parse=parse,
                        clamp=clamp,
                        guarded=guarded,
                        read_default=_unparse(default_expr),
                    )
                elif enclosing is not None:
                    rows = _tuple_unpack_sites(enclosing, nm, dicts, prefix)
                    if rows:
                        via = (
                            enclosing.name
                            if isinstance(
                                enclosing, (ast.FunctionDef, ast.AsyncFunctionDef)
                            )
                            else ""
                        )
                        for env_name, row_default in rows:
                            kw = dict(common)
                            kw["default"] = row_default or kw["default"]
                            kw["via"] = via
                            add(ctx, node, name=env_name, **kw)
            elif isinstance(name_expr, ast.JoinedStr):
                t = _joined_template(name_expr, params, prefix)
                if t is None:
                    continue
                template, references_param, upper = t
                if references_param and isinstance(
                    enclosing, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    plist = _fn_params(enclosing)
                    pname = next(p for p in plist)  # refined below
                    # find the referenced param precisely
                    for v in name_expr.values:
                        if isinstance(v, ast.FormattedValue):
                            inner = v.value
                            if isinstance(inner, ast.Call) and isinstance(
                                inner.func, ast.Attribute
                            ):
                                inner = inner.func.value
                            if isinstance(inner, ast.Name) and inner.id in plist:
                                pname = inner.id
                    didx = next(
                        (i for i, a in enumerate(plist) if a == "default"), None
                    )
                    helpers[enclosing.name] = _Helper(
                        fn_name=enclosing.name,
                        module=ctx.relpath,
                        param=pname,
                        param_index=plist.index(pname),
                        default_index=didx,
                        template=template,
                        upper=upper,
                        parse=parse,
                        clamp=clamp,
                        guarded=guarded,
                        read_default=_unparse(default_expr),
                    )
                else:
                    add(
                        ctx,
                        node,
                        name=re.escape(template).replace(r"\{\}", "[A-Z0-9_]+"),
                        **{**common, "pattern": True},
                    )

    # pass 2: expand helper calls with resolvable name arguments
    if helpers:
        for ctx in files:
            visible: Optional[Set[str]] = None  # computed lazily: most files call no helper
            prefix = ctx.config.knob_prefix
            consts = _module_consts(ctx.tree)
            for node in ctx.walk():
                if not isinstance(node, ast.Call):
                    continue
                fname = dotted_name(node.func).split(".")[-1]
                h = helpers.get(fname)
                if h is None:
                    continue
                if h.module != ctx.relpath:
                    if visible is None:
                        visible = _module_def_and_imported_names(ctx)
                    if fname not in visible:
                        continue
                arg: Optional[ast.AST] = None
                if h.param_index < len(node.args):
                    arg = node.args[h.param_index]
                for kw in node.keywords:
                    if kw.arg == h.param:
                        arg = kw.value
                val: Optional[str] = None
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    val = arg.value
                elif isinstance(arg, ast.Name) and arg.id in consts:
                    val = consts[arg.id]
                default = h.read_default
                if h.default_index is not None and h.default_index < len(node.args):
                    default = _unparse(node.args[h.default_index])
                for kw in node.keywords:
                    if kw.arg == "default":
                        default = _unparse(kw.value)
                _, _, _, read_time, _ = _read_shape(ctx, node)
                common = dict(
                    default=default,
                    parse=h.parse,
                    clamp=h.clamp,
                    guarded=h.guarded,
                    read_time=read_time,
                    via=h.fn_name,
                )
                if val is not None:
                    name = (
                        h.template.format(val.upper() if h.upper else val)
                        if h.template
                        else val
                    )
                    if name.startswith(prefix):
                        add(ctx, node, name=name, pattern=False, **common)
                elif h.template:
                    add(
                        ctx,
                        node,
                        name=re.escape(h.template).replace(r"\{\}", "[A-Z0-9_]+"),
                        pattern=True,
                        **common,
                    )

    registry: Dict[str, List[KnobSite]] = {}
    for s in sites:
        registry.setdefault(s.name, []).append(s)
    for name in registry:
        registry[name] = sorted(registry[name], key=lambda s: (s.module, s.line))
    return dict(sorted(registry.items()))


def _package_files(
    root: str, pctx: Optional[ProjectContext] = None, config=None
) -> List[FileContext]:
    """Every package module loaded through the shared parse cache —
    the registry source for full runs, ``--changed-only`` runs (which
    must still see the whole knob surface), the witness, and the CLI.
    With a ``pctx``, contexts are shared with the run (walk memos and
    the cachesound index reuse them)."""
    config = pctx.config if pctx is not None else (config or DEFAULT_CONFIG)
    pkg = os.path.join(root, config.package)
    out: List[FileContext] = []
    for path in iter_python_files([pkg]):
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
        rel = rel.replace(os.sep, "/")
        if pctx is not None:
            ctx = pctx.get(rel)
            if ctx is not None:
                out.append(ctx)
            continue
        try:
            source, tree = parse_file(path)
        except (OSError, SyntaxError, UnicodeDecodeError):
            continue
        out.append(FileContext(rel, source, source.splitlines(), tree, config))
    return out


def _shared_registry(pctx: ProjectContext) -> Dict[str, List[KnobSite]]:
    """The knob registry for a project run — package modules plus
    fixture files (snippets opt in by living outside the package), built
    once per ProjectContext (knob-inventory and knob-docs share it)."""
    cached = getattr(pctx, "_configprov_registry", None)
    if cached is not None:
        return cached
    files: Dict[str, FileContext] = {}
    for ctx in _package_files(pctx.root, pctx):
        files[ctx.relpath] = ctx
    for ctx in pctx.files:
        if not pctx.config.in_package(ctx.relpath):
            files[ctx.relpath] = ctx
    registry = build_registry(list(files.values()))
    pctx._configprov_registry = registry
    pctx._configprov_files = files
    return registry


def _package_registry(pctx: ProjectContext) -> Dict[str, List[KnobSite]]:
    """Package-only registry (no fixture opt-ins): what the README table
    and the runtime witness are checked against."""
    cached = getattr(pctx, "_configprov_pkg_registry", None)
    if cached is not None:
        return cached
    pkg_files = _package_files(pctx.root, pctx)
    full = getattr(pctx, "_configprov_files", None)
    if full is not None and len(full) == len(pkg_files):
        registry = _shared_registry(pctx)  # no fixtures in this run: same set
    else:
        registry = build_registry(pkg_files)
    pctx._configprov_pkg_registry = registry
    return registry


def repo_registry(root: Optional[str] = None, config=None) -> Dict[str, List[KnobSite]]:
    return build_registry(_package_files(root or repo_root(), config=config))


def static_knob_names(
    root: Optional[str] = None, config=None
) -> Tuple[Set[str], List["re.Pattern[str]"]]:
    """(concrete names, compiled patterns) — the witness's static side."""
    names: Set[str] = set()
    patterns: List[re.Pattern[str]] = []
    for name, sites in repo_registry(root, config).items():
        if any(s.pattern for s in sites):
            patterns.append(re.compile(f"^{name}$"))
        else:
            names.add(name)
    return names, patterns


# ---------------------------------------------------------------------------
# --knobs rendering (the README table IS this output)


def _shorten(module: str, package: str) -> str:
    head = package + "/"
    return module[len(head) :] if module.startswith(head) else module


def knob_rows(registry: Dict[str, List[KnobSite]], package: str = PACKAGE) -> List[dict]:
    rows = []
    for name, sites in sorted(registry.items()):
        first = sites[0]
        numeric = next((s for s in sites if s.parse in ("int", "float")), None)
        lead = numeric or first
        shape = lead.parse
        if lead.clamp:
            shape += f" · {lead.clamp}"
        if lead.guarded:
            shape += " · guarded"
        defaults = []
        for s in sites:
            if s.default and s.default not in defaults:
                defaults.append(s.default)
        rows.append(
            {
                "name": name,
                "pattern": any(s.pattern for s in sites),
                "default": "; ".join(defaults),
                "shape": shape,
                "read": "import" if any(s.read_time == "import" for s in sites) else "call",
                "modules": sorted({_shorten(s.module, package) for s in sites}),
                "sites": [
                    {
                        "module": s.module,
                        "line": s.line,
                        "symbol": s.symbol,
                        "via": s.via,
                        "read_time": s.read_time,
                        "guarded": s.guarded,
                        "clamp": s.clamp,
                        "parse": s.parse,
                        "default": s.default,
                    }
                    for s in sites
                ],
            }
        )
    return rows


def knob_table_lines(registry: Dict[str, List[KnobSite]], package: str = PACKAGE) -> List[str]:
    """The markdown knob table — identical bytes in ``--knobs`` output
    and the README block, so drift is a string comparison."""
    out = [
        "| Knob | Default | Shape | Read | Where |",
        "| --- | --- | --- | --- | --- |",
    ]
    for row in knob_rows(registry, package):
        name = row["name"].replace("\\", "") if row["pattern"] else row["name"]
        if row["pattern"]:
            name = name.replace("[A-Z0-9_]+", "<NAME>")
        default = f"`{row['default']}`" if row["default"] else "—"
        out.append(
            "| `{}` | {} | {} | {} | {} |".format(
                name,
                default,
                row["shape"],
                row["read"],
                ", ".join(f"`{m}`" for m in row["modules"]),
            )
        )
    return out


KNOBS_BEGIN = DEFAULT_CONFIG.knobs_begin
KNOBS_END = "<!-- knobs:end -->"


# ---------------------------------------------------------------------------
# knob-inventory findings


def _restorable(relpath: str, config) -> bool:
    return any(relpath.endswith(m) for m in config.restorable_modules)


@project_rule(
    "knob-inventory",
    "every knob-prefixed env read is registered; numeric parses are guarded or clamped; no import-time reads in warmstore-restorable modules",
)
def check_knob_inventory(pctx: ProjectContext) -> Iterable[Finding]:
    registry = _shared_registry(pctx)
    files: Dict[str, FileContext] = pctx._configprov_files

    def allowed(ctx: Optional[FileContext], line: int, token: str) -> bool:
        if ctx is None:
            return False
        args = scoped_marker_args(ctx.lines, line, "knob-inventory")
        return bool(args) and token in args

    for name, sites in registry.items():
        for s in sites:
            ctx = files.get(s.module)
            token = name if not s.pattern else (s.via or name)
            if (
                s.parse in ("int", "float")
                and not s.guarded
                and not s.clamp
                and not allowed(ctx, s.line, token)
            ):
                yield Finding(
                    rule="knob-inventory",
                    path=s.module,
                    line=s.line,
                    symbol=s.symbol,
                    message=(
                        f"unguarded {s.parse}() parse of {token}: a typo'd env "
                        f"value crashes the reader — wrap in try/except "
                        f"ValueError (fall back to the default) or clamp, or "
                        f"declare `# analysis: allow-knob-inventory({token} — why)`"
                    ),
                    severity=SEV_ERROR,
                )
            if (
                s.read_time == "import"
                and _restorable(s.module, pctx.config)
                and not allowed(ctx, s.line, token)
            ):
                yield Finding(
                    rule="knob-inventory",
                    path=s.module,
                    line=s.line,
                    symbol=s.symbol,
                    message=(
                        f"import-time read of {token} in a warmstore-restorable "
                        f"module: a restored process can never re-decide it — "
                        f"move the read behind a function, or declare "
                        f"`# analysis: allow-knob-inventory({token} — why)`"
                    ),
                    severity=SEV_ERROR,
                )


@project_rule(
    "knob-docs",
    "the README Configuration table equals the generated knob registry (python -m <package>.analysis --knobs)",
)
def check_knob_docs(pctx: ProjectContext) -> Iterable[Finding]:
    cfg = pctx.config
    readme = os.path.join(pctx.root, "README.md")
    try:
        with open(readme, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return  # fixture roots carry no README: nothing to drift
    if cfg.knobs_begin not in text or KNOBS_END not in text:
        yield Finding(
            rule="knob-docs",
            path="README.md",
            line=1,
            symbol="",
            message=(
                f"README has no generated knob table (missing '{cfg.knobs_begin}' "
                f"markers) — add a Configuration section holding the output of "
                f"`python -m {cfg.package}.analysis --knobs`"
            ),
            severity=SEV_ERROR,
        )
        return
    block = text.split(cfg.knobs_begin, 1)[1].split(KNOBS_END, 1)[0]
    documented = [ln for ln in block.splitlines() if ln.strip()]
    generated = knob_table_lines(_package_registry(pctx), cfg.package)
    if documented == generated:
        return
    line = text[: text.index(cfg.knobs_begin)].count("\n") + 1
    doc_names = {ln.split("|")[1].strip() for ln in documented if ln.startswith("| `")}
    gen_names = {ln.split("|")[1].strip() for ln in generated if ln.startswith("| `")}
    undocumented = sorted(n.strip("`") for n in gen_names - doc_names)
    stale = sorted(n.strip("`") for n in doc_names - gen_names)
    detail = []
    if undocumented:
        detail.append("undocumented: " + ", ".join(undocumented))
    if stale:
        detail.append("stale rows: " + ", ".join(stale))
    if not detail:
        drift = next(
            (i for i, (a, b) in enumerate(zip(documented, generated)) if a != b),
            min(len(documented), len(generated)),
        )
        detail.append(f"row {drift + 1} drifted")
    yield Finding(
        rule="knob-docs",
        path="README.md",
        line=line,
        symbol="",
        message=(
            "README knob table drifted from the code registry ("
            + "; ".join(detail)
            + f") — regenerate with `python -m {cfg.package}.analysis --knobs`"
        ),
        severity=SEV_ERROR,
    )


# ---------------------------------------------------------------------------
# config-provenance: memo bodies' env reads must ride the key


def _direct_env_names(mi, fn_node: ast.AST) -> Set[str]:
    consts = getattr(mi, "_configprov_consts", None)
    if consts is None:
        consts = _module_consts(mi.ctx.tree)
        mi._configprov_consts = consts
    prefix = mi.ctx.config.knob_prefix
    out: Set[str] = set()
    for node in ast.walk(fn_node):
        read = _env_read_call(node)
        if read is None:
            continue
        name_expr, _ = read
        if isinstance(name_expr, ast.Constant) and isinstance(name_expr.value, str):
            if name_expr.value.startswith(prefix):
                out.add(name_expr.value)
        elif isinstance(name_expr, ast.Name) and name_expr.id in consts:
            if consts[name_expr.id].startswith(prefix):
                out.add(consts[name_expr.id])
    return out


def _reads_env_via_param(fn_node: ast.AST) -> bool:
    params = set(_fn_params(fn_node))
    for node in ast.walk(fn_node):
        read = _env_read_call(node)
        if read is None:
            continue
        name_expr, _ = read
        if isinstance(name_expr, ast.Name) and name_expr.id in params:
            return True
        if isinstance(name_expr, ast.JoinedStr):
            return True
    return False


class _EnvReach:
    """Fixpoint of KARPENTER_TPU_* names reachable from a function
    through the cachesound cross-module call graph. ``*_token()`` calls
    whose receiver is opaque resolve by name across every indexed
    module — the declared token grammar that lets key helpers ride."""

    def __init__(self, an) -> None:
        self.an = an
        self._memo: Dict[int, Set[str]] = {}
        self._stack: Set[int] = set()
        self._by_name: Dict[str, List] = {}
        for mi in an.modules.values():
            for fname, fi in mi.functions.items():
                self._by_name.setdefault(fname, []).append(fi)
            for ci in mi.classes.values():
                for mname, fi in ci.methods.items():
                    self._by_name.setdefault(mname, []).append(fi)

    def _module_of(self, fi):
        return self.an.modules.get(fi.ctx.relpath)

    def of(self, fi) -> Set[str]:
        key = id(fi.node)
        if key in self._memo:
            return self._memo[key]
        if key in self._stack:
            return set()
        self._stack.add(key)
        mi = self._module_of(fi)
        out: Set[str] = set()
        if mi is not None:
            out |= _direct_env_names(mi, fi.node)
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                out |= self.of_call(node, fi)
            elif (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)
            ):
                pi = self.an.resolve_property("self", node.attr, fi)
                if pi is not None:
                    out |= self.of(pi)
        self._stack.discard(key)
        self._memo[key] = out
        return out

    def of_call(self, call: ast.Call, fi) -> Set[str]:
        out: Set[str] = set()
        target = self.an.resolve_call(call, fi)
        if target is not None:
            out |= self.of(target)
            if _reads_env_via_param(target.node):
                for a in list(call.args) + [k.value for k in call.keywords]:
                    if isinstance(a, ast.Constant) and isinstance(a.value, str):
                        if a.value.startswith(fi.ctx.config.knob_prefix):
                            out.add(a.value)
        else:
            base = dotted_name(call.func).split(".")[-1]
            if base.endswith("_token"):
                for cand in self._by_name.get(base, []):
                    out |= self.of(cand)
        return out


def _assign_map(fn_node: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}

    def record(target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                record(e, value)

    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                record(t, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            record(node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            record(node.target, node.value)
        elif isinstance(node, ast.NamedExpr):
            record(node.target, node.value)
        elif isinstance(node, ast.For):
            record(node.target, node.iter)
    return out


def _slice_closure(fn_node: ast.AST, seeds: Sequence[ast.AST]) -> List[ast.AST]:
    """Def-use closure of ``seeds`` over the function's assignments —
    the 'key slice' / 'body slice' the provenance comparison runs on."""
    assigns = _assign_map(fn_node)
    out: List[ast.AST] = []
    seen: Set[int] = set()
    work = list(seeds)
    while work and len(out) < 400:
        n = work.pop()
        if n is None or id(n) in seen:
            continue
        seen.add(id(n))
        out.append(n)
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                for rhs in assigns.get(sub.id, []):
                    if id(rhs) not in seen:
                        work.append(rhs)
    return out


def _env_of_slice(reach: _EnvReach, fi, nodes: Sequence[ast.AST]) -> Set[str]:
    an = reach.an
    mi = an.modules.get(fi.ctx.relpath)
    out: Set[str] = set()
    for n in nodes:
        for sub in ast.walk(n):
            read = _env_read_call(sub)
            if read is not None and mi is not None:
                name_expr, _ = read
                if isinstance(name_expr, ast.Constant) and isinstance(
                    name_expr.value, str
                ):
                    if name_expr.value.startswith(fi.ctx.config.knob_prefix):
                        out.add(name_expr.value)
            if isinstance(sub, ast.Call):
                out |= reach.of_call(sub, fi)
            elif (
                isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and isinstance(sub.ctx, ast.Load)
            ):
                pi = an.resolve_property("self", sub.attr, fi)
                if pi is not None:
                    out |= reach.of(pi)
    return out


def _prov_allowed(fi, line: int, token: str) -> bool:
    for ln in (line, fi.node.lineno):
        args = scoped_marker_args(fi.ctx.lines, ln, "config-provenance")
        if args and token in args:
            return True
    return False


def _calls_named(fn_node: ast.AST, name: str) -> bool:
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            if dotted_name(node.func).split(".")[-1] == name:
                return True
    return False


def _subscripts_const(fn_node: ast.AST, key: str) -> bool:
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value == key:
                return True
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == key
            ):
                return True
    return False


#: the three historically read-set-invisible tokens (RULES.md residual
#: entry, retired by this rule): function name → required body elements.
_TOKEN_CONTRACTS: Tuple[Tuple[str, Tuple[Tuple[str, str, str], ...]], ...] = (
    (
        "pack_engine_token",
        (
            (
                "call",
                "pod_shard_token",
                "pack_engine_token dropped the pod-shard config: shard-mode "
                "plans differ per chunking, so a job memo keyed without "
                "pod_shard_token(mesh) serves a stale plan across "
                "{prefix}SHARD_* flips",
            ),
        ),
    ),
    (
        "_job_key",
        (
            (
                "subscript",
                "port_features",
                "_job_key dropped the port_features component: hostPort-"
                "constrained pods pack differently, so two catalogs differing "
                "only in port usage would alias one memo row",
            ),
            (
                "call",
                "pack_engine_token",
                "_job_key dropped pack_engine_token: the job memo no longer "
                "witnesses the pack-engine/native/shard config and a restored "
                "process replays plans from a different engine",
            ),
            (
                "call",
                "job_token",
                "_job_key dropped the backend job_token: LP-backend budget "
                "knobs (iters/refine/branch) change plan content and must "
                "ride the key",
            ),
        ),
    ),
)


@project_rule(
    "config-provenance",
    "every env knob reachable from a memoized computation's body is witnessed in its key slice (or rides a declared *_token helper)",
)
def check_config_provenance(pctx: ProjectContext) -> Iterable[Finding]:
    from .cachesound import _shared_analyzer, _shared_sites

    an = _shared_analyzer(pctx)
    reach = _EnvReach(an)

    def finding(fi, line: int, msg: str) -> Finding:
        return Finding(
            rule="config-provenance",
            path=fi.ctx.relpath,
            line=line,
            symbol=fi.symbol,
            message=msg,
            severity=SEV_ERROR,
        )

    # contract table: the named key helpers must keep their token rides
    for mi in an.modules.values():
        fns = dict(mi.functions)
        for ci in mi.classes.values():
            fns.update(ci.methods)
        for fname, fi in fns.items():
            for contract_fn, requirements in _TOKEN_CONTRACTS:
                if fname != contract_fn:
                    continue
                for kind, token, msg in requirements:
                    present = (
                        _calls_named(fi.node, token)
                        if kind == "call"
                        else _subscripts_const(fi.node, token)
                    )
                    if not present and not _prov_allowed(fi, fi.node.lineno, token):
                        yield finding(
                            fi,
                            fi.node.lineno,
                            msg.replace("{prefix}", pctx.config.knob_prefix)
                            + f" — restore the {token} component or declare "
                            f"`# analysis: allow-config-provenance({token} — why)`",
                        )

    # per-site: body env reads ⊆ key env witness
    for site in _shared_sites(an).values():
        if not site.puts:
            continue
        fi = site.fn
        key_seeds = [e for ev in site.gets + site.puts for e in ev.key_exprs]
        val_seeds = [e for ev in site.puts for e in ev.value_exprs]
        anchor = min(ev.line for ev in site.puts)
        key_slice = _slice_closure(fi.node, key_seeds)
        key_env = _env_of_slice(reach, fi, key_slice)
        body_env = _env_of_slice(reach, fi, _slice_closure(fi.node, val_seeds))
        if site.spec.name == "route":
            # the route memo's constraint-engine token contract: the key
            # slice must carry a constraint_engine() call even when the
            # value slice's env reach is opaque (engine dispatch happens
            # behind per-group helpers)
            has_ce = any(
                isinstance(sub, ast.Call)
                and dotted_name(sub.func).split(".")[-1] == "constraint_engine"
                for n in key_slice
                for sub in ast.walk(n)
            )
            if not has_ce and not _prov_allowed(fi, anchor, "constraint_engine"):
                yield finding(
                    fi,
                    anchor,
                    "route memo key never witnesses the constraint-engine "
                    "token: tensor- and host-engine position lists differ in "
                    f"tie-break order, so a {pctx.config.knob_prefix}CONSTRAINT_ENGINE "
                    "flip would replay the other engine's plan — append "
                    '(("ce", constraint_engine()),) to the key or declare '
                    "`# analysis: allow-config-provenance(constraint_engine — why)`",
                )
        for name in sorted((body_env & semantic_knobs(pctx.config)) - key_env):
            if _prov_allowed(fi, anchor, name):
                continue
            yield finding(
                fi,
                anchor,
                f"memoized computation reads {name} but the memo key never "
                f"witnesses it: a process with a different {name} replays "
                f"this entry verbatim — thread the knob (or a *_token() "
                f"helper reading it) into the key, or declare "
                f"`# analysis: allow-config-provenance({name} — why)`",
            )
