"""Rule engine: walks files, parses once, runs registered rules, applies
suppressions and the baseline. stdlib ``ast`` only — a run imports
neither torch nor the package it reads.

The rules read host Python only. ``AnalysisConfig`` names the modules
each rule holds, the package root and the knob prefix, so the same
analyzer reads this package (``DEFAULT_CONFIG``) or any tree laid out
like it (``AnalysisConfig(package=..., knob_prefix=..., ...)``).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import Baseline, Finding, is_suppressed, split_by_baseline

# ---------------------------------------------------------------------------
# configuration

PACKAGE = "karpenter_core_tpu_torch"


def _mods(*names: str) -> Tuple[str, ...]:
    return tuple(f"{PACKAGE}/{n}" for n in names)


@dataclass(frozen=True)
class AnalysisConfig:
    """Repo-specific knowledge the rules key off. Paths are repo-relative
    posix suffixes/prefixes."""

    # the package a run reads: files under ``package/`` are held to the
    # module scopes below, files outside it (rule fixtures) opt in to
    # every scoped project rule
    package: str = PACKAGE
    # modules on the solve's device path, where a host<->device sync is a
    # latency bug unless marked (host-sync) and a branch on a tensor's
    # value is an implicit one (tensor-branch): the counterparts of the
    # reference's list, ``compat_kernels.py`` for its ``pallas_kernels.py``
    device_hot_modules: Tuple[str, ...] = _mods(
        "solver/pack.py",
        "solver/sharding.py",
        "solver/backend.py",
        "solver/kernels.py",
        "solver/compat_kernels.py",
        "solver/backends/lp.py",
    )
    # modules whose hand-kernel launches must register with the device
    # plane (kernel-registry): the device-hot list, and the disruption
    # screens' launches, which sit beside ``disruption/tpu_repack.py``'s
    # counterpart
    kernel_registry_modules: Tuple[str, ...] = _mods(
        "solver/pack.py",
        "solver/sharding.py",
        "solver/backend.py",
        "solver/kernels.py",
        "solver/compat_kernels.py",
        "solver/backends/lp.py",
        "disruption/screen_kernels.py",
    )
    # the sync vocabulary: methods that exist only to bring a device
    # value to the host, and calls that wait for the card, flagged
    # wherever they stand in a device-hot module
    sync_methods: Tuple[str, ...] = ("item", "tolist", "cpu", "numpy")
    sync_calls: Tuple[str, ...] = ("torch.cuda.synchronize",)
    # decorators whose bodies are device code (not scanned for syncs;
    # their functions produce device values): none in the port, whose
    # wrappers are eager host code around a launch
    device_code_decorators: Tuple[str, ...] = ()
    # decorators whose functions return device values in their own
    # module: the device plane's entry points
    producer_decorators: Tuple[str, ...] = ("deviceplane.observe",)
    # the environment-knob prefix the knob inventory and its witness read
    knob_prefix: str = "KARPENTER_TORCH_"
    # the module that the control-plane import rule forbids in the
    # host-only packages
    forbidden_import: str = "torch"
    # the knobs (less the prefix) that select an engine, a backend or a
    # budget and so change a memo's content: config-provenance holds every
    # memo whose body reads one to witness it in its key. The port's: the
    # pack backend and the native packer's switch (two engines plan apart
    # at scale), the auto backend's LP threshold, the disruption and fleet
    # engines
    semantic_knobs: Tuple[str, ...] = ("PACK_BACKEND", "NATIVE", "LP_MIN_WORK", "DISRUPT_ENGINE", "FLEET_ENGINE")
    # control-plane packages that must never import torch: a stray tensor
    # op in a controller thread would initialize CUDA outside the solver's
    # device seam
    host_only_prefixes: Tuple[str, ...] = _mods(
        "state/",
        "metrics/",
        "operator/",
        "kube/",
        "apis/",
        "events/",
        "scheduling/",
        "scheduler/",
        "provisioning/",
        "lifecycle/",
        "utils/",
        "cloudprovider/",
        "tracing/",
        "serving/",
        "fleet/",
    )
    # cross-module functions that return a device tensor: the kernel
    # wrappers and the sharded launches (cache-determinism refuses their
    # values in a memo key; host-sync and tensor-branch track them).
    # ``sharded_pod_pack`` is not one: it returns host arrays
    device_producers: Tuple[str, ...] = (
        "sharded_batch_pack",
        "sharded_prefix_screen",
        "sharded_compat",
        "allowed_sharded",
        "ffd_pack",
        "ffd_pack_batched",
        "pack_existing",
        "allowed",
        "screen_prefix",
        "screen_subsets",
        "screen_singles",
    )
    # calls that commit work to the card: a hand kernel's launch, a
    # device sync, and the solver's dispatch seam (wait-under-lock counts
    # each as a "device" wait)
    device_seam: Tuple[str, ...] = ("pack_jobs", "warmup_compile_only", "launch", "synchronize")
    # modules holding cross-solve memoization: the cachesound family
    # verifies every memo key witnesses its read-set here
    cache_modules: Tuple[str, ...] = _mods(
        "solver/incremental.py",
        "solver/podcache.py",
        "solver/solver.py",
        "solver/encode.py",
        "solver/merge.py",
        "disruption/engine.py",
        # plan-quality pack backends: the LP relaxation memo
        "solver/backends/__init__.py",
        "solver/backends/lp.py",
        # fleet mega-solve: the tenant envelope/canonical catalog memos
        # and the fleet-wide job-skeleton content plane
        "fleet/registry.py",
        "fleet/megasolve.py",
        # pod-axis mega-shard: pod_shard_token contributes job-memo key
        # material (consumed by incremental.pack_engine_token)
        "solver/sharding.py",
        # constraint tensorization: the port/volume mask builders whose
        # outputs ride job-memo keys (port_features) and existing-pack
        # masks
        "solver/constraint_tensors.py",
    )
    # warm-state persistence modules: the snapshot/restore seam whose
    # restore paths the cache-persist rule holds to the re-anchoring
    # contract (live generations only, tenant scope preserved,
    # schema/contract verified before trusting a payload, the
    # compile-cache plane restored only behind a comparison of the
    # fingerprint below, and the lprelax warm-dual plane restored only
    # behind finite-price and iteration-budget witnesses); prewarm.py
    # loads the restored kernel libraries and backends/lp.py owns the
    # persisted lprelax plane — both ride the same rule set
    warmstore_modules: Tuple[str, ...] = _mods(
        "solver/warmstore.py",
        "solver/prewarm.py",
        "solver/backends/lp.py",
    )
    # the compile-cache plane's fingerprint (a restore must take it from
    # ``compile_cache_fingerprint()``): the components it must compare,
    # the toolchain, the device and the kernel sources a library was
    # built from
    compile_fingerprint_keys: Tuple[str, ...] = ("torch", "cuda", "capability", "sources")
    # informer-state modules whose mutators must bump Cluster.generation()
    state_modules: Tuple[str, ...] = _mods("state/cluster.py")
    # provider modules whose catalog mutators must bump catalog_generation()
    provider_modules: Tuple[str, ...] = _mods(
        "cloudprovider/fake.py",
        "cloudprovider/types.py",
    )
    # serving-pipeline modules: multi-threaded by design, held to the
    # pipeline-safety rule (lock-guarded or queue-handed-off sharing);
    # the fleet engine's worker threads are held to the same rule
    serving_prefixes: Tuple[str, ...] = _mods("serving/", "fleet/")
    # modules whose cluster-API reads define the generation-relevant
    # field set (what the solver's caches can actually observe)
    cluster_consumer_modules: Tuple[str, ...] = _mods(
        "solver/solver.py",
        "solver/incremental.py",
        "provisioning/provisioner.py",
        "scheduler/scheduler.py",
        "disruption/helpers.py",
    )
    # control-loop packages held to clock discipline: any
    # duration/timeout/expiry math must read time.monotonic(); wall
    # clock is reserved for stamps that cross a process boundary
    # (leases, deletionTimestamp, condition transitions) under a scoped
    # `# analysis: allow-clock(reason)` marker
    control_loop_modules: Tuple[str, ...] = _mods(
        "disruption/",
        "operator/",
        "serving/",
        "lifecycle/",
        "provisioning/",
        "kube/",
        "state/",
    )
    # every module that creates or acquires a threading primitive: the
    # concurrency rule family discovers the lock inventory here, builds
    # the global lock-order graph across the set, and scopes the
    # wait-under-lock / process-boundary checks to it. Cross-file
    # resolution loads the full set even on --changed-only runs.
    concurrency_modules: Tuple[str, ...] = _mods(
        "serving/pipeline.py",
        "serving/queues.py",
        "serving/latency.py",
        "provisioning/batcher.py",
        "provisioning/provisioner.py",
        "fleet/megasolve.py",
        "fleet/registry.py",
        "fleet/scheduler.py",
        "solver/solver.py",
        "solver/incremental.py",
        "solver/warmstore.py",
        "solver/prewarm.py",
        "solver/backends/__init__.py",
        "solver/podcache.py",
        "solver/oracle_bridge.py",
        "state/cluster.py",
        "kube/client.py",
        "kube/restclient.py",
        "kube/faults.py",
        "cloudprovider/fake.py",
        "operator/server.py",
        "metrics/registry.py",
        "events/recorder.py",
        "utils/atomic.py",
        "tracing/tracer.py",
        "tracing/flightrec.py",
        "tracing/deviceplane.py",
        "native/__init__.py",
        # the port's own: the kernel-library loader, the library
        # manifest, the device clock, the mesh lanes, and the operator's
        # controller threads and leader election
        "buildlib.py",
        # the kernel wrappers: each launch takes its CudaKernel's lock
        "solver/compat_kernels.py",
        "solver/pack.py",
        "solver/backends/lp.py",
        "disruption/screen_kernels.py",
        "solver/backend.py",
        "solver/devicetime.py",
        "solver/sharding.py",
        "operator/controller.py",
        "operator/leaderelection.py",
    )
    # modules whose locks are observability/interning leaves by contract
    # (see concurrency.py: verified leaves, left out of wait-under-lock
    # held-sets and of the runtime witness)
    sink_modules: Tuple[str, ...] = _mods(
        "metrics/registry.py",
        "tracing/tracer.py",
        "tracing/flightrec.py",
        "tracing/deviceplane.py",
        "events/recorder.py",
        "utils/atomic.py",
        "serving/latency.py",
        "solver/podcache.py",
        "native/__init__.py",
        "kube/faults.py",
        "operator/server.py",
    )
    # per-lock sink membership for modules that mix coordination locks
    # with leaf locks
    sink_lock_ids: Tuple[str, ...] = (
        f"{PACKAGE}/solver/incremental.py::LRU._mu",
        f"{PACKAGE}/solver/warmstore.py::_LAST_LOCK",
    )
    # modules a warmstore restore re-animates: an import-time knob read
    # here is frozen before restore() can run, so a restored process can
    # never re-decide it — the knob-inventory rule forces such reads
    # behind functions (or a scoped marker stating why the freeze is
    # deliberate, e.g. a static kernel shape)
    restorable_modules: Tuple[str, ...] = _mods(
        "solver/warmstore.py",
        "solver/prewarm.py",
        "solver/backends/lp.py",
        "solver/backends/__init__.py",
        "solver/solver.py",
        "solver/incremental.py",
        "solver/pack.py",
        "solver/sharding.py",
        "solver/backend.py",
        "fleet/registry.py",
        "fleet/megasolve.py",
    )
    # modules whose outputs must be iteration-order deterministic: plan
    # emission, fingerprints/stable hashes, and warmstore payloads all
    # cross a process boundary, so unordered producers (unsorted
    # listdir/glob, bare popitem, set iteration) are findings here —
    # scoped `# analysis: allow-determinism(why)`
    determinism_prefixes: Tuple[str, ...] = _mods(
        "solver/",
        "fleet/",
        "native/",
        "tracing/capture.py",
    )
    # the README's generated knob table starts at this marker
    knobs_begin: str = f"<!-- knobs:begin (generated: python -m {PACKAGE}.analysis --knobs) -->"

    def in_package(self, relpath: str) -> bool:
        return relpath.startswith(self.package + "/")


DEFAULT_CONFIG = AnalysisConfig()


# ---------------------------------------------------------------------------
# shared parse cache: one AST per (path, mtime, size) across every rule
# family AND every analyze_paths call in the process. The tier-1 meta-
# tests and the cachesound mutation harness re-analyze near-identical
# file sets dozens of times; without this each run would re-parse the
# whole package (solver.py alone is ~4.3k lines).

_PARSE_CACHE: Dict[str, Tuple[Tuple[int, int], str, ast.Module]] = {}
_PARSE_CACHE_MAX = 1024


def parse_file(path: str) -> Tuple[str, ast.Module]:
    """Source + AST for ``path``, cached on (mtime_ns, size). Raises
    OSError/SyntaxError/UnicodeDecodeError like open/ast.parse."""
    ap = os.path.abspath(path)
    st = os.stat(ap)
    sig = (st.st_mtime_ns, st.st_size)
    hit = _PARSE_CACHE.get(ap)
    if hit is not None and hit[0] == sig:
        return hit[1], hit[2]
    with open(ap, "r", encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=ap)
    if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
        _PARSE_CACHE.clear()  # content-addressed: only costs re-parsing
    _PARSE_CACHE[ap] = (sig, source, tree)
    return source, tree


@dataclass
class FileContext:
    relpath: str  # repo-relative posix path
    source: str
    lines: List[str]
    tree: ast.Module
    config: AnalysisConfig

    def walk(self) -> List[ast.AST]:
        """Memoized full-tree preorder walk. Every rule that scans the
        whole module should iterate this instead of re-walking the tree
        — with ~16 rule families the redundant traversals dominate the
        CLI's wall time."""
        nodes = getattr(self, "_walk_cache", None)
        if nodes is None:
            nodes = list(ast.walk(self.tree))
            object.__setattr__(self, "_walk_cache", nodes)
        return nodes

    def is_device_hot(self) -> bool:
        return any(self.relpath.endswith(m) for m in self.config.device_hot_modules)

    def is_host_only(self) -> bool:
        return any(self.relpath.startswith(p) for p in self.config.host_only_prefixes)


# ---------------------------------------------------------------------------
# registry

RuleFn = Callable[[FileContext], Iterable[Finding]]

_RULES: Dict[str, Tuple[RuleFn, str]] = {}


def rule(name: str, description: str):
    def deco(fn: RuleFn) -> RuleFn:
        _RULES[name] = (fn, description)
        return fn

    return deco


@dataclass
class ProjectContext:
    """What a project-level rule sees: every file of the run, plus
    on-demand access (through the shared parse cache) to repo modules the
    rule needs for cross-file reasoning even when the run was scoped to a
    subset (``--changed-only``)."""

    files: List[FileContext]
    root: str
    config: AnalysisConfig

    def __post_init__(self) -> None:
        self._by_rel: Dict[str, FileContext] = {f.relpath: f for f in self.files}

    def get(self, relpath: str) -> Optional[FileContext]:
        """The FileContext for a repo-relative path — from this run's
        set, or loaded (and cached) from disk under ``root``."""
        ctx = self._by_rel.get(relpath)
        if ctx is not None:
            return ctx
        path = os.path.join(self.root, relpath.replace("/", os.sep))
        try:
            source, tree = parse_file(path)
        except (OSError, SyntaxError, UnicodeDecodeError):
            return None
        ctx = FileContext(relpath, source, source.splitlines(), tree, self.config)
        self._by_rel[relpath] = ctx
        return ctx

    def matching(self, suffixes: Sequence[str]) -> List[FileContext]:
        """Files participating in a module-scoped project rule: every
        loaded file whose relpath ends with a configured suffix, plus
        the configured modules themselves loaded from the repo root —
        and, for fixture runs rooted outside the package, every file
        (snippets opt in by not living under the configured package)."""
        out: List[FileContext] = []
        seen = set()
        for f in self.files:
            hit = any(f.relpath.endswith(s) for s in suffixes) or not self.config.in_package(
                f.relpath
            )
            if hit and f.relpath not in seen:
                seen.add(f.relpath)
                out.append(f)
        for s in suffixes:
            if s in seen:
                continue
            ctx = self.get(s)
            if ctx is not None and ctx.relpath not in seen:
                seen.add(ctx.relpath)
                out.append(ctx)
        return out


ProjectRuleFn = Callable[[ProjectContext], Iterable[Finding]]

_PROJECT_RULES: Dict[str, Tuple[ProjectRuleFn, str]] = {}


def project_rule(name: str, description: str):
    """A rule that reasons across files (call graphs, key/read-set
    comparisons). Runs once per analysis over the whole file set."""

    def deco(fn: ProjectRuleFn) -> ProjectRuleFn:
        _PROJECT_RULES[name] = (fn, description)
        return fn

    return deco


def registered_rules() -> Dict[str, str]:
    _load_rules()
    out = {name: desc for name, (_, desc) in _RULES.items()}
    out.update({name: desc for name, (_, desc) in _PROJECT_RULES.items()})
    return dict(sorted(out.items()))


_LOADED = False


def _load_rules() -> None:
    global _LOADED
    if not _LOADED:
        from . import (  # noqa: F401
            cachesound,
            clock,
            concurrency,
            configprov,
            determinism,
            hygiene,  # before hostsync, as the reference registers them
            hostsync,
            jitregistry,
            locks,
            pipelinesafety,
            tracersafety,
        )

        _LOADED = True


# ---------------------------------------------------------------------------
# shared AST helpers (used by several rules)


def qualify(tree: ast.Module) -> Dict[ast.AST, str]:
    """node → enclosing 'Class.method' / 'function' symbol map."""
    out: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, sym: str) -> None:
        for child in ast.iter_child_nodes(node):
            child_sym = sym
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                child_sym = f"{sym}.{child.name}" if sym else child.name
            out[child] = child_sym
            walk(child, child_sym)

    walk(tree, "")
    return out


def symbol_at(tree: ast.Module, node: ast.AST, cache: dict) -> str:
    if "qual" not in cache:
        cache["qual"] = qualify(tree)
    return cache["qual"].get(node, "")


def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def decorator_named(fn: ast.AST, names: Sequence[str]) -> Optional[ast.expr]:
    """The first decorator of ``fn`` that is one of ``names`` (dotted, as
    written), bare, called, or as ``functools.partial(<name>, ...)``; else
    None. Names are strings: the analyzer imports nothing it reads."""
    if not names or not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name in names:
            return dec
        if name.endswith("partial") and isinstance(dec, ast.Call) and dec.args and dotted_name(dec.args[0]) in names:
            return dec
    return None


# ---------------------------------------------------------------------------
# runner


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)  # active (gate fails)
    suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale_baseline: List[dict] = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline and not self.parse_errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": [f.to_dict() for f in self.baselined],
            "stale_baseline": self.stale_baseline,
            "parse_errors": self.parse_errors,
        }


def iter_python_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def analyze_paths(
    paths: Sequence[str],
    root: Optional[str] = None,
    config: Optional[AnalysisConfig] = None,
    baseline: Optional[Baseline] = None,
    rules: Optional[Sequence[str]] = None,
) -> Report:
    """Run the rule set over ``paths`` (files or directories)."""
    _load_rules()
    config = config or DEFAULT_CONFIG
    if root is None:
        root = os.getcwd()
    selected = {
        name: fn for name, (fn, _) in _RULES.items() if rules is None or name in rules
    }
    selected_project = {
        name: fn
        for name, (fn, _) in _PROJECT_RULES.items()
        if rules is None or name in rules
    }
    report = Report()
    raw: List[Finding] = []
    contexts: List[FileContext] = []
    for path in iter_python_files(paths):
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
        rel = rel.replace(os.sep, "/")
        try:
            source, tree = parse_file(path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            report.parse_errors.append(f"{rel}: {e}")
            continue
        ctx = FileContext(rel, source, source.splitlines(), tree, config)
        contexts.append(ctx)
        report.files_scanned += 1
        for fn in selected.values():
            for finding in fn(ctx):
                if is_suppressed(finding, ctx.lines):
                    report.suppressed.append(finding)
                else:
                    raw.append(finding)
    if selected_project:
        pctx = ProjectContext(contexts, os.path.abspath(root), config)
        for fn in selected_project.values():
            for finding in fn(pctx):
                owner = pctx.get(finding.path)
                if owner is not None and is_suppressed(finding, owner.lines):
                    report.suppressed.append(finding)
                else:
                    raw.append(finding)
    active, baselined, stale = split_by_baseline(raw, baseline)
    report.findings = sorted(active, key=lambda f: (f.path, f.line, f.rule))
    report.baselined = baselined
    report.stale_baseline = stale
    return report


def repo_root() -> str:
    """The repo checkout containing this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def analyze_repo(
    baseline_path: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    use_baseline: bool = True,
) -> Report:
    """The gate entrypoint: scan the package with the checked-in
    baseline."""
    root = repo_root()
    pkg = os.path.join(root, PACKAGE)
    baseline = None
    if use_baseline:
        baseline = Baseline.load(baseline_path or default_baseline_path())
    return analyze_paths([pkg], root=root, baseline=baseline, rules=rules)
