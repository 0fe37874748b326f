"""The port's static analyzer (``karpenter_core_tpu_torch/analysis/``)
against the JAX package's, on the CPU.

Each reference rule test (``tests/test_static_analysis.py``'s host-rule
cases here; the cachesound, concurrency, configprov and pipeline-safety
files in ``test_torch_analysis_*.py``) runs as a mirror: its source with
the package swapped for the port's, so its assertions hold the port's
analyzer. Every fixture run goes through both analyzers (``dual``): the
same snippet files, the reference's ``analyze_paths`` with its own
config, the port's with ``reference_config()`` — the port's
``AnalysisConfig`` carrying the reference's paths, knob prefix, forbidden
import, device seam, sink modules and compile-cache fingerprint keys —
and the two reports must be equal in rule, path, line, symbol and
message, finding for finding, in every disposition. Two differences are
stated and mapped: the control-plane import rule is ``torch-host-only``
in the port (``jnp-host-only`` in the reference), and the compile-cache
persist message ends "would load foreign compiled kernels" where the
reference's ends "would replay foreign XLA executables". A run over a
tree holding the port's package (a meta-test, a mutation tree) is the
port's analyzer alone on its own config.

``host-sync`` is mirrored like the host rules: given the reference's
sync vocabulary it reads jax snippets as the reference does. The two
rules that read jax constructs themselves (``tracer-safety``,
``jit-registry``) have counterparts in the port's own terms
(``tensor-branch``, ``kernel-registry``); their cases, and those of the
shape-contract pass, are twinned in torch terms in
``test_torch_analysis_device.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil

import pytest

from test_torch_kube_client import PORT, case_id, mirror, mirror_cases, run_mirrored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the rules whose names differ, port → reference
RULE_NAMES = {"torch-host-only": "jnp-host-only", "kernel-registry": "jit-registry", "tensor-branch": "tracer-safety"}
MESSAGE_DIFFS = (("would load foreign compiled kernels", "would replay foreign XLA executables"),)
# the reference's rules that read jax constructs (jit decorators and
# calls, static_argnames): their port counterparts read the port's own
# constructs (kernel launches, deviceplane.observe, tensor branches), so
# no report of theirs is compared with the reference's
JAX_RULES = ("tracer-safety", "jit-registry")
# the reference's sync vocabulary (its hostsync.py): jax's syncs, and jit
# and vmap bodies as device code whose functions return device values
REF_SYNC = dict(
    sync_methods=("item", "tolist", "block_until_ready"),
    sync_calls=("jax.device_get",),
    device_code_decorators=("jax.jit", "jit", "jax.vmap", "vmap"),
    producer_decorators=(),
)


def reference_config(**overrides):
    """The port's ``AnalysisConfig`` with the reference's paths, knob
    prefix and every other reference-specific field, ``overrides`` on top."""
    from karpenter_core_tpu.analysis import concurrency as ref_conc
    from karpenter_core_tpu.analysis import configprov as ref_prov
    from karpenter_core_tpu.analysis.engine import DEFAULT_CONFIG as REF
    from karpenter_core_tpu_torch.analysis.engine import AnalysisConfig

    port_fields = {f.name for f in dataclasses.fields(AnalysisConfig)}
    shared = {f.name: getattr(REF, f.name) for f in dataclasses.fields(REF) if f.name in port_fields}
    cfg = AnalysisConfig(
        **shared,
        package="karpenter_core_tpu",
        knob_prefix="KARPENTER_TPU_",
        forbidden_import="jax",
        device_seam=tuple(sorted(ref_conc._DEVICE_SEAM)),
        compile_fingerprint_keys=("jax", "jaxlib", "platform"),
        sink_modules=ref_conc._SINK_MODULES,
        sink_lock_ids=ref_conc._SINK_LOCK_IDS,
        knobs_begin=ref_prov.KNOBS_BEGIN,
        semantic_knobs=tuple(sorted(k[len("KARPENTER_TPU_"):] for k in ref_prov.SEMANTIC_KNOBS)),
        kernel_registry_modules=REF.jit_registry_modules,
        **REF_SYNC,
    )
    return dataclasses.replace(cfg, **overrides)


def _overrides(config) -> dict:
    """The fields a test set on a port ``AnalysisConfig``."""
    from karpenter_core_tpu_torch.analysis.engine import DEFAULT_CONFIG

    if config is None:
        return {}
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)
            if getattr(config, f.name) != getattr(DEFAULT_CONFIG, f.name)}


def _row(f) -> tuple:
    msg = f.message
    for port_text, ref_text in MESSAGE_DIFFS:
        msg = msg.replace(port_text, ref_text)
    return (RULE_NAMES.get(f.rule, f.rule), f.path, f.line, f.symbol, msg, f.severity)


def _stale_row(e) -> tuple:
    return (RULE_NAMES.get(e["rule"], e["rule"]), e["path"], e.get("symbol", ""), e["message"])


def _in_port_tree(paths, root) -> bool:
    return any(PORT in os.path.abspath(p).split(os.sep) for p in paths) or (
        root is not None and os.path.isdir(os.path.join(root, PORT)))


def dual(paths, root=None, config=None, baseline=None, rules=None):
    """The port's ``analyze_paths`` on ``paths``, held equal to the
    reference's on the same files (see the module docstring) → the port's
    report."""
    from karpenter_core_tpu.analysis import Baseline as RefBaseline
    from karpenter_core_tpu.analysis import analyze_paths as ref_analyze
    from karpenter_core_tpu.analysis.engine import AnalysisConfig as RefConfig
    from karpenter_core_tpu_torch.analysis import analyze_paths as port_analyze

    if _in_port_tree(paths, root):
        return port_analyze(paths, root=root, config=config, baseline=baseline, rules=rules)
    over = _overrides(config)
    port = port_analyze(paths, root=root, config=reference_config(**over), baseline=baseline, rules=rules)
    ref_fields = {f.name for f in dataclasses.fields(RefConfig)}
    ref_cfg = RefConfig(**{k: v for k, v in over.items() if k in ref_fields})
    ref_baseline = None if baseline is None else RefBaseline(
        [dict(e, rule=RULE_NAMES.get(e["rule"], e["rule"])) for e in baseline.entries])
    ref_rules = None if rules is None else [RULE_NAMES.get(r, r) for r in rules]
    ref = ref_analyze(paths, root=root, config=ref_cfg, baseline=ref_baseline, rules=ref_rules)
    if rules is None:  # the jax-construct rules and their counterparts read different code
        keep = lambda fs: [f for f in fs if RULE_NAMES.get(f.rule, f.rule) not in JAX_RULES]  # noqa: E731
        for rep in (port, ref):
            rep.findings, rep.suppressed, rep.baselined = keep(rep.findings), keep(rep.suppressed), keep(rep.baselined)
    for part in ("findings", "suppressed", "baselined"):
        assert sorted(map(_row, getattr(port, part))) == sorted(map(_row, getattr(ref, part))), part
    assert [_row(f) for f in port.findings] == [_row(f) for f in ref.findings]
    assert sorted(map(_stale_row, port.stale_baseline)) == sorted(map(_stale_row, ref.stale_baseline))
    assert (port.files_scanned, port.parse_errors) == (ref.files_scanned, ref.parse_errors)
    return port


# the port's names → the reference's, for a fixture tree held in the
# port's own terms (its package directory, its knob prefix)
TRANSLATE = (("karpenter_core_tpu_torch", "karpenter_core_tpu"), ("KARPENTER_TORCH_", "KARPENTER_TPU_"))


def _to_ref(text: str) -> str:
    for port_text, ref_text in TRANSLATE:
        text = text.replace(port_text, ref_text)
    return text


def _to_port(text: str) -> str:
    text = text.replace("KARPENTER_TPU_", "KARPENTER_TORCH_")
    return re.sub(r"\bkarpenter_core_tpu\b", PORT, text)


def _translated_tree(root: str) -> str:
    """A copy of fixture tree ``root`` in the reference's names (files of
    the same lines, so line numbers hold)."""
    ref_root = root.rstrip(os.sep) + "-ref"
    shutil.rmtree(ref_root, ignore_errors=True)
    for dirpath, _dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out_dir = os.path.join(ref_root, _to_ref(rel))
        os.makedirs(out_dir, exist_ok=True)
        for fn in files:
            if fn.endswith((".py", ".md")):
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    text = f.read()
                with open(os.path.join(out_dir, _to_ref(fn)), "w", encoding="utf-8") as f:
                    f.write(_to_ref(text))
    return ref_root


def dual_in_port_terms(paths, root=None, config=None, baseline=None, rules=None):
    """``dual`` for fixtures written in the port's own terms: the port's
    analyzer on its own config over the fixture tree, the reference's on
    a copy translated to its names (``TRANSLATE``), the two reports equal
    once the reference's is translated back → the port's report. A run
    over the repository itself is the port's analyzer alone."""
    from karpenter_core_tpu.analysis import analyze_paths as ref_analyze
    from karpenter_core_tpu.analysis.engine import AnalysisConfig as RefConfig
    from karpenter_core_tpu_torch.analysis import analyze_paths as port_analyze

    port = port_analyze(paths, root=root, config=config, baseline=baseline, rules=rules)
    if root is None or os.path.abspath(root) == REPO:
        return port
    ref_root = _translated_tree(root)
    ref_paths = [os.path.join(ref_root, _to_ref(os.path.relpath(p, root))) for p in paths]
    over = {k: tuple(_to_ref(v) for v in val) if isinstance(val, tuple) else val
            for k, val in _overrides(config).items()}
    ref_fields = {f.name for f in dataclasses.fields(RefConfig)}
    ref = ref_analyze(ref_paths, root=ref_root, config=RefConfig(**{k: v for k, v in over.items() if k in ref_fields}),
                      rules=rules)
    back = lambda f: (f.rule, _to_port(f.path), f.line, f.symbol, _to_port(f.message), f.severity)  # noqa: E731
    for part in ("findings", "suppressed", "baselined"):
        assert sorted(map(_row, getattr(port, part))) == sorted(map(back, getattr(ref, part))), part
    assert (port.files_scanned, port.parse_errors) == (ref.files_scanned, ref.parse_errors)
    return port


def analysis_mirror(file: str, replace: tuple = (), inject: dict = None):
    """The reference test module ``file`` on the port, its fixture runs
    through ``dual``."""
    mod = mirror(file, PORT, replace=(('"jnp-host-only"', '"torch-host-only"'),) + tuple(replace), inject=inject)
    mod.analyze_paths = dual
    return mod


def run_case(mod, case, tmp_path):
    cls, name, k = case
    run_mirrored(mod, cls, name, k, extra={"tmp_path": tmp_path})


# -- tests/test_static_analysis.py's host-rule cases --------------------------

FILE = "test_static_analysis.py"
# the jax-construct rules' cases, and the contract cases (jax.eval_shape,
# the reference's runtime asserts), are twinned in torch terms in
# test_torch_analysis_device.py and test_torch_contracts.py
NOT_PORTED = ("test_tracer_safety", "test_jit_registry", "test_contract_", "test_runtime_contract")
CASES = [c for c in mirror_cases(FILE) if not c[1].startswith(NOT_PORTED)]


def test_static_mirror_covers_the_host_rules():
    assert len(CASES) == 27
    assert len([c for c in CASES if c[1].startswith("test_host_sync")]) == 5
    assert len(mirror_cases(FILE)) - len(CASES) == 16


# jit-registry's config field is the reference's alone (the port's
# counterpart reads kernel_registry_modules)
STATIC_REPLACE = (
    ('JITREG_CONFIG = AnalysisConfig(jit_registry_modules=("snippet.py",))', "JITREG_CONFIG = None"),
)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_static_analysis_case_holds_the_port(case, tmp_path):
    run_case(analysis_mirror(FILE, STATIC_REPLACE), case, tmp_path)


def test_registered_rules_are_the_host_python_families():
    from karpenter_core_tpu.analysis import registered_rules as ref_rules
    from karpenter_core_tpu_torch.analysis import registered_rules

    to_port = {ref: port for port, ref in RULE_NAMES.items()}
    assert set(registered_rules()) == {to_port.get(r, r) for r in ref_rules()}


def test_port_import_rule_forbids_torch_in_host_only_packages(tmp_path):
    """The port's own config: ``torch`` (not ``jax``) is the forbidden
    import of its host-only packages; a module outside them may import it."""
    from karpenter_core_tpu_torch.analysis import analyze_paths

    pkg = tmp_path / PORT
    (pkg / "state").mkdir(parents=True)
    (pkg / "solver").mkdir()
    (pkg / "state" / "x.py").write_text("import torch\nimport jax\n")
    (pkg / "solver" / "y.py").write_text("import torch\n")
    report = analyze_paths([str(pkg)], root=str(tmp_path), rules=["torch-host-only"])
    assert [(f.path, f.line, f.message) for f in report.findings] == [(
        f"{PORT}/state/x.py", 1,
        "host-only module imports 'torch' — torch/backend init must stay behind the solver boundary "
        "(solver/backend.py)")]


def test_port_tree_analyzes_clean_with_a_justified_baseline():
    """The gate over the port: no finding, no stale entry, every baseline
    entry justified, and the port's own paths in the config."""
    from karpenter_core_tpu_torch.analysis import Baseline, analyze_repo, default_baseline_path
    from karpenter_core_tpu_torch.analysis.engine import DEFAULT_CONFIG

    report = analyze_repo()
    assert report.ok, [f.format() for f in report.findings] + report.stale_baseline
    assert report.files_scanned > 120
    for entry in Baseline.load(default_baseline_path()).entries:
        assert entry["path"].startswith(PORT + "/") and len(entry.get("justification", "")) > 40, entry
    for field in dataclasses.fields(DEFAULT_CONFIG):
        value = getattr(DEFAULT_CONFIG, field.name)
        if isinstance(value, tuple) and value and "/" in value[0]:
            assert all(v.startswith(PORT + "/") for v in value), field.name
            assert all(os.path.exists(os.path.join(REPO, v.split("::")[0])) for v in value), field.name


def test_concurrency_modules_cover_every_threading_module():
    """Every port module that creates or acquires a threading primitive
    is in ``concurrency_modules``."""
    import ast

    from karpenter_core_tpu_torch.analysis.engine import DEFAULT_CONFIG

    primitives = {"Lock", "RLock", "Condition", "Event", "Thread", "Semaphore", "BoundedSemaphore", "Barrier"}
    found = set()
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, PORT)):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "analysis", "_build")]
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tree = ast.parse(open(path, encoding="utf-8").read())
            if any(isinstance(n, ast.Attribute) and n.attr in primitives and isinstance(n.value, ast.Name)
                   and n.value.id == "threading" for n in ast.walk(tree)):
                found.add(os.path.relpath(path, REPO).replace(os.sep, "/"))
    found.discard(f"{PORT}/witness.py")  # the witnessed run's driver holds no primitive of its own
    assert found and found <= set(DEFAULT_CONFIG.concurrency_modules), sorted(found - set(DEFAULT_CONFIG.concurrency_modules))
    for module in ("buildlib.py", "solver/backend.py", "operator/controller.py", "operator/leaderelection.py"):
        assert f"{PORT}/{module}" in DEFAULT_CONFIG.concurrency_modules


def test_analysis_imports_the_standard_library_only():
    """The analyzer imports neither torch, jax nor either package (its
    own modules aside): a CLI run leaves them out of ``sys.modules``."""
    import subprocess
    import sys

    code = ("import sys, runpy\n"
            "sys.argv = ['analysis', '--format', 'json']\n"
            "try:\n"
            "    runpy.run_module('karpenter_core_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'numpy', 'karpenter_core_tpu')"
            " or (m.startswith('karpenter_core_tpu_torch.') and not m.startswith('karpenter_core_tpu_torch.analysis')))\n"
            "print('BAD', bad, 'CODE', code)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip().splitlines()[-1] == "BAD [] CODE 0", proc.stdout[-2000:] + proc.stderr[-2000:]


def test_contracts_flag_passes_on_the_cpu(capsys):
    """``--contracts --device cpu``: every contract at prime sizes through
    the plain versions, the reference's six checked among them; exit 0."""
    import json

    from karpenter_core_tpu_torch.analysis.__main__ import main

    assert main(["--contracts", "--device", "cpu", "--format", "json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["ok"] and got["device"] == "cpu" and all(got["reference_covered"].values())
    assert sum(c["checked"] for c in got["contracts"]) >= 6


# -- the mutation harnesses on the port's sources -----------------------------
#
# The reference harnesses' mutants (tests/test_cachesound.py,
# test_concurrency.py, test_configprov.py), each seeded into a copy of the
# port's sources, must each be killed: a new finding of the expected rule.
# Where the port's source reads otherwise, the mutant is the same
# regression at the port's own line (``PORT_ANCHORS``). Two reference
# mutants have no counterpart and are not seeded (``NO_COUNTERPART``).

P = PORT + "/"
PORT_ANCHORS = {
    "merge-key-drop-stream": (P + "solver/solver.py",
                              'mkey = ("vector", int(self._MERGE_SCAN_CAP), tuple(r["_rkey"] for r in records))',
                              'mkey = ("vector", int(self._MERGE_SCAN_CAP))'),
    "seed-key-drop-exclusion": (P + "solver/solver.py",
                                "skey = key + (self._seed_exclusion_key(), self._sim_drained, self._tenant_scope)",
                                "skey = key + (self._sim_drained, self._tenant_scope)"),
    "seed-key-drop-tenantscope": (P + "solver/solver.py",
                                  "skey = key + (self._seed_exclusion_key(), self._sim_drained, self._tenant_scope)",
                                  "skey = key + (self._seed_exclusion_key(), self._sim_drained)"),
    "compat-key-drop-poolfp": (P + "solver/solver.py", "(pool_fp, sid, device),", "(sid, device),"),
    "set-iter-pool-fingerprint": (P + "solver/incremental.py",
                                  "tuple(sorted((t.key, t.value, t.effect) for t in np_.spec.template.taints)),",
                                  "tuple({(t.key, t.value, t.effect) for t in np_.spec.template.taints}),"),
    # the port's compile-cache plane: torch, CUDA and the card's capability
    "restore-drop-jaxversion-witness": (
        P + "solver/warmstore.py",
        'if (\n        stored.get("torch") != live["torch"]\n        or stored.get("cuda") != live["cuda"]\n'
        '        or stored.get("capability") != live["capability"]\n    ):',
        "if False:"),
    "reorder-flush-under-cv": (
        P + "fleet/megasolve.py",
        "                with self._backend.lock:\n"
        "                    # analysis: allow-wait-under-lock(device — backend.lock exists to serialize this dispatch "
        "and its output reads; the flusher holds nothing else, so the edge cannot deadlock)\n"
        "                    packed = self._backend.pack_jobs(all_jobs, all_metas, device=device, stats=self.stats)\n"
        '                    flags = list(getattr(self._backend, "last_job_flags", ()) or ())',
        "                with self._cv:\n"
        "                    with self._backend.lock:\n"
        "                        packed = self._backend.pack_jobs(all_jobs, all_metas, device=device, stats=self.stats)\n"
        '                        flags = list(getattr(self._backend, "last_job_flags", ()) or ())'),
    "ordinal-into-snapshot": (P + "solver/warmstore.py", "rows.append((pool_fp, sig, device, row))",
                              "rows.append((pool_fp, sid, device, row))"),
    "job-key-drop-backendtoken": (P + "solver/solver.py",
                                  '            backend.job_token(self.device) if backend is not None else ("ffd",),\n', ""),
    # the port's one numeric knob parse, and its one directory listing
    # in a determinism-scoped module
    "cachecap-unguard": (P + "solver/solver.py",
                         '    try:\n        return max(1, int(os.environ.get("KARPENTER_TORCH_CATALOG_CACHE_MAX", "8")))\n'
                         "    except ValueError:\n        return 8\n",
                         '    return int(os.environ.get("KARPENTER_TORCH_CATALOG_CACHE_MAX", "8"))\n'),
    "native-unsorted-glob": (P + "solver/backend.py", "for name in sorted(os.listdir(buildlib.CSRC)):",
                             "for name in os.listdir(buildlib.CSRC):"),
}
# the route memo's constraint-engine token: the port has one constraint
# engine, and its route key carries that engine's name as a constant
NO_COUNTERPART = {"route-key-drop-enginetoken"}
# the files the port's harness copies beyond the reference's (mirrored) lists
EXTRA_MUT_FILES = {"test_configprov.py": [P + "solver/backend.py"]}


def port_harness(file: str):
    """The mirror of the reference test ``file`` with its mutants on the
    port's sources → (module, [(name, rel, old, new, rule)])."""
    if file == "test_configprov.py":
        mod = mirror(file, PORT, replace=(("KARPENTER_TPU_", "KARPENTER_TORCH_"),))
    else:
        mod = analysis_mirror(file)
    mod._MUT_FILES = list(mod._MUT_FILES) + EXTRA_MUT_FILES.get(file, [])
    mutants = []
    for name, rel, old, new, rule in mod._MUTANTS:
        if name in NO_COUNTERPART:
            continue
        if name in PORT_ANCHORS:
            rel, old, new = PORT_ANCHORS[name]
        mutants.append((name, rel, old, new, rule))
    mod._MUTANTS = mutants
    return mod, mutants


def mutant_killed(mod, mutant, root: str) -> None:
    name, rel, old, new, rule = mutant
    mod._build_tree(root)
    path = os.path.join(root, rel)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert old in src, f"mutant {name}: its anchor is not in {rel}"
    with open(path, "w", encoding="utf-8") as f:
        f.write(src.replace(old, new, 1))
    report = mod._analyze_tree(root)
    assert any(f.rule == rule for f in report.findings), (name, [f.format() for f in report.findings])


def mutant_ids(mutants) -> list:
    return [m[0] for m in mutants]
