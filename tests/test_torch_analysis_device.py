"""The analyzer's device half, on the CPU: ``host-sync``,
``kernel-registry`` and ``tensor-branch`` (``karpenter_core_tpu_torch/
analysis/``), and the entry points' default device.

- **Twins.** Each reference fixture test of the jax-construct families
  (``tests/test_static_analysis.py``: host-sync ×5, tracer-safety ×4,
  jit-registry ×8) has a twin in torch terms: the reference's snippet
  through the reference's analyzer, the twin's through the port's, and
  the two verdicts equal (findings and their symbols, suppressions, the
  stated word of each message). ``host-sync`` is also mirrored against
  the reference's own snippets in ``test_torch_analysis.py``.
- **The port's own forms**: the sync vocabulary (``.cpu()``,
  ``.numpy()``, ``torch.cuda.synchronize``, a cast of a device value),
  scoped markers, a launch observed under another kernel's name, shape
  reads and ``is None`` tests that read no value.
- **Mutants** on a copy of the port's modules, each killed by the rule it
  breaks: a sync marker removed, an entry point's ``observe`` removed, a
  ``static_names`` typo, a branch on a launch's output.
- ``python -m karpenter_core_tpu_torch.witness`` and ``... analysis
  --witness`` ask for the card when no ``--device`` is given, and fail
  without one.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "karpenter_core_tpu_torch"


def _run(tmp_path, side: str, code: str, rules, config_kwargs: dict):
    """``code`` as ``snippet.py`` under ``tmp_path/side`` through that
    side's analyzer (``ref``: the JAX package's) → its report."""
    if side == "ref":
        from karpenter_core_tpu.analysis import AnalysisConfig, analyze_paths
    else:
        from karpenter_core_tpu_torch.analysis import AnalysisConfig, analyze_paths
    root = tmp_path / side
    root.mkdir(exist_ok=True)
    path = root / "snippet.py"
    path.write_text(textwrap.dedent(code))
    config = AnalysisConfig(**config_kwargs) if config_kwargs else None
    report = analyze_paths([str(path)], root=str(root), rules=rules, config=config)
    assert report.parse_errors == [] and report.files_scanned == 1
    return report


def src(*parts: str) -> str:
    """Snippet parts, each dedented on its own, as one module."""
    return "".join(textwrap.dedent(p) for p in parts)


def _verdict(report, word: str) -> tuple:
    return (len(report.findings), sorted(f.symbol for f in report.findings), len(report.suppressed),
            all(word in f.message for f in report.findings))


# -- the reference's fixtures (their snippets, tests/test_static_analysis.py) ------

REF_HOT = """
    import jax
    import jax.numpy as jnp
    import numpy as np

    @jax.jit
    def kernel(x):
        return x * 2

    def driver(x):
        y = kernel(x)
        {line}
"""

PORT_HOT = """
    import numpy as np
    import torch
    from karpenter_core_tpu_torch import buildlib
    from karpenter_core_tpu_torch.tracing import deviceplane

    KERNEL = buildlib.CudaKernel("k.cu", "k_launch", [], name="mod.kernel")

    @deviceplane.observe("mod.kernel")
    def kernel(x):
        out = torch.empty_like(x)
        KERNEL.launch(x.data_ptr(), out.data_ptr())
        return out

    def driver(x):
        y = kernel(x)
        {line}
"""

REF_KERNEL_HDR = """
    import jax
    from functools import partial
    from karpenter_core_tpu.tracing import deviceplane
"""
PORT_KERNEL_HDR = """
    import torch
    from karpenter_core_tpu_torch import buildlib
    from karpenter_core_tpu_torch.tracing import deviceplane

    KERNEL = buildlib.CudaKernel("k.cu", "k_launch", [], name="mod.kernel")
"""
PORT_SUBCLASS = PORT_KERNEL_HDR + """
    class _Kernel(buildlib.CudaKernel):
        def __init__(self):
            super().__init__("k.cu", "k_launch", [], name="mod.sub")

        def launch(self, x):
            super().launch(x.data_ptr())

    SUB = _Kernel()
"""

HOT = {"device_hot_modules": ("snippet.py",)}
REF_JITREG = {"jit_registry_modules": ("snippet.py",)}
KREG = {"kernel_registry_modules": ("snippet.py",)}

# (id, reference rule, reference snippet, its config, its word;
#  port rule, port snippet, its config, its word)
TWINS = [
    # host-sync
    ("host-sync-asarray", "host-sync", REF_HOT.format(line="return np.asarray(y)"), HOT, "np.asarray",
     "host-sync", PORT_HOT.format(line="return np.asarray(y)"), HOT, "np.asarray"),
    ("host-sync-item", "host-sync", REF_HOT.format(line="return y.sum().item()"), HOT, "'.item()'",
     "host-sync", PORT_HOT.format(line="return y.sum().item()"), HOT, "'.item()'"),
    ("host-sync-host-value", "host-sync",
     REF_HOT.format(line="y = np.zeros(3)\n        return np.asarray(y)"), HOT, "",
     "host-sync", PORT_HOT.format(line="y = np.zeros(3)\n        return np.asarray(y)"), HOT, ""),
    ("host-sync-not-hot", "host-sync", REF_HOT.format(line="return np.asarray(y)"), {}, "",
     "host-sync", PORT_HOT.format(line="return y.cpu()"), {}, ""),
    ("host-sync-suppressed", "host-sync",
     REF_HOT.format(line="return np.asarray(y)  # analysis: allow-host-sync"), HOT, "",
     "host-sync", PORT_HOT.format(line="return y.cpu()  # analysis: allow-host-sync"), HOT, ""),
    # tracer-safety → tensor-branch: the port's check (a) holds the
    # device-hot modules, the reference's every jit body
    ("branch-if", "tracer-safety", """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
     """, {}, "'if'",
     "tensor-branch", """
        import torch

        def f(x: torch.Tensor):
            if x > 0:
                return x
            return -x
     """, HOT, "'if'"),
    ("branch-shape-and-static", "tracer-safety", """
        import jax
        from functools import partial

        @partial(jax.jit, static_argnames=("mode",))
        def f(x, mode):
            if x.shape[0] > 4 and mode == "wide":
                return x * 2
            return x
     """, {}, "",
     "tensor-branch", """
        import torch
        from karpenter_core_tpu_torch.tracing import deviceplane

        @deviceplane.observe("mod.f", static_names=("mode",))
        def f(x: torch.Tensor, mode):
            if x.shape[0] > 4 and mode == "wide":
                return x * 2
            return x
     """, HOT, ""),
    ("branch-propagates", "tracer-safety", """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x):
            y = jnp.sum(x)
            while y > 0:
                y = y - 1
            return y
     """, {}, "'while'",
     "tensor-branch", """
        import torch

        def f(x: torch.Tensor):
            y = torch.sum(x)
            while y > 0:
                y = y - 1
            return y
     """, HOT, "'while'"),
    ("branch-static-typo", "tracer-safety", """
        import jax
        from functools import partial

        @partial(jax.jit, static_argnames=("k_opne",))
        def f(x, k_open=4):
            return x * k_open
     """, {}, "k_opne",
     "tensor-branch", """
        from karpenter_core_tpu_torch.tracing import deviceplane

        @deviceplane.observe("mod.f", static_names=("k_opne",))
        def f(x, k_open=4):
            return x * k_open
     """, {}, "k_opne"),
    # jit-registry → kernel-registry
    ("registry-naked", "jit-registry", src(REF_KERNEL_HDR, """
        @partial(jax.jit, static_argnames=("n",))
        def kernel(x, n):
            return x * n
     """), REF_JITREG, "observe_jit",
     "kernel-registry", src(PORT_KERNEL_HDR, """
        def kernel(x, n):
            KERNEL.launch(x.data_ptr(), n)
            return x
     """), KREG, "deviceplane.observe"),
    ("registry-observed", "jit-registry", src(REF_KERNEL_HDR, """
        @deviceplane.observe_jit("mod.kernel", static_names=("n",))
        @partial(jax.jit, static_argnames=("n",))
        def kernel(x, n):
            return x * n
     """), REF_JITREG, "",
     "kernel-registry", src(PORT_KERNEL_HDR, """
        @deviceplane.observe("mod.kernel", static_names=("n",))
        def kernel(x, n):
            KERNEL.launch(x.data_ptr(), n)
            return x
     """), KREG, ""),
    ("registry-bare", "jit-registry", """
        import jax

        def build(f):
            return jax.jit(f)
     """, REF_JITREG, "deviceplane.wrap",
     "kernel-registry", """
        from karpenter_core_tpu_torch import buildlib

        def build():
            return buildlib.CudaKernel("k.cu", "k_launch", [])
     """, KREG, "name="),
    ("registry-named", "jit-registry", """
        import jax
        from karpenter_core_tpu.tracing import deviceplane

        def build(f):
            return deviceplane.wrap("mod.f", jax.jit(f))
     """, REF_JITREG, "",
     "kernel-registry", """
        from karpenter_core_tpu_torch import buildlib

        def build():
            return buildlib.CudaKernel("k.cu", "k_launch", [], name="mod.k")
     """, KREG, ""),
    ("registry-indirect", "jit-registry", """
        from jax.experimental.shard_map import shard_map

        def build(f, mesh, specs):
            return shard_map(f, mesh=mesh, in_specs=specs, out_specs=specs)
     """, REF_JITREG, "shard_map",
     "kernel-registry", src(PORT_SUBCLASS, """
        def build(x):
            SUB.launch(x)
     """), KREG, "SUB.launch"),
    ("registry-no-launch", "jit-registry", """
        import jax

        @jax.vmap
        def rowwise(x):
            return x + 1
     """, REF_JITREG, "",
     "kernel-registry", src(PORT_KERNEL_HDR, """
        def rowwise():
            return KERNEL.build()
     """), KREG, ""),
    ("registry-marker", "jit-registry", """
        import jax

        def build(f):
            return jax.jit(f)  # analysis: allow-jit-registry(bench-only throwaway)
     """, REF_JITREG, "",
     "kernel-registry", src(PORT_KERNEL_HDR, """
        def build(x):
            KERNEL.launch(x.data_ptr())  # analysis: allow-kernel-registry(bench-only throwaway)
     """), KREG, ""),
    ("registry-off-module", "jit-registry", """
        import jax

        @jax.jit
        def kernel(x):
            return x + 1
     """, {}, "",
     "kernel-registry", src(PORT_KERNEL_HDR, """
        def kernel(x):
            KERNEL.launch(x.data_ptr())
     """), {}, ""),
]


def test_every_reference_fixture_has_a_twin():
    """Host-sync ×5, tracer-safety ×4, jit-registry ×8: as many twins as
    the reference has fixture tests of each family."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "tests", "test_static_analysis.py"), encoding="utf-8").read())
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    for family, rule in (("test_host_sync", "host-sync"), ("test_tracer_safety", "tracer-safety"),
                         ("test_jit_registry", "jit-registry")):
        assert len([n for n in names if n.startswith(family)]) == len([t for t in TWINS if t[1] == rule])


@pytest.mark.parametrize("twin", TWINS, ids=[t[0] for t in TWINS])
def test_twin_gives_the_references_verdict(twin, tmp_path):
    _id, ref_rule, ref_code, ref_cfg, ref_word, port_rule, port_code, port_cfg, port_word = twin
    ref = _verdict(_run(tmp_path, "ref", ref_code, [ref_rule], ref_cfg), ref_word)
    port = _verdict(_run(tmp_path, "port", port_code, [port_rule], port_cfg), port_word)
    assert port == ref and ref[3]
    assert ref[0] + ref[2] > 0 or not ref_word  # a found or suppressed case finds something


# -- the port's own forms ----------------------------------------------------------


@pytest.mark.parametrize("line,word", [
    ("return y.cpu()", "'.cpu()'"),
    ("return y.numpy()", "'.numpy()'"),
    ("return y.tolist()", "'.tolist()'"),
    ("torch.cuda.synchronize()\n        return y", "'torch.cuda.synchronize'"),
    ("return int(y.sum())", "'int()' on device value 'y'"),
    ("return np.ascontiguousarray(y)", "'np.ascontiguousarray' on device value 'y'"),
])
def test_host_sync_flags_the_port_vocabulary(line, word, tmp_path):
    report = _run(tmp_path, "port", PORT_HOT.format(line=line), ["host-sync"], HOT)
    assert [(f.symbol, word in f.message) for f in report.findings] == [("driver", True)]


def test_host_sync_reads_a_scoped_marker_and_leaves_others(tmp_path):
    code = PORT_HOT.format(
        line="a = y.cpu()  # analysis: allow-host-sync(one download after the launch)\n"
             "        n = 0\n"
             "        b = y.cpu()  # analysis: allow-tensor-branch(not this rule's)\n"
             "        return a, b, n")
    report = _run(tmp_path, "port", code, ["host-sync"], HOT)
    line_b = next(i for i, text in enumerate(textwrap.dedent(code).splitlines(), 1) if "b = y.cpu()" in text)
    assert [(f.line, "'.cpu()'" in f.message) for f in report.findings] == [(line_b, True)]
    assert report.suppressed == []


def test_host_sync_skips_device_code_bodies(tmp_path):
    """Under the reference's vocabulary a jit body is device code; under
    the port's no body is, and an observed wrapper is host code."""
    ref_like = dict(HOT, device_code_decorators=("jax.jit",), sync_methods=("item",), producer_decorators=())
    code = REF_HOT.format(line="return y")
    assert _run(tmp_path, "port", code.replace("return x * 2", "return x.item()"), ["host-sync"],
                ref_like).findings == []
    port = _run(tmp_path, "port", PORT_HOT.format(line="return y").replace("return out", "return out.cpu()"),
                ["host-sync"], HOT)
    assert [f.symbol for f in port.findings] == ["kernel"]


@pytest.mark.parametrize("test,found", [
    ("y.any()", True), ("(y > 0).all() and n", True), ("y is None", False), ("y.shape[0] > 3", False),
    ("y.numel()", False), ("len(y) > 2", False), ("y.device.type == 'cuda'", False), ("bool(y.any())", False),
    ("y.item() > 0", False), ("(y, y)", False),
])
def test_tensor_branch_reads_values_not_shapes(test, found, tmp_path):
    """A branch on a launch's output: a finding when its test reads the
    tensor's value, none for a shape read, an identity test, or an
    explicit conversion (that line is host-sync's)."""
    code = PORT_HOT.format(line=f"n = 3\n        if {test}:\n            return 1\n        return 0")
    report = _run(tmp_path, "port", code, ["tensor-branch"], HOT)
    assert [f.symbol for f in report.findings] == (["driver"] if found else [])


def test_tensor_branch_ternary_for_and_assert(tmp_path):
    code = PORT_HOT.format(line=(
        "a = 1 if y.any() else 0\n"
        "        assert y.sum() > 0\n"
        "        for v in y:\n"
        "            pass\n"
        "        for k in (y, y):\n"
        "            pass\n"
        "        return a"))
    report = _run(tmp_path, "port", code, ["tensor-branch"], HOT)
    assert [m.message.split(" on ")[0] for m in report.findings] == [
        "Python ternary", "Python 'assert'", "Python 'for' iteration"]


def test_tensor_branch_static_names_mutable_default(tmp_path):
    code = """
        from karpenter_core_tpu_torch.tracing import deviceplane

        @deviceplane.observe("mod.f", static_names=("keys",))
        def f(x, keys=[]):
            return x
    """
    report = _run(tmp_path, "port", code, ["tensor-branch"], {})
    assert ["unhashable default" in f.message for f in report.findings] == [True]


def test_kernel_registry_holds_the_observed_name(tmp_path):
    """A launch observed under another entry point's name splits its
    counts from the kernel's own."""
    code = src(PORT_KERNEL_HDR, """
        @deviceplane.observe("mod.other")
        def kernel(x):
            KERNEL.launch(x.data_ptr())
    """)
    report = _run(tmp_path, "port", code, ["kernel-registry"], KREG)
    assert ["entry point 'mod.other'" in f.message and "'mod.kernel'" in f.message for f in report.findings] == [True]


def test_kernel_registry_takes_a_subclass_launch_from_an_entry_point(tmp_path):
    """``compat_kernels.py``'s shape: the subclass's ``super().launch`` is
    reached only from an observed wrapper; its name comes from
    ``super().__init__``, which must pass one."""
    code = src(PORT_SUBCLASS, """
        @deviceplane.observe("mod.sub")
        def wrapper(x):
            SUB.launch(x)
    """)
    assert _run(tmp_path, "port", code, ["kernel-registry"], KREG).findings == []
    unnamed = code.replace(', name="mod.sub")', ")")
    report = _run(tmp_path, "port", unnamed, ["kernel-registry"], KREG)
    assert [(f.symbol, "name=" in f.message) for f in report.findings] == [("_Kernel.__init__", True)]


def test_the_port_is_clean_under_the_three_rules():
    from karpenter_core_tpu_torch.analysis import analyze_repo

    report = analyze_repo(rules=["host-sync", "kernel-registry", "tensor-branch"], use_baseline=False)
    assert report.findings == [] and report.suppressed == [] and report.stale_baseline == []


# -- mutants on a copy of the port's modules -----------------------------------------

P = PORT + "/"
MUTANTS = [
    ("pack-sync-marker-removed", P + "solver/pack.py",
     "            # analysis: allow-host-sync(the one download of a class launch: its plans are host arrays)\n", "",
     "host-sync"),
    ("pack-existing-unobserved", P + "solver/pack.py", '@deviceplane.observe("pack.pack_existing")\n', "",
     "kernel-registry"),
    ("ffd-static-names-typo", P + "solver/pack.py",
     '@deviceplane.observe("pack.ffd_pack_batched", static_names=("k_open",))',
     '@deviceplane.observe("pack.ffd_pack_batched", static_names=("k_opne",))', "tensor-branch"),
    ("pack-branch-on-assign", P + "solver/pack.py",
     "        assign, free_out = pack_existing(*(torch.from_numpy(a).to(dev) for a in inputs))\n",
     "        assign, free_out = pack_existing(*(torch.from_numpy(a).to(dev) for a in inputs))\n"
     "        if assign.any():\n            pass\n", "tensor-branch"),
]


def _port_copy(root) -> list:
    from karpenter_core_tpu_torch.analysis.engine import DEFAULT_CONFIG

    rels = sorted(set(DEFAULT_CONFIG.device_hot_modules) | set(DEFAULT_CONFIG.kernel_registry_modules))
    for rel in rels:
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), os.path.join(root, rel))
    return rels


def _analyze_copy(root, rels):
    from karpenter_core_tpu_torch.analysis import analyze_paths

    return analyze_paths([os.path.join(root, r) for r in rels], root=str(root),
                         rules=["host-sync", "kernel-registry", "tensor-branch"])


def test_the_unmutated_copy_is_clean(tmp_path):
    rels = _port_copy(tmp_path)
    assert _analyze_copy(tmp_path, rels).findings == []


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_mutant_is_killed(mutant, tmp_path):
    name, rel, old, new, rule = mutant
    rels = _port_copy(tmp_path)
    path = os.path.join(tmp_path, rel)
    src = open(path, encoding="utf-8").read()
    assert src.count(old) == 1, f"mutant {name}: its anchor is not in {rel}"
    with open(path, "w", encoding="utf-8") as f:
        f.write(src.replace(old, new))
    report = _analyze_copy(tmp_path, rels)
    assert [f.rule for f in report.findings if f.path == rel] and {f.rule for f in report.findings} == {rule}, (
        name, [f.format() for f in report.findings])


# -- the entry points' default device ------------------------------------------------

NO_CARD = "import torch\ntorch.cuda.is_available = lambda: False\nimport runpy, sys\n"


def test_witness_asks_for_the_card_by_default():
    code = NO_CARD + f"sys.argv = ['witness']\nrunpy.run_module('{PORT}.witness', run_name='__main__')\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0 and "device cuda requested but torch.cuda.is_available() is False" in proc.stderr, (
        proc.returncode, proc.stderr[-2000:])


def test_analysis_witness_asks_for_the_card_by_default(monkeypatch):
    import torch

    from karpenter_core_tpu_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cuda requested"):
        main(["--witness"])
