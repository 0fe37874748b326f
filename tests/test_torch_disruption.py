"""The port's disruption ≡ the JAX package's: its own tests on the port.

``karpenter_core_tpu_torch/disruption/`` is the port's copy of the JAX
package's consolidation loop. Every test of the JAX package's disruption
test files runs here from its own source with the port's package in
place of the JAX package's (its own assertions then hold the port):

- ``tests/test_disruption.py``: markers, empty / single / multi-node
  consolidation, blockers, PDBs, orchestration, the screens;
- ``tests/test_disruption_budgets.py``: the cron matcher and budgets;
- ``tests/test_disrupt_engine.py``: the batched engine against the
  sequential path, its memos, stats, spans and caps;
- ``tests/test_tpu_consolidation.py``: the repack bound and the batched
  solver's simulations;
- ``tests/test_consolidation_port.py``: the reference's consolidation
  scenarios.

The mirrored ``helpers.Env`` is the port's, its provisioner on the CPU
(``device="cpu"``: the screens, the repack bound and the simulations run
the plain versions). The knobs the port keeps as module constants take
the value a scenario's ``setenv`` of the JAX knob would give
(``_set_knob``); ``KARPENTER_TPU_DISRUPT_ENGINE`` and
``KARPENTER_TPU_INCREMENTAL`` become their ``KARPENTER_TORCH_`` twins.

Left out, with the reason:

- ``test_disrupt_engine.py::TestSubsetScreenKernel::test_subset_generalizes_prefix``
  calls the JAX package's jit screens directly; the port's screens are
  held to them, the subset screen on prefix masks included, in
  ``tests/test_torch_disrupt_screen.py``.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import itertools
import re
import sys
import types

import pytest

from test_torch_kube_client import PORT, TESTS, case_id, mirror
from test_torch_oracle import same_start

FILES = {
    "test_disruption.py": 30,
    "test_disruption_budgets.py": 22,
    "test_disrupt_engine.py": 40,
    "test_tpu_consolidation.py": 8,
    "test_consolidation_port.py": 9,
}
LEFT_OUT = {("test_disrupt_engine.py", "TestSubsetScreenKernel", "test_subset_generalizes_prefix")}

# the JAX knobs the port keeps as constants: (module, attribute or _CAPS
# key, default, parse as the reference parses the variable)
_KNOBS = {
    "KARPENTER_TPU_DISRUPT_MAX_CANDIDATES": ("disruption.methods", "MAX_CANDIDATES", 100),
    "KARPENTER_TPU_DISRUPT_MAX_CANDIDATES_TPU": ("disruption.methods", "MAX_CANDIDATES_TPU", 1000),
    "KARPENTER_TPU_DISRUPT_FAMILY_MAX": ("disruption.engine", "FAMILY_MAX", 8192),
    "KARPENTER_TPU_DISRUPT_ALT_REPACKS": ("disruption.engine", "ALT_REPACKS", 2),
    "KARPENTER_TPU_DISRUPT_BOUNDS_CACHE_MAX": ("solver.incremental", "disruptbounds", 64),
    "KARPENTER_TPU_DISRUPT_VERIFY_CACHE_MAX": ("solver.incremental", "disruptverify", 4096),
    "KARPENTER_TPU_TRACE": ("tracing.tracer", "TRACE", True),
}


def _set_knob(monkeypatch, name: str, raw) -> None:
    """A scenario's ``setenv`` (``raw`` a string) or ``delenv`` (``raw``
    None) of a JAX knob the port keeps as a constant: the constant takes
    the value the reference reads from the variable (its default for an
    absent or unparsable value)."""
    module, attr, default = _KNOBS[name]
    mod = importlib.import_module(f"{PORT}.{module}")
    if attr == "TRACE":
        value = default if raw is None else raw != "0"
    else:
        try:
            value = default if raw is None else int(raw)
        except ValueError:
            value = default
    if module == "solver.incremental":
        monkeypatch.setitem(mod._CAPS, attr, value)
    else:
        monkeypatch.setattr(mod, attr, value)


def cpu_scheduler(*args, **kwargs):
    from karpenter_core_tpu_torch.solver import TorchScheduler

    return TorchScheduler(*args, device="cpu", **kwargs)


def disrupt_helpers():
    """``tests/helpers.py`` over the port's classes with the Env's
    provisioner on the CPU (module ``_port_disrupt_helpers``)."""
    mod = sys.modules.get("_port_disrupt_helpers")
    if mod is None:
        src = re.sub(r"\bkarpenter_core_tpu\b", PORT, (TESTS / "helpers.py").read_text())
        old = "Provisioner(self.kube, self.provider, self.cluster, recorder=self.recorder)"
        assert old in src
        src = src.replace(old, old[:-1] + ', device="cpu")')
        mod = types.ModuleType("_port_disrupt_helpers")
        mod.__file__ = str(TESTS / "helpers.py")
        sys.modules["_port_disrupt_helpers"] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def _replacements(file: str) -> tuple:
    src = (TESTS / file).read_text()
    out = [
        ("from _port_helpers import", "from _port_disrupt_helpers import"),
        ("from {pkg}.solver import TPUScheduler, incremental", "from {pkg}.solver import incremental"),
    ]
    for name in _KNOBS:
        for call in (f'monkeypatch.setenv("{name}", ', f'monkeypatch.delenv("{name}", raising=False)'):
            if call in src:
                new = (f'_set_knob(monkeypatch, "{name}", ' if "setenv" in call
                       else f'_set_knob(monkeypatch, "{name}", None)')
                out.append((call, new))
    for name in ("KARPENTER_TPU_DISRUPT_ENGINE", "KARPENTER_TPU_INCREMENTAL"):
        out.append((f'"{name}"', '"' + name.replace("KARPENTER_TPU_", "KARPENTER_TORCH_") + '"'))
    return tuple(out)


def port_mirror(file: str):
    disrupt_helpers()
    return mirror(file, PORT, replace=_replacements(file),
                  inject={"_set_knob": _set_knob, "TPUScheduler": cpu_scheduler})


def file_cases(file: str) -> list:
    """(class or None, test, case index) for every test of ``file``, one
    entry per case of the product of its ``parametrize`` decorators."""
    out = []

    def add(cls, fn):
        n_cases = 1
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and getattr(dec.func, "attr", "") == "parametrize":
                n_cases *= len(dec.args[1].elts)
        out.extend((cls, fn.name, case) for case in range(n_cases))

    for node in ast.parse((TESTS / file).read_text()).body:
        if isinstance(node, ast.ClassDef):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test"):
                    add(node.name, fn)
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            add(None, node)
    return out


def run_case(mod, cls, name, case, extra: dict) -> None:
    """Run one case of a mirrored test: its ``parametrize`` values the
    ``case``-th of their product, its other arguments from ``extra`` or
    the module's own fixtures."""
    owner = getattr(mod, cls)() if cls else None
    fn = getattr(owner, name) if owner is not None else getattr(mod, name)
    if owner is not None and hasattr(owner, "setup_method"):
        owner.setup_method(fn)
    marks = [m for m in getattr(fn, "pytestmark", ()) if m.name == "parametrize"]
    kwargs = {}
    for mark, values in zip(marks, list(itertools.product(*[m.args[1] for m in marks]))[case] if marks else ()):
        names = [n.strip() for n in mark.args[0].split(",")]
        kwargs.update(zip(names, values if len(names) > 1 else (values,)))
    gens = []
    for arg in inspect.signature(fn).parameters:
        if arg in kwargs:
            continue
        if arg in extra:
            kwargs[arg] = extra[arg]
            continue
        value = getattr(mod, arg)()
        if inspect.isgenerator(value):
            gens.append(value)
            value = next(value)
        kwargs[arg] = value
    try:
        fn(**kwargs)
    finally:
        for g in reversed(gens):
            for _ in g:
                pass


CASES = [(f, c) for f in FILES for c in file_cases(f) if (f, c[0], c[1]) not in LEFT_OUT]


def test_mirror_covers_the_files():
    for f, n in FILES.items():
        assert len(file_cases(f)) == n, f
    assert len(CASES) == sum(FILES.values()) - 1


@pytest.mark.parametrize("file,case", CASES, ids=[f"{f[:-3]}::{case_id(c)}" for f, c in CASES])
def test_disruption_case_on_the_port(monkeypatch, file, case):
    same_start(monkeypatch)
    importlib.import_module(f"{PORT}.solver.incremental").reset()
    mod = port_mirror(file)
    env = disrupt_helpers().Env()
    try:
        run_case(mod, *case, extra={"env": env, "monkeypatch": monkeypatch})
    finally:
        env.stop()
