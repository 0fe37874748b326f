"""The port's in-memory apiserver ≡ the JAX package's.

``karpenter_core_tpu_torch/kube/client.py`` is a copy of the JAX
package's ``KubeClient``. This file holds it to the reference two ways:

- every test of ``tests/test_kube_client.py`` runs from its own source
  twice, once as written and once with the port's package in place of
  the JAX package's (its own assertions then hold the port: conflicts,
  resource versions, finalizers, watch order, unsubscribe, admission,
  ``retry_on_conflict``);
- seeded random sequences of creates, updates, applies, deletes,
  finalizer removals, watches and unsubscribes run against both clients,
  and the watch logs, the resource versions and the errors must be
  equal, exactly.

The mirror machinery (``mirror``, ``mirror_cases``, ``run_mirrored``) is
shared by the other cluster-state test files of the port.
"""

from __future__ import annotations

import ast
import copy
import importlib
import inspect
import random
import re
import types
from pathlib import Path

import pytest

from test_torch_oracle import _port_helpers, same_start

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"
TESTS = Path(__file__).resolve().parent

_MIRRORS: dict = {}


def mirror(file: str, pkg: str, replace: tuple = (), inject: dict = None):
    """The module of ``tests/<file>`` for ``pkg``: its fixtures plain
    functions, its package swapped for the port's when ``pkg`` is the
    port (``tests/helpers.py`` too), ``replace`` applied to the source
    (``{pkg}`` stands for the package) and ``inject`` bound in its
    namespace before it runs."""
    key = (file, pkg, replace)
    if key in _MIRRORS:
        return _MIRRORS[key]
    src = (TESTS / file).read_text().replace("@pytest.fixture\n", "")
    if pkg == PORT:
        _port_helpers()
        src = re.sub(r"\bkarpenter_core_tpu\b", PORT, src)
        src = src.replace("from helpers import", "from _port_helpers import")
    for old, new in replace:
        src = src.replace(old.format(pkg=pkg), new.format(pkg=pkg))
    mod = types.ModuleType(f"_mirror_{pkg}_{file[:-3]}")
    mod.__file__ = str(TESTS / file)
    mod.__dict__.update(inject or {})
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    _MIRRORS[key] = mod
    return mod


def mirror_cases(file: str, classes=None) -> list:
    """(class or None, test, case index) for every test of ``file`` (of
    ``classes`` only, where given), one entry per parametrised case."""
    text = (TESTS / file).read_text()
    out = []

    def add(cls, fn):
        n_cases = 1
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and getattr(dec.func, "attr", "") == "parametrize":
                n_cases = len(dec.args[1].elts)
        out.extend((cls, fn.name, case) for case in range(n_cases))

    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef) and (classes is None or node.name in classes):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test"):
                    add(node.name, fn)
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test") and classes is None:
            add(None, node)
    return out


def case_id(case) -> str:
    cls, name, k = case
    return f"{cls}::{name}[{k}]" if cls else f"{name}[{k}]"


def run_mirrored(mod, cls, name, case, extra: dict = None):
    """Run one test of a mirrored module: its fixtures resolved from the
    module's own (generator fixtures finished after the test) or from
    ``extra`` (name → value, or → callable(mod) building it); → the
    fixture values by name."""
    owner = getattr(mod, cls)() if cls else None
    fn = getattr(owner, name) if owner is not None else getattr(mod, name)
    if owner is not None and hasattr(owner, "setup_method"):
        owner.setup_method(fn)
    kwargs = {}
    for mark in getattr(fn, "pytestmark", ()):
        if mark.name == "parametrize":
            names = [n.strip() for n in mark.args[0].split(",")]
            values = mark.args[1][case]
            kwargs.update(zip(names, values if len(names) > 1 else (values,)))
    gens = []
    for arg in inspect.signature(fn).parameters:
        if arg in kwargs:
            continue
        if extra and arg in extra:
            value = extra[arg]
            kwargs[arg] = value(mod) if callable(value) and not isinstance(value, type) else value
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
    return kwargs


# -- tests/test_kube_client.py, on both clients -------------------------------

FILE = "test_kube_client.py"
CASES = mirror_cases(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 19


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_kube_client_case_on_both_clients(monkeypatch, case):
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        run_mirrored(mirror(FILE, pkg), *case)


# -- seeded operation sequences, both clients ---------------------------------


def _pod(pkg: str, name: str, labels: dict):
    ob = importlib.import_module(f"{pkg}.kube.objects")
    pod = ob.Pod()
    pod.metadata.name = name
    pod.metadata.namespace = "default"
    pod.metadata.labels = dict(labels)
    return pod


def run_ops(pkg: str, seed: int) -> list:
    """A seeded random op sequence against one package's client → the
    log of every watch delivery, return value, resource version and
    error class, in order."""
    client = importlib.import_module(f"{pkg}.kube.client")
    now = [100.0]
    kube = client.KubeClient(clock=lambda: now[0])
    rng = random.Random(seed)
    log: list = []
    watches: dict = {}
    names = [f"p{i}" for i in range(6)]
    for step in range(120):
        op = rng.choice(
            ["create", "create", "update", "apply", "delete", "finalize", "unfinalize",
             "watch", "unwatch", "stale", "retry", "tick"]
        )
        name = rng.choice(names)
        stored = kube.get("Pod", name, namespace="default")
        try:
            if op == "create":
                out = kube.create(_pod(pkg, name, {"v": str(step)}))
                log.append((op, name, out.metadata.resource_version))
            elif op == "update" and stored is not None:
                stored.metadata.labels["u"] = str(step)
                log.append((op, name, kube.update(stored).metadata.resource_version))
            elif op == "update":
                kube.update(_pod(pkg, name, {}))
            elif op == "apply":
                fresh = _pod(pkg, name, {"a": str(step)})
                log.append((op, name, kube.apply(fresh).metadata.resource_version))
            elif op == "delete":
                log.append((op, name, kube.delete("Pod", name, namespace="default")))
            elif op == "finalize" and stored is not None:
                stored.metadata.finalizers.append(f"f{step % 2}")
                kube.update(stored)
                log.append((op, name, stored.metadata.resource_version))
            elif op == "unfinalize" and stored is not None and stored.metadata.finalizers:
                kube.remove_finalizer(stored, stored.metadata.finalizers[0])
                log.append((op, name, stored.metadata.resource_version))
            elif op == "watch":
                w = f"w{step}"
                watches[w] = kube.watch(
                    "Pod", lambda ev, o, w=w: log.append(
                        (w, ev, o.metadata.name, o.metadata.resource_version,
                         o.metadata.deletion_timestamp)
                    )
                )
            elif op == "unwatch" and watches:
                w = rng.choice(sorted(watches))
                watches.pop(w)()
                log.append((op, w))
            elif op == "stale" and stored is not None:
                # a copy made before a bump: its write conflicts
                stale = copy.deepcopy(stored)
                kube.update(stored)
                kube.update(stale)
            elif op == "retry" and stored is not None:
                out = kube.retry_on_conflict(
                    "Pod", name, namespace="default",
                    mutate=lambda o, s=step: o.metadata.labels.__setitem__("r", str(s)),
                )
                log.append((op, name, out.metadata.resource_version))
            elif op == "tick":
                now[0] += 1.0
        except Exception as e:  # noqa: BLE001 — the error class is compared
            log.append((op, name, "error", type(e).__name__))
    log.append(sorted(
        (p.metadata.name, p.metadata.resource_version, p.metadata.deletion_timestamp,
         tuple(p.metadata.finalizers), tuple(sorted(p.metadata.labels.items())))
        for p in kube.list("Pod")
    ))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_operation_sequences_match_reference(seed):
    """Exact: the same deliveries in the same order, the same resource
    versions and deletion stamps, the same error classes."""
    ref = run_ops(REF, seed)
    port = run_ops(PORT, seed)
    assert any(entry[0].startswith("w") for entry in ref[:-1]), "no watch delivered"
    assert any("error" in entry for entry in ref[:-1]), "no error path taken"
    assert port == ref
