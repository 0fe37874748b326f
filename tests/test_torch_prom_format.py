"""The port's Prometheus exposition checker ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/metrics/textcheck.py`` is the port's copy of
the JAX package's ``check_exposition``, exported from ``metrics`` as the
reference exports it. Held:

- ``tests/test_prom_format.py`` runs from its own source on the port
  (``mirror``; its solve the port's ``TorchScheduler`` on the CPU): the
  port's registry after a real traced solve passes the checker, hostile
  label values are escaped, and the checker flags every fault it is
  built to find;
- expositions made from one numpy seed (good ones from a registry, and
  the same ones broken at a seeded line: a quote unescaped, a TYPE moved
  after its samples, a bucket made non-cumulative, ``+Inf`` or
  ``_count`` dropped, a series duplicated, a line mangled) get the same
  problem list from both packages' checkers.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_disruption import cpu_scheduler
from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored

FILE = "test_prom_format.py"
CASES = mirror_cases(FILE)


def prom_mirror():
    return mirror(FILE, PORT, replace=(("from {pkg}.solver import TPUScheduler\n", ""),),
                  inject={"TPUScheduler": cpu_scheduler})


def test_mirror_covers_the_file():
    assert len(CASES) == 7


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_prom_format_case_holds_the_port(case):
    run_mirrored(prom_mirror(), *case)


def test_metrics_exports_the_checker():
    from karpenter_core_tpu_torch import metrics
    from karpenter_core_tpu_torch.metrics import textcheck

    assert metrics.check_exposition is textcheck.check_exposition


def exposition(pkg: str, seed: int) -> str:
    """The exposition of five families of ``pkg``'s ``Metrics`` filled
    from ``RandomState(seed)``: counters, gauges and histograms with
    hostile label values."""
    m = importlib.import_module(f"{pkg}.metrics").Metrics()
    rng = np.random.RandomState(seed)
    names = ["default", 'we"ird', "back\\slash", "new\nline", "a,b={c}"]
    for _ in range(12):
        pool = names[int(rng.randint(len(names)))]
        m.nodeclaims_created.inc(reason="provisioning", nodepool=pool)
        m.scheduling_duration.observe(float(rng.rand()))
        m.node_allocatable.set(float(rng.randint(1, 64)), node=pool, resource="cpu")
        m.reconcile_errors.inc(controller=pool)
        m.disruption_evaluation_duration.observe(float(rng.rand() * 3), method="drift")
    # only these families: others read process state (the tracer's orphan
    # count, for one) that earlier tests in the process move
    families = [m.nodeclaims_created, m.scheduling_duration, m.node_allocatable, m.reconcile_errors,
                m.disruption_evaluation_duration]
    return "\n".join(line for f in families for line in f.collect()) + "\n"


def broken(text: str, seed: int) -> str:
    """``text`` with one seeded fault."""
    rng = np.random.RandomState(1000 + seed)
    lines = text.splitlines()
    samples = [i for i, l in enumerate(lines) if l and not l.startswith("#")]
    i = samples[int(rng.randint(len(samples)))]
    kind = int(rng.randint(7))
    if kind == 0 and '"' in lines[i]:
        lines[i] = lines[i].replace('"', '"x"', 1)
    elif kind == 1:
        t = next(j for j in range(i, -1, -1) if lines[j].startswith("# TYPE"))
        lines.insert(i + 1, lines.pop(t))
    elif kind == 2:
        b = [j for j in samples if "_bucket{" in lines[j]]
        j = b[int(rng.randint(len(b)))]
        head, _ = lines[j].rsplit(" ", 1)
        lines[j] = f"{head} -1"
    elif kind == 3:
        lines = [l for l in lines if 'le="+Inf"' not in l or rng.rand() < 0.5]
    elif kind == 4:
        lines = [l for l in lines if "_count" not in l or rng.rand() < 0.5]
    elif kind == 5:
        lines.insert(i, lines[i])
    else:
        lines[i] = lines[i].replace(" ", "", 1)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(10))
def test_checker_equals_reference_on_seeded_expositions(seed):
    ref = importlib.import_module(f"{REF}.metrics").check_exposition
    port = importlib.import_module(f"{PORT}.metrics").check_exposition
    text = exposition(PORT, seed)
    assert text == exposition(REF, seed)
    assert port(text) == ref(text) == []
    bad = broken(text, seed)
    assert port(bad) == ref(bad)
