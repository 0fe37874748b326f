"""The port's admission validation and durations ≡ the JAX package's.

``karpenter_core_tpu_torch/apis/validation.py`` and ``apis/duration.py``
are the port's copies of the JAX package's. Held:

- ``tests/test_validation.py`` runs from its own source on the port
  (``mirror``): requirements, taints, kubelet settings, disruption and
  budgets, NodeClaims and NodePools, ``validate_or_die`` and the
  admission chain ``install_admission`` puts on the port's
  ``KubeClient``;
- NodePools and NodeClaims built from one numpy seed in both packages,
  valid and broken at seeded fields, give the same error lists, and the
  same admission outcome on a store with the chain installed;
- Go duration strings drawn from a seed parse and format alike.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored

FILE = "test_validation.py"
CASES = mirror_cases(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 42


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_validation_case_holds_the_port(case):
    run_mirrored(mirror(FILE, PORT), *case)


KEYS = ("topology.kubernetes.io/zone", "example.com/tier", "karpenter.sh/nodepool", "bad key!", "a" * 70,
        "kubernetes.io/hostname", "node.kubernetes.io/instance-type", "karpenter.sh/capacity-type")
OPS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt", "Bogus")
VALUES = ("us-west-2a", "gold", "", "1", "-3", "x" * 64, "bad value!")


def seeded_objects(pkg: str, seed: int) -> list:
    """NodePools and NodeClaims of ``pkg``'s classes from ``RandomState(seed)``."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    ob, ncm, npm = imp("kube.objects"), imp("apis.nodeclaim"), imp("apis.nodepool")
    q = imp("kube.quantity").parse_quantity
    rng = np.random.RandomState(seed)
    pick = lambda seq: seq[int(rng.randint(len(seq)))]  # noqa: E731

    def reqs():
        return [ob.NodeSelectorRequirement(pick(KEYS), pick(OPS), [pick(VALUES) for _ in range(rng.randint(3))])
                for _ in range(rng.randint(4))]

    def taints():
        return [ob.Taint(key=pick(("dedicated", "gpu", "bad key!", "")), value=pick(("", "ml", "x" * 70)),
                         effect=pick(("NoSchedule", "NoExecute", "PreferNoSchedule", "Sometimes")))
                for _ in range(rng.randint(3))]

    def kubelet():
        if rng.rand() < 0.3:
            return None
        return ncm.KubeletConfiguration(
            max_pods=int(rng.randint(-5, 300)),
            system_reserved={pick(("cpu", "memory", "gpu")): q(pick(("100m", "1Gi", "-1")))},
            eviction_hard={pick(("memory.available", "nodefs.available", "bogus")): pick(("5%", "100Mi", "abc"))},
            eviction_soft={pick(("memory.available", "imagefs.available")): "10%"} if rng.rand() < 0.5 else {},
            eviction_soft_grace_period={"memory.available": 30.0} if rng.rand() < 0.5 else {},
        )

    out = []
    for i in range(4):
        np_ = npm.NodePool()
        np_.metadata.name = f"pool-{i}"
        spec = np_.spec
        spec.template.requirements = reqs()
        spec.template.taints = taints()
        spec.template.startup_taints = taints()
        spec.template.kubelet = kubelet()
        spec.template.metadata.labels = {pick(KEYS): pick(VALUES) for _ in range(rng.randint(3))}
        spec.weight = pick((None, 0, 1, 50, 100, 101))
        spec.limits = {"cpu": q(pick(("100", "-1", "0")))}
        d = spec.disruption
        d.consolidation_policy = pick(("WhenEmpty", "WhenUnderutilized", "Sometimes"))
        d.consolidate_after = pick((None, 30.0, -1.0))
        d.expire_after = pick((None, 3600.0, 0.0))
        d.budgets = [npm.Budget(nodes=pick(("10%", "5", "-1", "abc", "150%")),
                                schedule=pick((None, "@daily", "0 9 * * 1-5", "not a cron")),
                                duration=pick((None, 3600.0, -5.0))) for _ in range(rng.randint(3))]
        out.append(np_)
        nc = ncm.NodeClaim()
        nc.metadata.name = f"claim-{i}"
        nc.spec.requirements = reqs()
        nc.spec.taints = taints()
        nc.spec.kubelet = kubelet()
        out.append(nc)
    return out


@pytest.mark.parametrize("seed", range(12))
def test_seeded_objects_validate_alike(seed):
    results = {}
    for pkg in (REF, PORT):
        v = importlib.import_module(f"{pkg}.apis.validation")
        kube = importlib.import_module(f"{pkg}.kube.client").KubeClient()
        v.install_admission(kube)
        out = []
        for obj in seeded_objects(pkg, seed):
            errs = v.validate_nodepool(obj) if type(obj).__name__ == "NodePool" else v.validate_nodeclaim(obj)
            try:
                kube.create(obj)
                admitted = True
            except v.ValidationError as e:
                admitted = e.errors
            budgets = [(b.nodes, b.schedule, b.duration) for b in getattr(obj.spec, "disruption", None).budgets] \
                if type(obj).__name__ == "NodePool" else None
            out.append((type(obj).__name__, errs, admitted, budgets))
        results[pkg] = out
    assert results[PORT] == results[REF]
    assert any(errs for _, errs, _, _ in results[PORT])


@pytest.mark.parametrize("seed", range(4))
def test_durations_parse_and_format_alike(seed):
    rng = np.random.RandomState(seed)
    units = ("ns", "us", "µs", "ms", "s", "m", "h", "d", "")
    ref = importlib.import_module(f"{REF}.apis.duration")
    port = importlib.import_module(f"{PORT}.apis.duration")
    for _ in range(60):
        s = "".join(f"{rng.randint(0, 100)}{'.5' if rng.rand() < 0.2 else ''}{units[rng.randint(len(units))]}"
                    for _ in range(rng.randint(1, 4)))
        s = s if rng.rand() < 0.9 else rng.choice(["Never", "", " 1h ", "h1"])
        outs = []
        for mod in (ref, port):
            try:
                outs.append(("ok", mod.parse_duration(s)))
            except ValueError as e:
                outs.append(("err", str(e)))
        assert outs[0] == outs[1], s
        if outs[0][0] == "ok":
            assert port.format_duration(outs[0][1]) == ref.format_duration(outs[0][1])
