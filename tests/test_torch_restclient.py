"""The port's REST adapter and its codec ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/kube/restclient.py`` and ``kube/codec.py``
are the port's copies of the JAX package's. This file holds them to the
reference two ways:

- ``TestCodecRoundTrip``, ``TestRestClientCrud`` and
  ``TestRestClientWatch`` of ``tests/test_restclient.py`` run from their
  own source on the port (``mirror``), against the port's copy of the
  stub apiserver (the mirrored module's ``_StubApiServer``, speaking
  the port's ``API_PATHS``); ``TestOperatorOverRest`` drives the port's
  ``Operator`` (on the CPU) through the adapter over real HTTP, and
  ``test_real_cluster_smoke`` runs where ``KARPENTER_REAL_APISERVER``
  names a real apiserver (it skips here, as the JAX package's does);
- objects built from one numpy seed in both packages (pods with
  affinity, tolerations, spread, ports and volumes; nodes; NodePools
  with budgets and kubelet settings; NodeClaims; Leases) encode to
  equal ``to_k8s`` dicts, decode from them to equal objects, and
  round-trip: ``to_k8s(from_k8s(to_k8s(obj))) == to_k8s(obj)``.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored

FILE = "test_restclient.py"
CLASSES = ("TestCodecRoundTrip", "TestRestClientCrud", "TestRestClientWatch")
CASES = mirror_cases(FILE, CLASSES)


def restclient_mirror():
    """``tests/test_restclient.py`` on the port; its ``kube`` fixture
    starts (and stops) a stub apiserver of its own, so the mirror's
    fixture runner needs no fixture-to-fixture wiring."""
    replace = (
        ("@pytest.fixture()\n", ""),
        ("def kube(stub):\n    client = RestKubeClient(stub.url)\n    yield client\n    client.close()\n",
         "def kube():\n    stub = _StubApiServer()\n    client = RestKubeClient(stub.url)\n    yield client\n"
         "    client.close()\n    stub.stop()\n"),
    )
    return mirror(FILE, PORT, replace=replace)


def test_mirror_covers_the_classes():
    assert len(CASES) == 11


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_restclient_case_holds_the_port(case):
    run_mirrored(restclient_mirror(), *case)


def test_mirror_stub_speaks_the_ports_paths():
    from karpenter_core_tpu_torch.kube import codec

    mod = restclient_mirror()
    assert mod.API_PATHS is codec.API_PATHS
    assert mod.RestKubeClient.__module__ == f"{PORT}.kube.restclient"


# -- the operator over the adapter, and the live smoke ------------------------------

OPERATOR_CASES = mirror_cases(FILE, ("TestOperatorOverRest",))
SMOKE_CASES = [c for c in mirror_cases(FILE) if c[0] is None and c[1] == "test_real_cluster_smoke"]


def operator_rest_mirror():
    from test_torch_operator import operator_mirror

    return operator_mirror(FILE, replace=(
        ("@pytest.fixture()\n", ""),
        ("        from {pkg}.operator import Operator, Options\n", "        from {pkg}.operator import Options\n"),
    ))


def test_operator_mirror_covers_the_cases():
    assert len(OPERATOR_CASES) == 1 and len(SMOKE_CASES) == 1


@pytest.mark.parametrize("case", OPERATOR_CASES, ids=[case_id(c) for c in OPERATOR_CASES])
def test_operator_over_rest_holds_the_port(case):
    run_mirrored(operator_rest_mirror(), *case)


@pytest.mark.skipif(not os.environ.get("KARPENTER_REAL_APISERVER"),
                    reason="set KARPENTER_REAL_APISERVER=http://127.0.0.1:8001 (kubectl proxy) for the live smoke")
@pytest.mark.parametrize("case", SMOKE_CASES, ids=[case_id(c) for c in SMOKE_CASES])
def test_real_cluster_smoke_holds_the_port(case):
    run_mirrored(restclient_mirror(), *case)


# -- seeded objects through both codecs ---------------------------------------


def seeded_objects(pkg: str, seed: int) -> list:
    """Pods, nodes, NodePools, NodeClaims and Leases of ``pkg``'s classes,
    every choice drawn from ``RandomState(seed)`` (both packages draw the
    same numbers, so they build the same objects)."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    ob, ncm, npm = imp("kube.objects"), imp("apis.nodeclaim"), imp("apis.nodepool")
    q = imp("kube.quantity").parse_quantity
    rng = np.random.RandomState(seed)
    pick = lambda seq: seq[int(rng.randint(len(seq)))]  # noqa: E731
    zones = ["zone-a", "zone-b", "zone-c"]

    def selector():
        return ob.LabelSelector(
            match_labels={"app": pick(["web", "db", "cache"])},
            match_expressions=[ob.LabelSelectorRequirement("tier", pick(["In", "NotIn"]), ["a", "b"])]
            if rng.rand() < 0.5 else [],
        )

    def requirement():
        op = pick(["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"])
        if op in ("Gt", "Lt"):
            return ob.NodeSelectorRequirement("karpenter.sh/cpu", op, [str(int(rng.randint(1, 64)))])
        values = [] if op in ("Exists", "DoesNotExist") else sorted(set(pick(zones) for _ in range(2)))
        return ob.NodeSelectorRequirement("topology.kubernetes.io/zone", op, values)

    def taint():
        return ob.Taint(key=pick(["dedicated", "gpu"]), value=pick(["", "ml"]),
                        effect=pick(["NoSchedule", "NoExecute", "PreferNoSchedule"]))

    def term():
        return ob.PodAffinityTerm(topology_key=pick(["kubernetes.io/hostname", "topology.kubernetes.io/zone"]),
                                  label_selector=selector(), namespaces=["default"] if rng.rand() < 0.5 else [])

    def resources():
        return {"cpu": q(pick(["100m", "250m", "1", "1500m"])), "memory": q(pick(["128Mi", "1Gi", "2Gi"]))}

    def kubelet():
        return ncm.KubeletConfiguration(
            max_pods=int(rng.randint(10, 250)), pods_per_core=int(rng.randint(1, 8)) if rng.rand() < 0.5 else None,
            system_reserved={"cpu": q("100m")}, kube_reserved={"memory": q("256Mi")} if rng.rand() < 0.5 else {},
            eviction_hard={"memory.available": "5%"}, eviction_soft={},
        )

    out = []
    for i in range(6):
        pod = ob.Pod()
        pod.metadata.name, pod.metadata.namespace = f"pod-{i}", pick(["default", "prod"])
        pod.metadata.labels = {"app": pick(["web", "db"]), "tier": pick(["a", "b"])}
        pod.metadata.finalizers = ["keep"] if rng.rand() < 0.3 else []
        pod.metadata.resource_version = int(rng.randint(1, 1000))
        pod.spec.node_selector = {"disk": "ssd"} if rng.rand() < 0.5 else {}
        pod.spec.tolerations = [
            ob.Toleration(key=pick(["dedicated", "gpu"]), operator=pick(["Equal", "Exists"]), value="ml",
                          effect=pick(["NoSchedule", ""]),
                          toleration_seconds=int(rng.randint(30, 300)) if rng.rand() < 0.3 else None)
            for _ in range(int(rng.randint(0, 3)))
        ]
        pod.spec.topology_spread_constraints = [
            ob.TopologySpreadConstraint(max_skew=int(rng.randint(1, 4)), topology_key="topology.kubernetes.io/zone",
                                        when_unsatisfiable=pick(["DoNotSchedule", "ScheduleAnyway"]),
                                        label_selector=selector(),
                                        min_domains=int(rng.randint(1, 3)) if rng.rand() < 0.3 else None)
            for _ in range(int(rng.randint(0, 2)))
        ]
        pod.spec.affinity = ob.Affinity(
            node_affinity=ob.NodeAffinity(
                required=ob.NodeSelector([ob.NodeSelectorTerm([requirement()])]),
                preferred=[ob.PreferredSchedulingTerm(int(rng.randint(1, 100)), ob.NodeSelectorTerm([requirement()]))],
            ),
            pod_affinity=ob.PodAffinity(required=[term()]) if rng.rand() < 0.5 else None,
            pod_anti_affinity=ob.PodAntiAffinity(
                required=[term()], preferred=[ob.WeightedPodAffinityTerm(int(rng.randint(1, 100)), term())]),
        )
        pod.spec.containers = [ob.Container(
            name=f"c{j}", resources=ob.ResourceRequirements(requests=resources()),
            ports=[ob.ContainerPort(host_port=8080 + j, container_port=8080 + j)] if rng.rand() < 0.4 else [],
        ) for j in range(int(rng.randint(1, 3)))]
        pod.spec.volumes = [ob.Volume(name="data", persistent_volume_claim=f"pvc-{i}")] if rng.rand() < 0.4 else []
        pod.spec.priority = int(rng.randint(0, 1000)) if rng.rand() < 0.5 else None
        pod.status.phase = pick(["Pending", "Running"])
        pod.status.conditions = [ob.PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]
        out.append(pod)

        node = ob.Node()
        node.metadata.name = f"node-{i}"
        node.metadata.labels = {"topology.kubernetes.io/zone": pick(zones), "karpenter.sh/nodepool": "default"}
        node.spec.provider_id = f"fake:///node-{i}"
        node.spec.taints = [taint() for _ in range(int(rng.randint(0, 3)))]
        node.spec.unschedulable = bool(rng.rand() < 0.3)
        out.append(node)

        pool = npm.NodePool()
        pool.metadata.name = f"pool-{i}"
        pool.spec.template.metadata.labels = {"team": pick(["a", "b"])}
        pool.spec.template.taints = [taint()]
        pool.spec.template.requirements = [requirement() for _ in range(int(rng.randint(1, 4)))]
        pool.spec.template.kubelet = kubelet()
        pool.spec.disruption.consolidate_after = pick([None, 0.0, 30.0, 3600.0 + 90.0])
        pool.spec.disruption.expire_after = pick([None, 720 * 3600.0])
        pool.spec.disruption.budgets = [
            npm.Budget(nodes=pick(["10%", "3", "0"]), schedule=pick([None, "0 9 * * mon-fri", "@daily"]),
                       duration=pick([None, 8 * 3600.0, 1800.0]))
            for _ in range(int(rng.randint(1, 4)))
        ]
        pool.spec.limits = resources()
        pool.spec.weight = int(rng.randint(1, 100)) if rng.rand() < 0.5 else None
        pool.status.resources = resources()
        out.append(pool)

        claim = ncm.NodeClaim()
        claim.metadata.name = f"claim-{i}"
        claim.metadata.labels = {"karpenter.sh/nodepool": f"pool-{i}"}
        claim.spec.taints = [taint()]
        claim.spec.startup_taints = [taint()] if rng.rand() < 0.5 else []
        claim.spec.requirements = [requirement() for _ in range(int(rng.randint(1, 4)))]
        claim.spec.resources.requests = resources()
        claim.spec.kubelet = kubelet() if rng.rand() < 0.7 else None
        claim.spec.node_class_ref = ncm.NodeClassReference(name="default", kind="EC2NodeClass",
                                                            api_version="karpenter.k8s.aws/v1beta1")
        claim.status.provider_id = f"fake:///node-{i}"
        claim.status.node_name = f"node-{i}"
        claim.status.capacity = resources()
        claim.status.allocatable = resources()
        for cond in ("Launched", "Registered", "Initialized")[: int(rng.randint(1, 4))]:
            claim.set_condition(cond, pick(["True", "False"]), reason="seeded")
        out.append(claim)

        lease = ob.Lease(holder=pick(["", "op-a", "op-b"]), lease_duration_seconds=int(rng.randint(5, 60)),
                         acquire_time=float(1_700_000_000 + int(rng.randint(0, 10_000))),
                         renew_time=pick([None, float(1_700_000_000 + int(rng.randint(0, 10_000)))]),
                         lease_transitions=int(rng.randint(0, 5)))
        lease.metadata.name, lease.metadata.namespace = f"lease-{i}", "kube-system"
        out.append(lease)
    return out


def _stamped(wire: dict, i: int) -> dict:
    """The wire dict with the fields the apiserver stamps (uid, creation
    time, a NodePool's kubelet and class reference, which the encoder
    leaves out), so a decode sets every field from the wire."""
    wire = copy.deepcopy(wire)
    wire["metadata"].update(uid=f"uid-{i}", creationTimestamp="2024-03-04T09:00:00Z")
    if wire["kind"] == "NodePool":
        wire["spec"]["template"]["spec"].update(
            kubelet={"maxPods": 110, "podsPerCore": 4, "systemReserved": {"cpu": "100m"},
                     "evictionHard": {"memory.available": "5%"}},
            nodeClassRef={"name": "default", "kind": "EC2NodeClass", "apiVersion": "karpenter.k8s.aws/v1beta1"},
        )
    return wire


@pytest.mark.parametrize("seed", range(6))
def test_seeded_objects_encode_and_decode_as_reference(seed):
    codecs = {pkg: importlib.import_module(f"{pkg}.kube.codec") for pkg in (REF, PORT)}
    objs = {pkg: seeded_objects(pkg, seed) for pkg in (REF, PORT)}
    kinds = {o.kind for o in objs[PORT]}
    assert kinds == {"Pod", "Node", "NodePool", "NodeClaim", "Lease"}
    for i, (ref_obj, port_obj) in enumerate(zip(objs[REF], objs[PORT])):
        wire = codecs[PORT].to_k8s(port_obj)
        assert json.dumps(wire, sort_keys=True) == json.dumps(codecs[REF].to_k8s(ref_obj), sort_keys=True)
        # the port's decode of its wire re-encodes to the same wire
        assert codecs[PORT].to_k8s(codecs[PORT].from_k8s(port_obj.kind, wire)) == wire
        stamped = _stamped(wire, i)
        got = codecs[PORT].from_k8s(port_obj.kind, stamped)
        want = codecs[REF].from_k8s(ref_obj.kind, stamped)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), port_obj.kind
        assert got.metadata.uid == f"uid-{i}"
