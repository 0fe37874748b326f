"""The port's cluster state ≡ the JAX package's.

``karpenter_core_tpu_torch/state/`` (``Cluster``, ``Informers``,
``StateNode``) is the port's copy. Held to the reference:

- every test of ``TestClusterState``, ``TestStateNodeDeepCopyIsolation``
  and ``TestClusterStateSemantics`` in ``tests/test_state_provisioning.py``
  runs from its own source twice, once as written and once on the port
  (the two that take the disruption environment's clock get a store,
  informers and cluster on one fixed clock instead, in both runs);
- seeded sequences of store events (nodes with and without provider
  ids, late registration, NodeClaims launching and going away, pods
  binding, moving, finishing and being deleted, daemonset pods,
  required and preferred anti-affinity, DaemonSets, CSINodes) and of
  direct calls (deletion marks, nominations, clock ticks) drive both
  packages' informers; after every step ``deep_copy_nodes()`` summaries,
  ``bindings``, the ``generation()`` delta, the anti-affinity walk, the
  daemonset pods, nominations, ``synced()`` and the consolidation stamp
  must be equal, exactly.
"""

from __future__ import annotations

import importlib
import random

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_oracle import _port_helpers, same_start

FILE = "test_state_provisioning.py"
CLASSES = ("TestClusterState", "TestStateNodeDeepCopyIsolation", "TestClusterStateSemantics")
CASES = mirror_cases(FILE, classes=CLASSES)


class ClockEnv:
    """The part of ``helpers.Env`` the state tests read (``kube``,
    ``cluster``, ``now``), over one package, with no disruption
    controller."""

    def __init__(self, pkg: str):
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.now = 10_000.0
        self.kube = imp("kube.client").KubeClient(clock=self.clock)
        self.cluster = imp("state.cluster").Cluster(self.kube, None, clock=self.clock)
        self.informers = imp("state.informers").Informers(self.kube, self.cluster)
        self.informers.start()

    def clock(self):
        return self.now


def test_mirror_covers_the_classes():
    assert len(CASES) == 14


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_state_case_on_both_packages(monkeypatch, case):
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        envs = []

        def clock_env(mod, pkg=pkg):
            envs.append(ClockEnv(pkg))
            return envs[-1]

        run_mirrored(mirror(FILE, pkg), *case, extra={"clock_env": clock_env})
        for e in envs:
            e.informers.stop()


# -- seeded event sequences ---------------------------------------------------


def node_summary(sn) -> tuple:
    return (
        sn.provider_id(), sn.name(), sn.initialized(), sn.marked_for_deletion, sn.nominated_until,
        sorted(sn.pod_request_total().items()), sorted(sn.pod_limit_total().items()),
        sorted(sn.daemonset_request_total().items()), sorted(sn.available().items()),
        sorted(sn.pod_requests), sorted(sn.volume_usage.csi_limits.items()),
        sn.node_claim.name if sn.node_claim is not None else None,
        sn.node.name if sn.node is not None else None,
    )


def cluster_summary(cluster) -> dict:
    walked = []
    cluster.for_pods_with_anti_affinity(lambda p, n: (walked.append((p.name, n.name if n else None)), True)[1])
    return dict(
        nodes=sorted(node_summary(sn) for sn in cluster.deep_copy_nodes()),
        bindings=sorted(cluster.bindings.items()),
        anti=sorted(walked),
        daemonsets=sorted((p.namespace, p.name) for p in cluster.get_daemonset_pods()),
        nominated=sorted(pid for pid in cluster.nodes if cluster.is_node_nominated(pid)),
        synced=cluster.synced(),
        consolidation=cluster.consolidation_state(),
        claim_ids=sorted(cluster.node_claim_name_to_provider_id.items()),
    )


def run_sequence(pkg: str, seed: int, steps: int = 150) -> list:
    h = importlib.import_module("helpers") if pkg == REF else _port_helpers()
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    wk, ob = imp("apis.labels"), imp("kube.objects")
    NodeClaim = imp("apis.nodeclaim").NodeClaim
    env = ClockEnv(pkg)
    kube, cluster = env.kube, env.cluster
    rng = random.Random(seed)
    out = []
    node_names = [f"n{i}" for i in range(5)]
    pod_names = [f"p{i}" for i in range(12)]
    for step in range(steps):
        op = rng.choice(
            ["node", "node", "claim", "bind", "bind", "bind", "move", "finish", "delete_pod",
             "delete_node", "delete_claim", "daemonset", "csi", "mark", "nominate", "tick",
             "register", "anti"]
        )
        gen0 = cluster.generation()
        if op == "node":
            name = rng.choice(node_names)
            if kube.get("Node", name) is None:
                node = h.make_node(
                    name=name, capacity={"cpu": str(rng.choice([2, 4, 8])), "memory": "16Gi", "pods": "30"},
                    labels={wk.LABEL_TOPOLOGY_ZONE: f"z{rng.randint(1, 3)}"},
                    provider_id=rng.choice([f"fake:///{name}", ""]),
                )
                if rng.random() < 0.5:
                    node.metadata.labels[wk.NODE_INITIALIZED_LABEL_KEY] = "true"
                    node.metadata.labels[wk.NODE_REGISTERED_LABEL_KEY] = "true"
                if not node.spec.provider_id:
                    node.spec.provider_id = ""
                kube.create(node)
        elif op == "register":
            node = kube.get("Node", rng.choice(node_names))
            if node is not None and not node.spec.provider_id:
                node.spec.provider_id = f"fake:///{node.name}"
                kube.apply(node)
        elif op == "claim":
            name = rng.choice(node_names)
            nc = kube.get("NodeClaim", f"c-{name}")
            if nc is None:
                nc = NodeClaim()
                nc.metadata.name = f"c-{name}"
                kube.create(nc)
            elif not nc.status.provider_id:
                nc.status.provider_id = f"fake:///{name}"
                kube.update(nc)
        elif op in ("bind", "anti"):
            name = rng.choice(pod_names)
            if kube.get("Pod", name, namespace="default") is None:
                anti = None
                if op == "anti":
                    anti = [ob.PodAffinityTerm(
                        topology_key=rng.choice([wk.LABEL_HOSTNAME, wk.LABEL_TOPOLOGY_ZONE]),
                        label_selector=ob.LabelSelector(match_labels={"app": "x"}),
                    )]
                pod = h.make_pod(
                    name=name, requests={"cpu": rng.choice(["100m", "500m", "1"])},
                    limits={"cpu": "2"}, node_name=rng.choice(node_names + [""]),
                    phase="Running", pending_unschedulable=False, pod_anti_affinity=anti,
                    owner_kind=rng.choice([None, "DaemonSet", "ReplicaSet"]),
                )
                kube.create(pod)
        elif op == "move":
            pod = kube.get("Pod", rng.choice(pod_names), namespace="default")
            if pod is not None:
                pod.spec.node_name = rng.choice(node_names)
                kube.apply(pod)
        elif op == "finish":
            pod = kube.get("Pod", rng.choice(pod_names), namespace="default")
            if pod is not None:
                pod.status.phase = rng.choice(["Succeeded", "Failed"])
                kube.apply(pod)
        elif op == "delete_pod":
            kube.delete("Pod", rng.choice(pod_names), namespace="default")
        elif op == "delete_node":
            kube.delete("Node", rng.choice(node_names))
        elif op == "delete_claim":
            kube.delete("NodeClaim", f"c-{rng.choice(node_names)}")
        elif op == "daemonset":
            name = f"ds{rng.randint(0, 2)}"
            if kube.get("DaemonSet", name, namespace="kube-system") is None:
                ds = ob.DaemonSet()
                ds.metadata.name, ds.metadata.namespace = name, "kube-system"
                ds.pod_template_spec = ob.PodSpec(containers=[ob.Container(name="main")])
                kube.create(ds)
            else:
                kube.delete("DaemonSet", name, namespace="kube-system")
        elif op == "csi":
            name = rng.choice(node_names)
            csi = kube.get("CSINode", name)
            if csi is None:
                csi = ob.CSINode(drivers=[ob.CSINodeDriver(name="ebs", allocatable_count=rng.randint(1, 9))])
                csi.metadata.name = name
                kube.create(csi)
            else:
                kube.delete(csi)
        elif op == "mark":
            pids = sorted(cluster.nodes)
            if pids:
                pid = rng.choice(pids)
                (cluster.mark_for_deletion if rng.random() < 0.6 else cluster.unmark_for_deletion)(pid)
        elif op == "nominate":
            pids = sorted(cluster.nodes)
            if pids:
                cluster.nominate_node_for_pod(rng.choice(pids))
        elif op == "tick":
            env.now += rng.choice([1.0, 5.0, 25.0])
        out.append((step, op, cluster.generation() - gen0, cluster_summary(cluster)))
    env.informers.stop()
    return out


@pytest.mark.parametrize("seed", range(5))
def test_event_sequence_matches_reference(monkeypatch, seed):
    runs = {}
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        runs[pkg] = run_sequence(pkg, seed)
    ref, port = runs[REF], runs[PORT]
    final = ref[-1][3]
    assert final["nodes"] and final["bindings"], "the sequence built no cluster"
    assert any(step[3]["anti"] for step in ref), "no bound anti-affinity pod was walked"
    assert any(step[3]["nominated"] for step in ref), "no nomination held"
    for r, p in zip(ref, port):
        assert p == r, f"step {r[0]} ({r[1]})"
    assert len(port) == len(ref)


def test_reset_keeps_generation_monotonic():
    gens = {}
    for pkg in (REF, PORT):
        env = ClockEnv(pkg)
        h = importlib.import_module("helpers") if pkg == REF else _port_helpers()
        env.kube.create(h.make_node(name="n0", capacity={"cpu": "4"}))
        before = env.cluster.generation()
        env.cluster.reset()
        gens[pkg] = (before, env.cluster.generation(), env.cluster.deep_copy_nodes())
        env.informers.stop()
    assert gens[PORT] == gens[REF] and gens[REF][1] == gens[REF][0] + 1
