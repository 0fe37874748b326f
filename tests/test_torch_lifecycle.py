"""The port's lifecycle controllers ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/lifecycle/`` is the port's copy of the JAX
package's lifecycle: NodeClaim launch, registration, initialization and
liveness, NodeClaim and Node termination (taint, drain in waves through
the ``EvictionQueue`` under PDBs, provider delete), NodeClaim and lease
garbage collection, the consistency checks, the NodePool counter and
hash. Held:

- ``tests/test_lifecycle.py`` runs from its own source on the port
  (``mirror``; its kubelet the port's copy of ``tests/kubelet_sim.py``);
- seeded worlds built in both packages (launched and joined claims,
  pods bound across them, critical and daemonset pods, pods tolerating
  the disruption taint, a PDB) go through the same seeded sequence of
  node deletions, termination passes, eviction-queue passes, clock
  steps, provider drops, GC, consistency and lease-GC passes. After
  every step the claims, nodes, pods, leases, events and the metric
  samples of both packages are equal.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror_cases, run_mirrored
from test_torch_operator import operator_mirror, operator_start, store_state

FILE = "test_lifecycle.py"
CASES = mirror_cases(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 32


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_lifecycle_case_holds_the_port(monkeypatch, case):
    run_mirrored(operator_mirror(FILE), *case, extra={"monkeypatch": monkeypatch})


def test_lifecycle_exports_every_reference_name():
    ref = importlib.import_module(f"{REF}.lifecycle")
    port = importlib.import_module(f"{PORT}.lifecycle")
    names = [n for n in dir(ref) if not n.startswith("_") and isinstance(getattr(ref, n), type)]
    assert len(names) == 10
    for name in names:
        assert isinstance(getattr(port, name), type), name
    assert not hasattr(port, "_NOT_PORTED")
    from karpenter_core_tpu_torch.lifecycle import node_termination

    assert node_termination.NodeDrainError.__mro__[1] is Exception


# -- seeded termination worlds, both packages ---------------------------------


class TerminationWorld:
    """One package's lifecycle over a store on a stepped clock, built from
    ``RandomState(seed)``: ``n_nodes`` launched and joined claims, pods
    bound across them (a tenth critical, a tenth daemonset-owned, a few
    tolerating the disruption taint, some terminating), a PDB over the
    ``web`` pods, orphaned node leases."""

    def __init__(self, pkg: str, seed: int, n_nodes: int = 6):
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        wk, ob, q = imp("apis.labels"), imp("kube.objects"), imp("kube.quantity").parse_quantity
        fake, lc = imp("cloudprovider.fake"), imp("lifecycle")
        self.pkg, self.wk, self.ob = pkg, wk, ob
        # stepped from the wall clock's second: the claims' condition
        # stamps read the wall clock in both packages (ROADMAP C13), and the
        # GC grace compares the stepped clock with them
        self.now = [float(int(time.time()))]
        clock = lambda: self.now[0]  # noqa: E731
        self.kube = imp("kube.client").KubeClient(clock=clock)
        self.provider = fake.FakeCloudProvider()
        self.provider.instance_types = fake.instance_types(12)
        self.recorder = imp("events").Recorder(self.kube, clock=clock)
        self.metrics = imp("metrics").Metrics()
        self.queue = lc.EvictionQueue(self.kube, self.recorder)
        self.terminator = lc.Terminator(self.kube, self.queue, clock=clock)
        self.lifecycle = lc.NodeClaimLifecycleController(self.kube, self.provider, self.recorder, clock,
                                                         self.metrics)
        self.nc_termination = lc.NodeClaimTerminationController(self.kube, self.provider, self.metrics)
        self.node_termination = lc.NodeTerminationController(self.kube, self.provider, self.terminator,
                                                             self.recorder, self.metrics)
        self.gc = lc.NodeClaimGarbageCollectionController(self.kube, self.provider, clock)
        self.consistency = lc.ConsistencyController(self.kube, self.recorder, metrics=self.metrics)
        self.lease_gc = lc.LeaseGarbageCollectionController(self.kube)
        rng = np.random.RandomState(seed)
        pool = imp("apis.nodepool").NodePool()
        pool.metadata.name = "default"
        self.kube.create(pool)
        nc_mod = imp("apis.nodeclaim")
        for i in range(n_nodes):
            nc = nc_mod.NodeClaim()
            nc.metadata.name = f"claim-{i}"
            nc.metadata.labels = {wk.NODEPOOL_LABEL_KEY: "default"}
            nc.spec.requirements = [ob.NodeSelectorRequirement(
                wk.LABEL_INSTANCE_TYPE, "In", [self.provider.instance_types[int(rng.randint(12))].name])]
            self.kube.create(nc)
        self.lifecycle.reconcile_all()
        for nc in self.kube.list("NodeClaim"):
            node = ob.Node()
            node.metadata.name = f"node-{nc.name}"
            node.metadata.labels = {**nc.metadata.labels, wk.LABEL_HOSTNAME: node.metadata.name}
            node.spec.provider_id = nc.status.provider_id
            node.status.capacity = dict(nc.status.capacity)
            node.status.allocatable = dict(nc.status.allocatable)
            node.status.conditions = [ob.Condition(type="Ready", status="True")]
            self.kube.create(node)
        self.lifecycle.reconcile_all()
        nodes = sorted(n.name for n in self.kube.list("Node"))
        for j in range(n_nodes * 4):
            pod = ob.Pod()
            pod.metadata.name = f"pod-{j}"
            pod.metadata.namespace = "default"
            kind = rng.randint(10)
            pod.metadata.labels = {"app": "web" if kind < 5 else "batch"}
            if kind == 9:
                pod.metadata.owner_references = [ob.OwnerReference(kind="DaemonSet", name="ds")]
            if kind == 8:
                pod.spec.priority_class_name = "system-node-critical"
            if kind == 7:
                pod.spec.tolerations = [ob.Toleration(key=wk.DISRUPTION_TAINT_KEY, operator="Exists")]
            pod.spec.containers = [ob.Container(name="c", resources=ob.ResourceRequirements(
                requests={"cpu": q(f"{int(rng.randint(1, 5)) * 100}m")}))]
            pod.spec.node_name = nodes[int(rng.randint(len(nodes)))]
            pod.status.phase = "Running"
            self.kube.create(pod)
        pdb = ob.PodDisruptionBudget(selector=ob.LabelSelector(match_labels={"app": "web"}),
                                     min_available=int(rng.randint(2, 6)))
        pdb.metadata.name = "web-pdb"
        pdb.metadata.namespace = "default"
        self.kube.create(pdb)
        for k in range(3):
            lease = ob.Lease()
            lease.metadata.name = f"lease-{k}"
            lease.metadata.namespace = "kube-node-lease"
            if k == 0:
                lease.metadata.owner_references = [ob.OwnerReference(kind="Node", name=nodes[0])]
            self.kube.create(lease)

    def step(self, action: str, arg: int):
        if action == "delete_node":
            nodes = sorted(n.name for n in self.kube.list("Node") if n.metadata.deletion_timestamp is None)
            if nodes:
                self.kube.delete(self.kube.get("Node", nodes[arg % len(nodes)]))
        elif action == "terminate":
            self.node_termination.reconcile_all()
            self.nc_termination.reconcile_all()
        elif action == "evict":
            self.queue.reconcile()
        elif action == "replenish":  # a healthy replacement for an evicted web pod
            ob = self.ob
            pod = ob.Pod()
            pod.metadata.name = f"fresh-{arg}"
            pod.metadata.namespace = "default"
            pod.metadata.labels = {"app": "web"}
            pod.status.phase = "Running"
            if self.kube.get("Pod", pod.metadata.name, namespace="default") is None:
                self.kube.create(pod)
        elif action == "tick":
            # every step past the GC grace (10 s) by more than a run's wall
            # time: the grace compares the clock with wall-clock stamps
            self.now[0] += (30.0, 61.0, 900.0)[arg % 3]
        elif action == "drop_instance":  # the instance vanishes behind the store's back
            live = sorted(self.provider.created_node_claims)
            if live:
                del self.provider.created_node_claims[live[arg % len(live)]]
        elif action == "gc":
            return self.gc.reconcile()
        elif action == "consistency":
            return self.consistency.reconcile_all()
        elif action == "lease_gc":
            return self.lease_gc.reconcile()
        elif action == "lifecycle":
            self.lifecycle.reconcile_all()
        return None


ACTIONS = ("delete_node", "terminate", "terminate", "evict", "replenish", "tick", "drop_instance", "gc",
           "consistency", "lease_gc", "lifecycle")


def termination_log(pkg: str, seed: int, monkeypatch) -> list:
    """``pkg``'s world of ``seed`` through the seeded sequence → per step
    the action, its return value and the store by content."""
    operator_start(monkeypatch)
    w = TerminationWorld(pkg, seed)
    rng = np.random.RandomState(100 + seed)
    log = [store_state(w.kube, w.recorder, w.metrics)]
    for _ in range(40):
        action, arg = ACTIONS[int(rng.randint(len(ACTIONS)))], int(rng.randint(1000))
        log.append((action, w.step(action, arg), store_state(w.kube, w.recorder, w.metrics)))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_termination_sequences_equal_reference(monkeypatch, seed):
    ref = termination_log(REF, seed, monkeypatch)
    port = termination_log(PORT, seed, monkeypatch)
    assert len(port) == len(ref)
    for step, (a, b) in enumerate(zip(port, ref)):
        assert a == b, step
    # the sequence drained something and evicted under the PDB
    assert any(e[1] == "Evicted" for e in port[-1][2]["events"])
