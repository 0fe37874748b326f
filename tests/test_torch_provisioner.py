"""The port's Provisioner ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/provisioning/`` is the port's copy of the JAX
package's provisioner, with ``TorchScheduler`` (``device="cpu"``) on its
batched path where the reference has ``TPUScheduler``. Held to it:

- every test of ``TestProvisioner`` in ``tests/test_state_provisioning.py``
  (``test_tpu_solver_backend`` included) runs from its own source twice,
  once as written and once on the port, and the two runs leave the same
  store behind: the NodeClaims as a content multiset (pool, labels,
  annotations, requirements, requests, owner references, the pods
  nominated to each) and the other events;
- ``reconcile`` of seeded worlds through both packages' full stacks
  (``KubeClient`` + ``Informers`` + ``Cluster`` + ``Recorder`` +
  ``Metrics`` + ``Provisioner``), on both ``use_tpu_solver`` values:
  existing initialized nodes with their NodeClaims and bound pods, a
  daemonset, a limited pool beside an open one, a node marked for
  deletion whose pods need new capacity, a group of Helm-style pods with
  soft anti-affinity (the batched solve's greedy fallback), and bound
  pods with **required** anti-affinity whose selectors match pending
  pods (the greedy scheduler's inverse walk over
  ``Cluster.for_pods_with_anti_affinity``). Equal, exactly: the
  returned names' count and reason, the claims (content multiset), the
  events (nominations to existing nodes, failures, counts), the
  cluster's nominated nodes, and the ``nodeclaims_created`` and
  ``solver_route_pods`` samples;
- the parity shadow sets the same ``solver_parity`` gauge;
- the port's Provisioner on the batched path creates one claim per new
  plan of a direct ``TorchScheduler.solve`` of the same pods against
  ``cluster.deep_copy_nodes()``;
- ``chip_smoke.py``'s phase 13, each part cut down, runs on the CPU with
  all its checks.

Generated names come from each package's counter (``same_start`` restarts
both); the greedy path creates its claims on a thread pool, so names are
never compared, only content.
"""

from __future__ import annotations

import copy
import importlib
import time
from pathlib import Path

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_native import reference_native
from test_torch_oracle import _port_helpers, same_start


def reference_setup(monkeypatch) -> None:
    """Both batched solvers on their default routes, no cross-solve memo
    carried from an earlier test."""
    reference_native(monkeypatch)
    monkeypatch.setenv("KARPENTER_TPU_INCREMENTAL", "0")
    for pkg in (REF, PORT):
        importlib.import_module(f"{pkg}.solver.backends").reset_for_tests()


# -- the summary both packages must agree on ----------------------------------


def _reqs(nc) -> list:
    return sorted((r.key, r.operator, tuple(sorted(r.values))) for r in nc.spec.requirements)


def store_summary(kube, recorder, cluster=None, metrics=None) -> dict:
    """The store after a reconcile, by content: claims with the pods
    nominated to each, the other events, nominated nodes, samples."""
    claims = {nc.name: nc for nc in kube.list("NodeClaim")}
    nominated_to: dict = {name: [] for name in claims}
    other = []
    for e in recorder.events:
        target = e.message.rsplit(": ", 1)[-1] if e.reason == "Nominated" else None
        if target in claims:
            nominated_to[target].append(e.involved_object.name)
        else:
            other.append((e.type, e.reason, getattr(e.involved_object, "name", ""), e.message))
    out = dict(
        claims=sorted(
            (
                sorted(nc.metadata.labels.items()),
                sorted(nc.metadata.annotations.items()),
                _reqs(nc),
                sorted(nc.spec.resources.requests.items()),
                [(o.kind, o.name, o.block_owner_deletion) for o in nc.metadata.owner_references],
                [(t.key, t.value, t.effect) for t in nc.spec.taints],
                sorted(nominated_to[nc.name]),
            )
            for nc in claims.values()
            if nc.status.provider_id == ""
        ),
        events=sorted(other),
        n_events=len(recorder.events),
    )
    if cluster is not None:
        out["nominated_nodes"] = sorted(pid for pid in cluster.nodes if cluster.is_node_nominated(pid))
    if metrics is not None:
        out["nodeclaims_created"] = sorted(metrics.nodeclaims_created.values.items())
        out["solver_route_pods"] = sorted(metrics.solver_route_pods.values.items())
    return out


# -- TestProvisioner of tests/test_state_provisioning.py, on both packages ----

FILE = "test_state_provisioning.py"
CASES = mirror_cases(FILE, classes=("TestProvisioner",))


def _port_provisioner():
    from karpenter_core_tpu_torch.provisioning import Provisioner

    return lambda *a, **kw: Provisioner(*a, device="cpu", **kw)


def provisioning_mirror(pkg: str):
    """test_state_provisioning.py for ``pkg``, with its ``env`` fixture's
    store clocks fixed and, on the port, the Provisioner on the CPU."""
    replace = (
        ("kube = KubeClient()", "kube = KubeClient(clock=lambda: 5000.0)"),
        ("recorder = Recorder(kube)", "recorder = Recorder(kube, clock=lambda: 5000.0)"),
    )
    inject = {}
    if pkg == PORT:
        replace += (("from {pkg}.provisioning import Provisioner", "Provisioner = _PROVISIONER"),)
        inject["_PROVISIONER"] = _port_provisioner()
    return mirror(FILE, pkg, replace=replace, inject=inject)


def test_mirror_covers_the_class():
    assert len(CASES) == 8
    assert (("TestProvisioner", "test_tpu_solver_backend", 0)) in CASES


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_provisioner_case_matches_reference(monkeypatch, case):
    reference_setup(monkeypatch)
    out = {}
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        fixtures = run_mirrored(provisioning_mirror(pkg), *case)
        kube, _, cluster, _, recorder = fixtures["env"]
        out[pkg] = store_summary(kube, recorder, cluster)
    assert out[PORT] == out[REF]


# -- seeded worlds through the full stack -------------------------------------


class World:
    """One package's stack over a fixed clock: ``KubeClient``,
    ``Informers`` into ``Cluster``, ``Recorder`` (into the store),
    ``Metrics``, ``Provisioner`` (the port's on ``device``)."""

    NOW = 10_000.0

    def __init__(self, pkg: str, monkeypatch, use_tpu_solver: bool, metrics: bool = True,
                 n_types: int = 20, device: str = "cpu"):
        same_start(monkeypatch)
        self.pkg = pkg
        self.h = importlib.import_module("helpers") if pkg == REF else _port_helpers()
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.wk = imp("apis.labels")
        self.ob = imp("kube.objects")
        self.pq = imp("kube.quantity").parse_quantity
        self.NodeClaim = imp("apis.nodeclaim").NodeClaim
        clock = lambda: self.NOW  # noqa: E731
        self.kube = imp("kube.client").KubeClient(clock=clock)
        self.provider = imp("cloudprovider.fake").FakeCloudProvider()
        self.provider.instance_types = imp("cloudprovider.fake").instance_types(n_types)
        self.cluster = imp("state.cluster").Cluster(self.kube, self.provider, clock=clock)
        self.informers = imp("state.informers").Informers(self.kube, self.cluster)
        self.informers.start()
        self.recorder = imp("events").Recorder(self.kube, clock=clock)
        self.metrics = imp("metrics.registry").Metrics() if metrics else None
        kw = dict(recorder=self.recorder, use_tpu_solver=use_tpu_solver, metrics=self.metrics)
        if pkg == PORT:
            kw["device"] = device
        self.provisioner = imp("provisioning").Provisioner(self.kube, self.provider, self.cluster, **kw)

    def stop(self) -> None:
        self.informers.stop()

    def summary(self) -> dict:
        return store_summary(self.kube, self.recorder, self.cluster, self.metrics)

    # -- builders ---------------------------------------------------------

    def pool(self, name="default", limits=None, weight=None, taints=None):
        np_ = self.h.make_nodepool(name, limits=limits, weight=weight, taints=taints)
        self.kube.create(np_)
        return np_

    def node(self, name, it_name, zone, pool="default", capacity_type="on-demand"):
        """An initialized node and its launched claim, as a real
        registration leaves them in the store."""
        wk = self.wk
        it = next(i for i in self.provider.instance_types if i.name == it_name)
        pid = f"fake:///{name}"
        labels = {
            wk.NODEPOOL_LABEL_KEY: pool, wk.LABEL_INSTANCE_TYPE: it_name,
            wk.LABEL_TOPOLOGY_ZONE: zone, wk.CAPACITY_TYPE_LABEL_KEY: capacity_type,
        }
        nc = self.NodeClaim()
        nc.metadata.name = f"claim-{name}"
        nc.metadata.labels = dict(labels)
        nc.status.provider_id = pid
        nc.status.capacity = dict(it.capacity)
        nc.status.allocatable = it.allocatable()
        self.kube.create(nc)
        node = self.h.make_node(
            name=name,
            labels={**labels, wk.NODE_REGISTERED_LABEL_KEY: "true", wk.NODE_INITIALIZED_LABEL_KEY: "true"},
            capacity=dict(it.capacity), provider_id=pid,
        )
        node.status.allocatable = it.allocatable()
        self.kube.create(node)
        return node

    def bound(self, name, node, cpu="500m", labels=None, anti=None, owner_kind="ReplicaSet"):
        pod = self.h.make_pod(
            name=name, requests={"cpu": cpu, "memory": "256Mi"}, labels=labels,
            node_name=node, phase="Running", pending_unschedulable=False,
            pod_anti_affinity=anti, owner_kind=owner_kind,
        )
        self.kube.create(pod)
        return pod

    def daemonset(self, name, cpu):
        ds = self.ob.DaemonSet()
        ds.metadata.name = name
        ds.metadata.namespace = "kube-system"
        ds.pod_template_spec = self.ob.PodSpec(containers=[self.ob.Container(
            name="main", resources=self.ob.ResourceRequirements(requests={"cpu": self.pq(cpu)}),
        )])
        self.kube.create(ds)

    def pending(self, name, cpu, mem="512Mi", **kw):
        pod = self.h.make_pod(name=name, requests={"cpu": cpu, "memory": mem}, **kw)
        self.kube.create(pod)
        return pod

    def basic_pods(self, n: int) -> None:
        self.pool()
        for i in range(n):
            self.pending(f"p{i}", "500m")

    def anti_term(self, key, labels):
        return [self.ob.PodAffinityTerm(
            topology_key=key, label_selector=self.ob.LabelSelector(match_labels=dict(labels)),
        )]

    def soft_anti(self, labels):
        ob = self.ob
        return ob.Affinity(pod_anti_affinity=ob.PodAntiAffinity(preferred=[
            ob.WeightedPodAffinityTerm(1, ob.PodAffinityTerm(
                topology_key=self.wk.LABEL_HOSTNAME,
                label_selector=ob.LabelSelector(match_labels=dict(labels)),
            )),
        ]))


def rich_world(w: World, seed: int) -> None:
    """Existing nodes in three zones with bound pods, one of them marked
    for deletion; a daemonset; ``reserved`` (weight 10, cpu limit) and
    ``default``; pending pods of seeded sizes, some pinned to a capacity
    type, six Helm-style replicas with soft anti-affinity, and bound
    pods with required hostname and zone anti-affinity against the
    ``app=web`` and ``app=db`` pods that are pending."""
    import random

    rng = random.Random(seed)
    wk = w.wk
    w.pool("reserved", limits={"cpu": "12"}, weight=10)
    w.pool("default")
    w.daemonset("agent", "100m")
    zones = ("test-zone-1", "test-zone-2", "test-zone-3")
    types = sorted(it.name for it in w.provider.instance_types)
    for i in range(6):
        w.node(f"node-{i}", types[(7 + 3 * i) % len(types)], zones[i % 3], pool="default")
        for j in range(rng.randint(0, 2)):
            w.bound(f"b{i}-{j}", f"node-{i}", cpu=rng.choice(["250m", "500m", "1"]))
    # required anti-affinity of bound pods: node-0 refuses web pods on
    # its hostname, and zone 2 refuses db pods
    w.bound("guard-web", "node-0", labels={"role": "guard"},
            anti=w.anti_term(wk.LABEL_HOSTNAME, {"app": "web"}))
    w.bound("guard-db", "node-1", labels={"role": "guard"},
            anti=w.anti_term(wk.LABEL_TOPOLOGY_ZONE, {"app": "db"}))
    # a node on its way out: its pods need new capacity
    w.node("node-drain", types[5], zones[0])
    w.bound("drain-0", "node-drain", cpu="1")
    w.bound("drain-1", "node-drain", cpu="250m")
    w.cluster.mark_for_deletion("fake:///node-drain")
    for i in range(rng.randint(20, 30)):
        sel = {}
        if i % 7 == 3:
            sel = {wk.CAPACITY_TYPE_LABEL_KEY: rng.choice(["spot", "on-demand"])}
        w.pending(f"p{i}", rng.choice(["100m", "250m", "500m", "1", "2"]),
                  rng.choice(["128Mi", "512Mi", "1Gi", "4Gi"]), node_selector=sel)
    for i in range(4):
        w.pending(f"web-{i}", "250m", labels={"app": "web"})
    for i in range(3):
        w.pending(f"db-{i}", "500m", labels={"app": "db"})
    for i in range(6):
        p = w.pending(f"cache-{i}", "200m", labels={"app.kubernetes.io/name": "cache"})
        p.spec.affinity = w.soft_anti({"app.kubernetes.io/name": "cache"})


def guard_violations(w: World) -> list:
    """Pods this reconcile nominated that a bound guard's required
    anti-affinity excludes: web pods on node-0, db pods in zone 2."""
    wk = w.wk
    zone_of = {n.name: n.metadata.labels.get(wk.LABEL_TOPOLOGY_ZONE) for n in w.kube.list("Node")}
    claim_zone = {}
    for nc in w.kube.list("NodeClaim"):
        for r in nc.spec.requirements:
            if r.key == wk.LABEL_TOPOLOGY_ZONE and len(r.values) == 1:
                claim_zone[nc.name] = r.values[0]
    bad = []
    for e in w.recorder.events:
        if e.reason != "Nominated":
            continue
        target = e.message.rsplit(": ", 1)[-1]
        app = e.involved_object.metadata.labels.get("app")
        if app == "web" and target == "node-0":
            bad.append((e.involved_object.name, target))
        zone = zone_of.get(target, claim_zone.get(target))
        if app == "db" and zone == "test-zone-2":
            bad.append((e.involved_object.name, target))
    return bad


def reconcile_both(monkeypatch, build, use_tpu_solver: bool) -> tuple:
    reference_setup(monkeypatch)
    out, worlds = {}, {}
    for pkg in (REF, PORT):
        w = World(pkg, monkeypatch, use_tpu_solver)
        build(w)
        assert w.cluster.synced()
        names, reason = w.provisioner.reconcile()
        out[pkg] = dict(n_names=len(names), reason=reason, **w.summary())
        worlds[pkg] = w
        w.stop()
    return out, worlds


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_tpu_solver", [False, True], ids=["greedy", "batched"])
def test_reconcile_matches_reference(monkeypatch, use_tpu_solver, seed):
    out, worlds = reconcile_both(monkeypatch, lambda w: rich_world(w, seed), use_tpu_solver)
    ref = out[REF]
    assert ref["reason"] is None and ref["n_names"] == len(ref["claims"]) > 0
    assert ref["nominated_nodes"], "nothing went onto an existing node"
    assert any(r == "Nominated" for _, r, _, _ in ref["events"])
    routes = dict((k[0][1], v) for k, v in ref["solver_route_pods"])
    if use_tpu_solver:
        assert routes.get("oracle", 0) >= 6, routes  # the soft anti-affinity group
    else:
        assert routes == {}
    assert out[PORT] == ref
    if not use_tpu_solver:
        # the greedy scheduler walked the bound guards
        assert guard_violations(worlds[PORT]) == []
    else:
        # the batched solve's tensor path does not read the inverse
        # anti-affinity of bound pods in either package (ROADMAP C8):
        # the port copies what the reference places
        assert guard_violations(worlds[PORT]) == guard_violations(worlds[REF])


@pytest.mark.parametrize("seed", [0, 1])
def test_two_reconciles_warm_equal_reference_cold(monkeypatch, seed):
    """The port's Provisioner keeps one TorchScheduler across reconciles,
    so with its memos on (the default) its second reconcile is a warm
    solve; the JAX package's runs with its memo off. Between the two, the
    first reconcile's claims launch (provider ids set) and more pods
    arrive. The stores are equal after each reconcile, and the port's
    second solve served compat rows from its memo."""
    reference_setup(monkeypatch)
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    importlib.import_module(f"{PORT}.solver.incremental").reset()
    out, stats = {}, None
    for pkg in (REF, PORT):
        w = World(pkg, monkeypatch, use_tpu_solver=True)
        rich_world(w, seed)
        rows = []
        for rnd in range(2):
            names, reason = w.provisioner.reconcile()
            rows.append(dict(n_names=len(names), reason=reason, **w.summary()))
            for nc in w.kube.list("NodeClaim"):
                if not nc.status.provider_id:
                    nc.status.provider_id = f"fake:///launched-{nc.name}"
                    w.kube.update(nc)
            for i in range(6):
                w.pending(f"late-{rnd}-{i}", ["250m", "1"][i % 2])
        if pkg == PORT:
            stats = w.provisioner._tpu_solver[1].last_cache_stats
        out[pkg] = rows
        w.stop()
    assert out[REF][0]["n_names"] > 0 and out[REF][1]["reason"] is None
    assert out[PORT] == out[REF]
    assert stats["hits"].get("compat", 0) > 0, stats


def test_inverse_walk_excludes_domains(monkeypatch):
    """Without the walk a web pod would fit node-0 first: a world where
    node-0 is the only existing node with room, and only web pods are
    pending. Both greedy schedulers keep them off it."""
    def build(w):
        w.pool("default")
        types = sorted(it.name for it in w.provider.instance_types)
        w.node("node-0", types[12], "test-zone-1")
        w.bound("guard-web", "node-0", labels={"role": "guard"},
                anti=w.anti_term(w.wk.LABEL_HOSTNAME, {"app": "web"}))
        for i in range(3):
            w.pending(f"web-{i}", "100m", labels={"app": "web"})
        w.pending("other", "100m")

    out, worlds = reconcile_both(monkeypatch, build, use_tpu_solver=False)
    assert out[PORT] == out[REF]
    assert guard_violations(worlds[PORT]) == []
    nominated_existing = [
        e.involved_object.name for e in worlds[PORT].recorder.events
        if e.reason == "Nominated" and e.message.endswith(": node-0")
    ]
    assert nominated_existing == ["other"]


def test_cluster_sync_gate(monkeypatch):
    """A claim without a provider id holds both provisioners at
    'waiting on cluster sync', creating nothing."""
    def build(w):
        w.basic_pods(3)
        nc = w.NodeClaim()
        nc.metadata.name = "launching"
        w.kube.create(nc)

    reference_setup(monkeypatch)
    out = {}
    for pkg in (REF, PORT):
        w = World(pkg, monkeypatch, use_tpu_solver=True)
        build(w)
        out[pkg] = (w.provisioner.reconcile(), w.summary())
        w.stop()
    assert out[REF][0] == ([], "waiting on cluster sync")
    assert out[PORT] == out[REF]


def test_parity_shadow_gauge_matches_reference(monkeypatch):
    reference_setup(monkeypatch)
    gauges = {}
    for pkg in (REF, PORT):
        w = World(pkg, monkeypatch, use_tpu_solver=True)
        w.provisioner.PARITY_SAMPLE_EVERY = 1
        w.basic_pods(12)
        w.provisioner.reconcile()
        deadline = time.monotonic() + 120
        while w.provisioner._parity_inflight and time.monotonic() < deadline:
            time.sleep(0.05)
        gauges[pkg] = w.metrics.solver_parity.get()
        w.stop()
    assert gauges[REF] is not None
    assert gauges[PORT] == gauges[REF]


def test_batched_claims_equal_direct_solve(monkeypatch):
    """One NodeClaim per new plan of the direct solve of the same pods
    against the cluster's node copies and daemonset pods."""
    from karpenter_core_tpu_torch.solver import TorchScheduler

    reference_setup(monkeypatch)
    w = World(PORT, monkeypatch, use_tpu_solver=True)
    rich_world(w, 0)
    w.informers.stop()
    pods = w.provisioner.get_pending_pods()
    nodes = w.cluster.deep_copy_nodes()
    deleting = [n for n in nodes if n.marked_for_deletion]
    for n in deleting:
        for ns, name in n.pod_requests:
            pods.append(w.kube.get("Pod", name, namespace=ns))
    pools = [np_ for np_ in w.kube.list("NodePool")]
    # copies: the greedy fallback relaxes its pods' preferences in place
    direct = TorchScheduler(pools, w.provider, device="cpu", kube_client=w.kube).solve(
        copy.deepcopy(pods), state_nodes=[n for n in nodes if not n.marked_for_deletion],
        daemonset_pods=w.cluster.get_daemonset_pods(),
    )
    w.informers.start()
    names, reason = w.provisioner.reconcile()
    assert reason is None
    claims = [nc for nc in w.kube.list("NodeClaim") if not nc.status.provider_id]
    planned = sorted(
        (p.nodepool_name, p.instance_type.name, p.zone, p.capacity_type) for p in direct.node_plans
    )
    wk = w.wk
    from_tensor = []
    for nc in claims:
        req = {r.key: r.values for r in nc.spec.requirements}
        if len(req.get(wk.LABEL_INSTANCE_TYPE, ())) == 1 and len(req.get(wk.LABEL_TOPOLOGY_ZONE, ())) == 1:
            from_tensor.append((
                nc.metadata.labels[wk.NODEPOOL_LABEL_KEY], req[wk.LABEL_INSTANCE_TYPE][0],
                req[wk.LABEL_TOPOLOGY_ZONE][0], req[wk.CAPACITY_TYPE_LABEL_KEY][0],
            ))
    assert sorted(from_tensor) == planned
    greedy = len(direct.oracle_results.new_node_claims) if direct.oracle_results else 0
    assert len(names) == len(planned) + greedy
    w.stop()


# -- chip_smoke.py's phase 13, cut down ----------------------------------------

PHASE13_SIZES = {"config2": (1500,), "cluster": (3000, 200, 100), "guard": (600, 200, 60, 4)}


@pytest.mark.parametrize("part", sorted(PHASE13_SIZES))
def test_chip_smoke_phase13_cut_down(part):
    """Each part of ``chip_smoke.py``'s phase 13 on the CPU at a cut size,
    with every check it makes on the card: plans equal to the direct
    solves, one claim per plan, a Nominated event per placed pod,
    nominations, samples, the trace's spans, the claims of a second
    reconcile, the inverse anti-affinity of the guards."""
    from test_torch_cluster import REPO, _load

    with open(Path(REPO) / "chip_smoke.py", encoding="utf-8") as f:
        smoke = _load("chip_smoke_phase13", f.read())
    run = {
        "config2": smoke.run_provisioner_config2,
        "cluster": smoke.run_provisioner_cluster,
        "guard": smoke.run_provisioner_guard,
    }[part]
    out = run("cpu", *PHASE13_SIZES[part])
    row = out["rows"]["cluster"] if part == "cluster" else out
    assert row["claims"] > 0 and row["nominated_pods"] == row["pods_scheduled"]
    assert row["span_solve_ms"] > 0 and row["span_create_node_claims_ms"] > 0
    if part == "cluster":
        assert row["pods_on_existing"] > 0 and out["compat_err"] == 0
        assert out["rows"]["cluster-device"]["pods_scheduled"] == row["pods_scheduled"]
    if part == "guard":
        assert row["inverse_anti"]["greedy_checked"] > 0
