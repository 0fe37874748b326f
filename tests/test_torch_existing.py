"""Plan identity on a live cluster: TorchScheduler ≡ TPUScheduler with
existing nodes and daemonset overhead.

Each case builds the same world twice, once from the JAX package's
classes and once from the port's (``Kit``): NodePools, catalog, pending
pods, ``StateNode``s with their bound pods, and daemonset pods. Both
schedulers solve it; the JAX reference runs its default route (tensor
path, native packer, ``reference_native`` makes sure its library
loaded). Required equal: the ordered plan stream ``(nodepool, instance
type, zone, capacity type, price, pod indices)``, the existing plans
``(node name, pod indices)``, ``pod_errors`` by pod index,
``node_count``, ``pods_scheduled`` and ``total_price``.

The scenarios are those of ``tests/test_solver_existing.py`` that stay
inside the port's slice, daemonset cases, and unit checks of
``existing_node_compat`` and of the existing-node first-fit against the
JAX package's ``pack_existing`` scan.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu.solver import pack as ref_pack
from karpenter_core_tpu_torch.solver import TorchScheduler
from karpenter_core_tpu_torch.solver import pack as port_pack
from test_torch_native import reference_native

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"


class Kit:
    """Object constructors over one package's classes (the shapes of
    ``tests/helpers.py``), with every name given so both packages'
    worlds are equal."""

    def __init__(self, pkg: str):
        self.wk = importlib.import_module(f"{pkg}.apis.labels")
        self.ob = importlib.import_module(f"{pkg}.kube.objects")
        self.pq = importlib.import_module(f"{pkg}.kube.quantity").parse_quantity
        self.NodePool = importlib.import_module(f"{pkg}.apis.nodepool").NodePool
        self.fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
        self.StateNode = importlib.import_module(f"{pkg}.state.statenode").StateNode

    def pod(
        self, name, requests=None, node_selector=None, tolerations=None, labels=None,
        node_name="", daemonset=False,
    ):
        ob = self.ob
        pod = ob.Pod()
        pod.metadata.name = name
        pod.metadata.labels = dict(labels or {})
        if daemonset:
            pod.metadata.owner_references = [ob.OwnerReference(kind="DaemonSet", name="ds")]
        pod.spec = ob.PodSpec(
            node_name=node_name,
            node_selector=dict(node_selector or {}),
            tolerations=[ob.Toleration(**t) for t in (tolerations or [])],
            containers=[
                ob.Container(
                    name="main",
                    resources=ob.ResourceRequirements(
                        requests={k: self.pq(v) for k, v in (requests or {}).items()}
                    ),
                )
            ],
        )
        if not node_name:
            pod.status.phase = "Pending"
            pod.status.conditions = [
                ob.PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
            ]
        else:
            pod.status.phase = "Running"
        return pod

    def nodepool(self, name="default", taints=None, limits=None, weight=None):
        np_ = self.NodePool()
        np_.metadata.name = name
        np_.spec.template.taints = [self.ob.Taint(**t) for t in (taints or [])]
        np_.spec.limits = {k: self.pq(v) for k, v in (limits or {}).items()}
        np_.spec.weight = weight
        return np_

    def provider(self, n_types=10, catalog=None):
        provider = self.fake.FakeCloudProvider()
        if catalog is None:
            provider.instance_types = self.fake.instance_types(n_types)
        else:
            provider.instance_types = [
                self.fake.new_instance_type(name, res) for name, res in catalog
            ]
        return provider

    def state_node(
        self, name, cpu="4", memory="16Gi", pods="100", labels=None, taints=None,
        pool="default", initialized=True,
    ):
        wk, ob = self.wk, self.ob
        node = ob.Node()
        node.metadata.name = name
        node.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: pool,
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.LABEL_HOSTNAME: name,
            **(labels or {}),
        }
        if initialized:
            node.metadata.labels[wk.NODE_INITIALIZED_LABEL_KEY] = "true"
        node.spec.provider_id = f"fake:///{name}"
        node.spec.taints = [ob.Taint(**t) for t in (taints or [])]
        capacity = {"cpu": self.pq(cpu), "memory": self.pq(memory), "pods": self.pq(pods)}
        node.status.capacity = dict(capacity)
        node.status.allocatable = dict(capacity)
        return self.StateNode(node=node)


def plan_stream(res) -> list:
    return [
        (p.nodepool_name, p.instance_type.name, p.zone, p.capacity_type, p.price, list(p.pod_indices))
        for p in res.node_plans
    ]


def existing_stream(res) -> list:
    return [(e.state_node.name(), list(e.pod_indices)) for e in res.existing_plans]


def errors_by_index(res, pods) -> dict:
    index = {p.uid: i for i, p in enumerate(pods)}
    return {index[uid]: err for uid, err in res.pod_errors.items()}


def solve_both(monkeypatch, build):
    """Solve the world ``build(kit)`` → (pools, provider, pods,
    state_nodes, daemonset_pods) with both packages and require equal
    results → (port result, port pods, port scheduler)."""
    reference_native(monkeypatch)
    out = []
    for pkg in (REF, PORT):
        pools, provider, pods, state_nodes, daemons = build(Kit(pkg))
        if pkg == REF:
            solver = TPUScheduler(pools, provider)
        else:
            solver = TorchScheduler(pools, provider, device="cpu")
        res = solver.solve(pods, state_nodes=state_nodes, daemonset_pods=daemons)
        out.append((res, pods, solver))
    (ref, ref_pods, _), (res, pods, solver) = out
    assert ref.oracle_results is None  # the reference stayed on its tensor path
    assert plan_stream(res) == plan_stream(ref)
    assert existing_stream(res) == existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    assert res.node_count == ref.node_count
    assert res.pods_scheduled == ref.pods_scheduled
    assert res.total_price == ref.total_price
    return res, pods, solver


def on_existing(res) -> int:
    return sum(len(e.pod_indices) for e in res.existing_plans)


def on_new(res) -> int:
    return sum(len(p.pod_indices) for p in res.node_plans)


# -- the scenarios of tests/test_solver_existing.py inside the slice ------------


def _fills_before_opening(k):
    sns = [k.state_node(f"node-{i}", cpu="4") for i in range(2)]
    pods = [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(8)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _overflow(k):
    sns = [k.state_node("node-0", cpu="2")]
    pods = [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(6)]
    return [k.nodepool()], k.provider(), pods, sns, []


TEAM_TAINT = dict(key="team", value="a", effect="NoSchedule")


def _tainted_plain(k):
    sns = [k.state_node("node-0", taints=[TEAM_TAINT])]
    pods = [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(2)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _tainted_tolerant(k):
    sns = [k.state_node("node-0", taints=[TEAM_TAINT])]
    tol = [dict(key="team", operator="Equal", value="a")]
    pods = [k.pod(f"p-{i}", {"cpu": "1"}, tolerations=tol) for i in range(2)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _node_selector(k):
    sns = [
        k.state_node("node-ssd", labels={"disk": "ssd"}),
        k.state_node("node-hdd", labels={"disk": "hdd"}),
    ]
    pods = [k.pod(f"p-{i}", {"cpu": "1"}, node_selector={"disk": "ssd"}) for i in range(3)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _hostname_pin(k):
    sns = [k.state_node(f"node-{i}") for i in range(3)]
    pin = {k.wk.LABEL_HOSTNAME: sns[1].hostname()}
    pods = [k.pod(f"p-{i}", {"cpu": "1"}, node_selector=pin) for i in range(2)]
    pods += [k.pod(f"q-{i}", {"cpu": "1"}) for i in range(3)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _pods_cap(k):
    sns = [k.state_node("node-0", cpu="64", pods="3")]
    pods = [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(5)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _initialized_first(k):
    sns = [k.state_node("a-uninit", initialized=False), k.state_node("z-init")]
    pods = [k.pod("p-0", {"cpu": "1"})]
    return [k.nodepool()], k.provider(), pods, sns, []


def _overcommitted(k):
    sn = k.state_node("node-0", cpu="2")
    # an existing pod consumes more than the node's allocatable memory
    sn.update_for_pod(k.pod("hog", {"cpu": "1", "memory": "32Gi"}, node_name=sn.name()))
    pods = [k.pod("p-0", {"cpu": "1"})]
    return [k.nodepool()], k.provider(), pods, [sn], []


def _no_double_use(k):
    sns = [k.state_node("only-node", cpu="4")]
    plain = [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(4)]
    tol = [dict(key="dedicated", operator="Exists")]
    other = [k.pod(f"q-{i}", {"cpu": "1"}, labels={"app": "web"}, tolerations=tol) for i in range(2)]
    return [k.nodepool()], k.provider(), plain + other, sns, []


def _memory_primary(k):
    rng = np.random.RandomState(7)
    pods = [
        k.pod(f"p-{i}", {"cpu": "100m", "memory": ["2Gi", "4Gi", "8Gi"][rng.randint(3)]})
        for i in range(200)
    ]
    sns = [k.state_node(f"node-{i}", cpu="16", memory="32Gi") for i in range(5)]
    return [k.nodepool()], k.provider(), pods, sns, []


def _random_mix(seed):
    def build(k):
        rng = np.random.RandomState(seed)
        cpus = ["100m", "250m", "500m", "1", "2"]
        mems = ["128Mi", "512Mi", "1Gi", "2Gi"]
        pods = [
            k.pod(f"p-{i}", {"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]})
            for i in range(400)
        ]
        sns = [k.state_node(f"node-{i}", cpu="8", memory="32Gi") for i in range(10)]
        return [k.nodepool()], k.provider(), pods, sns, []

    return build


SCENARIOS = {
    "fills-before-opening": _fills_before_opening,
    "overflow": _overflow,
    "tainted-node-plain-pods": _tainted_plain,
    "tainted-node-tolerant-pods": _tainted_tolerant,
    "node-selector-labels": _node_selector,
    "hostname-pin": _hostname_pin,
    "pods-cap": _pods_cap,
    "initialized-first": _initialized_first,
    "overcommitted-node": _overcommitted,
    "no-double-use": _no_double_use,
    "memory-primary-mix": _memory_primary,
    "random-mix-0": _random_mix(0),
    "random-mix-1": _random_mix(1),
    "random-mix-2": _random_mix(2),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_existing_plan_identity(monkeypatch, case):
    res, pods, solver = solve_both(monkeypatch, SCENARIOS[case])
    assert res.pods_scheduled + len(res.pod_errors) == len(pods)
    if case == "fills-before-opening":
        assert (on_existing(res), res.node_count) == (8, 0)
        # every pod fits existing capacity: no pool is encoded, no kernel runs
        assert solver.last_timings["encode_ms"] == 0.0
    elif case == "overflow":
        assert (on_existing(res), on_new(res)) == (2, 4)
    elif case == "tainted-node-plain-pods":
        assert (on_existing(res), on_new(res)) == (0, 2)
    elif case == "tainted-node-tolerant-pods":
        assert (on_existing(res), on_new(res)) == (2, 0)
    elif case == "node-selector-labels":
        assert [(e.state_node.name(), len(e.pod_indices)) for e in res.existing_plans] == [
            ("node-ssd", 3)
        ]
    elif case == "hostname-pin":
        pinned = [e for e in res.existing_plans if 0 in e.pod_indices]
        assert pinned and pinned[0].state_node.name() == "node-1"
        assert {0, 1} <= set(pinned[0].pod_indices)
    elif case == "pods-cap":
        assert (on_existing(res), on_new(res)) == (3, 2)
    elif case == "initialized-first":
        assert existing_stream(res) == [("z-init", [0])]
    elif case == "overcommitted-node":
        assert (on_existing(res), on_new(res)) == (0, 1)
    elif case == "no-double-use":
        assert on_existing(res) <= 4 and res.pods_scheduled == 6
    else:
        assert on_existing(res) > 0 and res.node_count > 0 and not res.pod_errors
    assert solver.last_timings["existing_ms"] > 0.0


# -- daemonset overhead ------------------------------------------------------------


def _daemons(k):
    return [
        k.pod("cni", {"cpu": "100m", "memory": "64Mi"}, tolerations=[dict(operator="Exists")], daemonset=True),
        k.pod("logs", {"cpu": "500m", "memory": "256Mi"}, daemonset=True),
        k.pod(
            "exporter", {"cpu": "250m", "memory": "32Mi"}, daemonset=True,
            node_selector={k.wk.CAPACITY_TYPE_LABEL_KEY: "on-demand"},
        ),
    ]


def _remaining_overhead(k):
    """Existing nodes free only what their missing daemons leave: node-0
    runs every daemon it should, node-1 runs none, node-2 runs one and is
    tainted against ``logs``, node-3 is spot (no ``exporter``)."""
    ct = k.wk.CAPACITY_TYPE_LABEL_KEY
    daemons = _daemons(k)
    sns = [
        k.state_node("node-0", cpu="4", labels={ct: "on-demand"}),
        k.state_node("node-1", cpu="4", labels={ct: "on-demand"}),
        k.state_node("node-2", cpu="4", labels={ct: "on-demand"}, taints=[TEAM_TAINT]),
        k.state_node("node-3", cpu="4", labels={ct: "spot"}),
    ]
    for d in daemons:
        sns[0].update_for_pod(_bound_copy(k, d, "node-0"))
    sns[2].update_for_pod(_bound_copy(k, daemons[0], "node-2"))
    tol = [dict(key="team", operator="Exists")]
    pods = [k.pod(f"p-{i}", {"cpu": "900m"}) for i in range(10)]
    pods += [k.pod(f"t-{i}", {"cpu": "900m"}, tolerations=tol) for i in range(6)]
    return [k.nodepool()], k.provider(), pods, sns, daemons


def _bound_copy(k, daemon, node_name):
    """The pod ``daemon`` runs on ``node_name``."""
    pod = k.pod(f"{daemon.name}-{node_name}", daemonset=True, node_name=node_name)
    pod.spec.containers[0].resources.requests = dict(daemon.spec.containers[0].resources.requests)
    return pod


def _new_node_overhead(k):
    """No existing nodes: every new node carries its pool's overhead; the
    heavier pool's taint keeps ``logs`` off its nodes."""
    pools = [
        k.nodepool("tainted", taints=[dict(key="gpu", value="yes", effect="NoSchedule")], weight=10),
        k.nodepool("default"),
    ]
    tol = [dict(key="gpu", operator="Exists")]
    pods = [k.pod(f"p-{i}", {"cpu": ["500m", "1", "1500m"][i % 3], "memory": "512Mi"}) for i in range(40)]
    pods += [k.pod(f"g-{i}", {"cpu": "1", "memory": "1Gi"}, tolerations=tol) for i in range(20)]
    return pools, k.provider(20), pods, [], _daemons(k)


def _excluded_by_pool_taint(k):
    """One pool whose taint no daemon but ``cni`` tolerates, plus an
    existing node in it that runs ``cni``."""
    taint = dict(key="batch", value="true", effect="NoSchedule")
    pools = [k.nodepool("batch", taints=[taint])]
    daemons = _daemons(k)
    sn = k.state_node("node-0", cpu="8", pool="batch", taints=[taint])
    sn.update_for_pod(_bound_copy(k, daemons[0], "node-0"))
    tol = [dict(key="batch", operator="Exists")]
    pods = [k.pod(f"p-{i}", {"cpu": "1", "memory": "1Gi"}, tolerations=tol) for i in range(30)]
    return pools, k.provider(12), pods, [sn], daemons


DAEMON_CASES = {
    "remaining-overhead-on-existing-nodes": _remaining_overhead,
    "per-pool-overhead-on-new-nodes": _new_node_overhead,
    "daemon-excluded-by-pool-taint": _excluded_by_pool_taint,
}


@pytest.mark.parametrize("case", sorted(DAEMON_CASES))
def test_daemonset_plan_identity(monkeypatch, case):
    res, pods, _ = solve_both(monkeypatch, DAEMON_CASES[case])
    assert res.pods_scheduled == len(pods) and not res.pod_errors
    if case == "remaining-overhead-on-existing-nodes":
        per_node = {e.state_node.name(): len(e.pod_indices) for e in res.existing_plans}
        # 4 cpu: node-0 runs all its daemons (850m) → 3 pods of 900m;
        # node-1 still owes 850m → 3; node-3 owes cni + logs (600m) → 3
        assert per_node["node-0"] == 3 and per_node["node-1"] == 3
    if case == "per-pool-overhead-on-new-nodes":
        assert {p.nodepool_name for p in res.node_plans} == {"tainted", "default"}


def test_daemon_overhead_changes_the_plan(monkeypatch):
    """The overhead is not a no-op: the same batch without daemonset pods
    gives a different (denser) plan."""
    res, _, _ = solve_both(monkeypatch, _new_node_overhead)
    pools, provider, pods, sns, _ = _new_node_overhead(Kit(PORT))
    bare = TorchScheduler(pools, provider, device="cpu").solve(pods, state_nodes=sns)
    assert plan_stream(bare) != plan_stream(res)


# -- existing_node_compat ------------------------------------------------------------


def _compat_world(k, seed):
    rng = np.random.RandomState(seed)
    wk = k.wk
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    nodes = []
    for m in range(24):
        labels = {
            wk.LABEL_TOPOLOGY_ZONE: zones[rng.randint(3)],
            wk.CAPACITY_TYPE_LABEL_KEY: ["spot", "on-demand"][rng.randint(2)],
            "disk": ["ssd", "hdd"][rng.randint(2)],
        }
        taints = [TEAM_TAINT] if rng.rand() < 0.3 else []
        nodes.append(
            k.state_node(f"node-{m:02d}", labels=labels, taints=taints, initialized=bool(rng.rand() < 0.8))
        )
    pods = []
    for i in range(60):
        sel = {}
        r = rng.randint(6)
        if r == 0:
            sel[wk.LABEL_TOPOLOGY_ZONE] = zones[rng.randint(3)]
        elif r == 1:
            sel["disk"] = "ssd"
        elif r == 2:
            sel[wk.LABEL_HOSTNAME] = f"node-{rng.randint(24):02d}"
        elif r == 3:
            sel[wk.LABEL_HOSTNAME] = f"node-{rng.randint(24):02d}"
            sel["disk"] = "hdd"
        elif r == 4:
            sel[wk.CAPACITY_TYPE_LABEL_KEY] = "spot"
        tol = [dict(key="team", operator="Exists")] if rng.rand() < 0.4 else []
        pods.append(k.pod(f"p-{i}", {"cpu": "1"}, node_selector=sel, tolerations=tol))
    return nodes, pods


@pytest.mark.parametrize("seed", range(3))
def test_existing_node_compat_matches_reference(seed):
    from karpenter_core_tpu.solver.encode import group_pods as ref_group_pods
    from karpenter_core_tpu.solver.solver import existing_node_compat as ref_compat
    from karpenter_core_tpu_torch.solver.encode import group_pods
    from karpenter_core_tpu_torch.solver.solver import existing_node_compat

    ref_nodes, ref_pods = _compat_world(Kit(REF), seed)
    nodes, pods = _compat_world(Kit(PORT), seed)
    ref_groups, groups = ref_group_pods(ref_pods), group_pods(pods)
    assert [g.pod_indices for g in groups] == [g.pod_indices for g in ref_groups]
    got = existing_node_compat(groups, nodes)
    want = ref_compat(ref_groups, ref_nodes)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and 0 < got.sum() < got.size


# -- the existing-node first-fit ----------------------------------------------------


def _pack_inputs(seed, P, M, S, R=3):
    rng = np.random.RandomState(seed)
    reqs = rng.randint(1, 12, size=(P, R)).astype(np.int32)
    reqs = reqs[np.lexsort((-reqs[:, 1], -reqs[:, 0]))]
    sig_ids = rng.randint(0, max(S, 1), size=P).astype(np.int32)
    compat = (rng.rand(S, M) > 0.3).astype(np.uint8)
    free = rng.randint(0, 40, size=(M, R)).astype(np.int32)
    return reqs, sig_ids, compat, free


def _edge(name):
    if name == "P=0":
        return _pack_inputs(1, 0, 5, 2)
    if name == "M=0":
        return _pack_inputs(2, 30, 0, 2)
    reqs, sig_ids, compat, free = _pack_inputs(3, 80, 9, 3)
    if name == "all-zero-rows":
        free[::2] = 0
    elif name == "all-incompatible-signature":
        compat[1] = 0
        assert (sig_ids == 1).any()
    return reqs, sig_ids, compat, free


def _check_pack_existing(reqs, sig_ids, compat, free):
    free_before = free.copy()
    assign, left = port_pack.run_pack_existing(reqs, sig_ids, compat, free)
    np.testing.assert_array_equal(free, free_before)  # the input is not modified
    ref_assign, ref_left = ref_pack.run_pack_existing(reqs, sig_ids, compat, free.copy())
    if reqs.shape[0] and free.shape[0]:
        # the JAX scan itself (jitted on the CPU), not its native twin
        ref_assign, ref_left = ref_pack.pack_existing(reqs, sig_ids, compat.astype(bool), free)
    np.testing.assert_array_equal(assign, np.asarray(ref_assign))
    np.testing.assert_array_equal(left, np.asarray(ref_left))
    plain_assign, plain_left = port_pack.pack_existing_reference(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (reqs, sig_ids, compat, free))
    )
    np.testing.assert_array_equal(plain_assign.numpy(), assign)
    np.testing.assert_array_equal(plain_left.numpy(), left)
    return assign


@pytest.mark.parametrize("seed", range(5))
def test_pack_existing_matches_reference_scan(seed):
    rng = np.random.RandomState(50 + seed)
    P, M, S = int(rng.randint(1, 300)), int(rng.randint(1, 40)), int(rng.randint(1, 6))
    assign = _check_pack_existing(*_pack_inputs(seed, P, M, S, R=int(rng.randint(2, 5))))
    assert (assign >= 0).any()


@pytest.mark.parametrize("case", ["P=0", "M=0", "all-zero-rows", "all-incompatible-signature"])
def test_pack_existing_edges_match_reference(case):
    reqs, sig_ids, compat, free = _edge(case)
    assign = _check_pack_existing(reqs, sig_ids, compat, free)
    if case == "M=0":
        assert (assign == -1).all()
    elif case == "all-zero-rows":
        assert not np.isin(assign, np.arange(0, free.shape[0], 2)).any()
    elif case == "all-incompatible-signature":
        assert (assign[sig_ids == 1] == -1).all()
