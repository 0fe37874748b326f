"""Preference relaxation and the greedy fallback in ``TorchScheduler`` ≡
the JAX package's ``TPUScheduler``.

The port's ``_relax_and_retry`` (the preference ladder on a copy of each
failed group's exemplar, back-fill onto this solve's node plans, another
tensor pass), ``_commit_existing_plans`` and ``_solve_oracle`` are
copies of the JAX package's. Each case builds its world separately from
each package (``same_start`` gives both the same generated names and
uids) and requires identical results: the plan stream and its sha256,
existing plans, pod errors by pod index, the greedy fallback's claims
(nodepool, pods, instance-type options), node count, pods scheduled and
price.

- the 8 scenarios of ``tests/test_solver_relaxation.py``, their source
  run once as written and once against the port (its own assertions
  then hold the port too);
- back-fill onto this solve's plans, the commit before the greedy
  fallback, and the caller's state nodes left unchanged by both;
- ``chip_smoke.py``'s phase-11 worlds cut down (about 1,500 pods and
  100 nodes): the oracle mix with and without the cluster, and the
  relaxation cluster, with the reference's route split required.
"""

from __future__ import annotations

import pytest

from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu_torch.solver import TorchScheduler
from test_torch_cluster import REPO, _load
from test_torch_native import reference_native
import test_torch_oracle as oracle_tests
from test_torch_oracle import PORT, REF, assert_same_results, run_scenario, scenarios
from test_torch_topology import TKit

RELAX_SCENARIOS = scenarios(["test_solver_relaxation.py"])


def test_relaxation_table_has_every_scenario():
    assert len(RELAX_SCENARIOS) == 8


@pytest.mark.parametrize(
    "file,cls,name,case", RELAX_SCENARIOS, ids=[f"{c}::{n}" for _, c, n, _ in RELAX_SCENARIOS]
)
def test_relaxation_scenario_matches_reference(monkeypatch, file, cls, name, case):
    reference_native(monkeypatch)
    ref = run_scenario(file, cls, name, case, REF, monkeypatch)
    port = run_scenario(file, cls, name, case, PORT, monkeypatch)
    assert ref and port == ref


def solve_pair(monkeypatch, build, route=None):
    return oracle_tests.solve_pair(monkeypatch, build, TKit, route)


def _preferred_zone(k, zone, weight=10):
    return k.ob.PreferredSchedulingTerm(
        weight=weight,
        preference=k.ob.NodeSelectorTerm(
            match_expressions=[k.ob.NodeSelectorRequirement(k.wk.LABEL_TOPOLOGY_ZONE, "In", [zone])]
        ),
    )


def _soft_anti(k, labels, weight=1):
    return k.ob.Affinity(
        pod_anti_affinity=k.ob.PodAntiAffinity(
            preferred=[k.ob.WeightedPodAffinityTerm(weight, k.term(k.wk.LABEL_HOSTNAME, labels))]
        )
    )


def _backfill_world(k):
    """Plain pods open a plan; relaxed pods (an impossible preferred zone)
    fill it in the retry instead of opening a node."""
    provider = k.provider(catalog=[("one-size", {"cpu": "4", "memory": "16Gi", "pods": "100"})])
    pods = [k.pod(f"f-{i}", {"cpu": "1"}) for i in range(2)]
    for i in range(2):
        p = k.pod(f"r-{i}", {"cpu": "500m"})
        p.spec.affinity = k.ob.Affinity(
            node_affinity=k.ob.NodeAffinity(preferred=[_preferred_zone(k, "no-such-zone")])
        )
        pods.append(p)
    return dict(pools=[k.nodepool()], provider=provider, pods=pods, kube=k.KubeClient())


def test_backfill_onto_this_solves_plans(monkeypatch):
    res, w, solver, _ = solve_pair(monkeypatch, _backfill_world, route={"oracle": 0})
    assert res.node_count == 1 and res.pods_scheduled == 4
    assert solver.last_relax_stats["rounds"] == 1 and solver.last_relax_stats["pods_placed"] == 2


def _commit_world(k, tensor_first: bool = True):
    """Two existing 4-CPU nodes; plain pods take 3 CPU of each on the
    tensor path, and a soft anti-affinity release (the greedy fallback),
    whose 1.2-CPU replicas would fit an empty node, must see what the
    tensor path already put there."""
    nodes = [
        k.zone_node(f"node-{n}", ["test-zone-1", "test-zone-2"][n], cpu="4") for n in range(2)
    ]
    pods = [k.pod(f"plain-{i}", {"cpu": "1500m"}, labels={"app": "plain"}) for i in range(4)]
    rel = {"app.kubernetes.io/name": "redis", "app.kubernetes.io/instance": "r1"}
    for i in range(3):
        p = k.pod(f"redis-{i}", {"cpu": "1200m"}, labels=dict(rel))
        p.spec.affinity = _soft_anti(k, rel)
        pods.append(p)
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=nodes, kube=k.KubeClient())


def test_commit_before_oracle(monkeypatch):
    res, w, _, _ = solve_pair(monkeypatch, _commit_world, route={"oracle": 3, "tensor": 4})
    on_existing = {e.state_node.name(): list(e.pod_indices) for e in res.existing_plans}
    assert sum(len(v) for v in on_existing.values()) == 4
    # the greedy fallback saw the committed pods (1 CPU left per node)
    # and opened claims, one replica per node
    assert res.oracle_results is not None
    assert not any(e.pods for e in res.oracle_results.existing_nodes)
    assert [len(c.pods) for c in res.oracle_results.new_node_claims] == [1, 1, 1]


def _snapshot(nodes):
    return [
        (n.name(), sorted(n.pod_requests), sorted(n.daemonset_requests), n.available(),
         sorted(n.host_port_usage.reserved))
        for n in nodes
    ]


def _unchanged_world(k):
    """Relaxed and routed-off pods against two existing nodes."""
    w = _commit_world(k)
    for i in range(3):
        p = k.pod(f"pref-{i}", {"cpu": "250m"})
        p.spec.affinity = k.ob.Affinity(
            node_affinity=k.ob.NodeAffinity(preferred=[_preferred_zone(k, "no-such-zone")])
        )
        w["pods"].append(p)
    return w


def test_callers_state_nodes_unchanged(monkeypatch):
    before = {}

    def build(k):
        w = _unchanged_world(k)
        before[k.wk.__name__] = _snapshot(w["state_nodes"])
        build.last = w
        return w

    res, w, solver, _ = solve_pair(monkeypatch, build)
    assert res.oracle_results is not None and solver.last_relax_stats["rounds"] >= 1
    assert _snapshot(w["state_nodes"]) == before[f"{PORT}.apis.labels"]
    # a second solve on the same nodes gives the same result
    again = TorchScheduler(w["pools"], w["provider"], device="cpu", kube_client=w["kube"]).solve(
        w["pods"], state_nodes=w["state_nodes"]
    )
    assert_same_results(again, w["pods"], res, w["pods"])


def _limit_world(k):
    """A pool limited to 16 CPU of 4-CPU nodes: four plain 3-CPU pods on
    the tensor path take it all, four soft anti-affinity replicas go to
    the greedy fallback."""
    provider = k.provider(catalog=[("four", {"cpu": "4", "memory": "16Gi", "pods": "100"})])
    pods = [k.pod(f"plain-{i}", {"cpu": "3"}, labels={"app": "plain"}) for i in range(4)]
    rel = {"app.kubernetes.io/name": "cache"}
    for i in range(4):
        p = k.pod(f"cache-{i}", {"cpu": "3"}, labels=dict(rel))
        p.spec.affinity = _soft_anti(k, rel)
        pods.append(p)
    return dict(pools=[k.nodepool(limits={"cpu": "16"})], provider=provider, pods=pods, kube=k.KubeClient())


def test_greedy_fallback_limit_accounting_copied(monkeypatch):
    """The reference's fallback starts from the pools' limits less the
    existing nodes, not less the tensor pass's new nodes
    (``_solve_oracle``): here the two together open 32 CPU under a
    16-CPU limit. A fault of the reference (ROADMAP C), copied as it is."""
    res, _, _, _ = solve_pair(monkeypatch, _limit_world, route={"oracle": 4, "tensor": 4})
    claims = res.oracle_results.new_node_claims
    cpu = sum(p.instance_type.capacity["cpu"] for p in res.node_plans) + sum(
        max(it.capacity["cpu"] for it in c.instance_type_options) for c in claims
    )
    assert (len(res.node_plans), len(claims), cpu) == (4, 4, 32 * 10**9)


# -- chip_smoke.py phase 11, cut down ----------------------------------------------


@pytest.fixture(scope="module")
def smokes():
    with open(f"{REPO}/chip_smoke.py", encoding="utf-8") as f:
        source = f.read()
    return (
        _load("chip_smoke_ref", source.replace("karpenter_core_tpu_torch", "karpenter_core_tpu")),
        _load("chip_smoke", source),
    )


# (world function, its arguments, release pods the greedy fallback takes)
PHASE11 = {
    "oracle-mix": ("oracle_mix_world", (1400, 100, 10), 342),
    "oracle-cluster": ("oracle_cluster_world", (1400, 200, 100, 10), 342),
    "oracle-cluster-two-releases": ("oracle_cluster_world", (700, 200, 100, 2), 102),
    "relax-cluster": ("relax_cluster_world", (1500, 200, 100), 0),
}


def _solve_world(world, pkg):
    pools, provider, pods, nodes, daemons, _, kube = world
    if pkg == REF:
        solver = TPUScheduler(pools, provider, kube_client=kube)
    else:
        solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
    return solver.solve(pods, state_nodes=nodes, daemonset_pods=daemons), solver


@pytest.mark.parametrize("world", sorted(PHASE11))
def test_phase11_world_plan_identity(smokes, monkeypatch, world):
    """Each phase-11 world, built by the script from each package's
    classes, solves to the same plans, errors and greedy claims; the
    reference routes exactly the release pods to its oracle; the script's
    checks hold on the port's result."""
    reference_native(monkeypatch)
    fn, args, n_release = PHASE11[world]
    out = []
    for module, pkg in zip(smokes, (REF, PORT)):
        oracle_tests.same_start(monkeypatch)
        w = getattr(module, fn)(*args)
        res, solver = _solve_world(w, pkg)
        out.append((res, w, solver))
    (ref, ref_w, ref_solver), (res, w, solver) = out
    assert ref_solver.last_route_stats["oracle"] == n_release
    assert ref_solver.last_route_stats["parked"] == (0 if world == "relax-cluster" else solver.last_route_stats["parked"])
    assert_same_results(res, w[2], ref, ref_w[2])
    smoke = smokes[1]
    pools, provider, pods, nodes, daemons, missing, kube = w
    if n_release:
        smoke.check_oracle(res, pods, n_release, solver.last_route_stats)
        smoke.check_affinity(res, pods, kube)
        smoke.check_spread_serial(res, pods, provider, first=smoke.first_fit(res, pods))
    if nodes:
        smoke.check_cluster(res, pods, nodes, daemons, missing, spill=False)
    else:
        smoke.check_invariants(res, pods)
    if world == "relax-cluster":
        assert not res.pod_errors
        assert solver.last_relax_stats["rounds"] >= 1 and solver.last_relax_stats["pods_placed"] > 0
        assert not any(p.zone == smoke.DROUGHT_ZONE for p in res.node_plans)
