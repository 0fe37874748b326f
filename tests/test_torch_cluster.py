"""``chip_smoke.py``'s cluster phase, cut down to run on the CPU.

The world ``cluster_world`` builds (two NodePools, one limited; existing
nodes with bound pods and missing daemons; three daemonsets) solves on
``device="cpu"`` with the plans, existing plans and pod errors the JAX
package's ``TPUScheduler`` gives on the same world built from its own
classes; the phase's checks pass on that plan and refuse a broken one,
and the existing-node first-fit agrees with its plain PyTorch version on
the solve's own inputs. The card runs the same code at full size.
"""

from __future__ import annotations

import copy
import importlib.util
import os

import pytest

from karpenter_core_tpu_torch.solver import TorchScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


SIZE = (3000, 200, 60)  # pods, instance types, existing nodes


def _load(name: str, source: str):
    module = importlib.util.module_from_spec(importlib.util.spec_from_loader(name, loader=None))
    exec(compile(source, os.path.join(REPO, "chip_smoke.py"), "exec"), module.__dict__)
    return module


@pytest.fixture(scope="module")
def smoke():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        return _load("chip_smoke", f.read())


# world variants: (pods, types, nodes, RESERVED_LIMITS, default pool limits)
WORLDS = {
    "as-on-the-card": (*SIZE, None, None),
    # both pools limited: pods starve after the bounded rounds
    "both-pools-starved": (1500, 120, 40, {"cpu": "60", "memory": "80Gi"}, {"cpu": "400"}),
    # existing capacity takes the whole batch: no pool encode, no kernel
    "existing-takes-all": (300, 60, 90, None, None),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_cluster_world_plan_identity(smoke, monkeypatch, world):
    """The same world from the JAX package's classes (the script's own
    ``cluster_world`` with the package name swapped) solves to the same
    plans."""
    from karpenter_core_tpu.solver import TPUScheduler
    from test_torch_existing import errors_by_index
    from test_torch_native import reference_native

    reference_native(monkeypatch)
    n_pods, n_types, n_nodes, reserved_limits, default_limits = WORLDS[world]
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        ref_smoke = _load("chip_smoke_ref", f.read().replace("karpenter_core_tpu_torch", "karpenter_core_tpu"))
    results = []
    for module, package in ((ref_smoke, "karpenter_core_tpu"), (smoke, "karpenter_core_tpu_torch")):
        if reserved_limits is not None:
            monkeypatch.setattr(module, "RESERVED_LIMITS", reserved_limits)
        pools, provider, pods, nodes, daemons, _ = module.cluster_world(n_pods, n_types, n_nodes)
        if default_limits is not None:
            pq = importlib.import_module(f"{package}.kube.quantity").parse_quantity
            pools[1].spec.limits = {k: pq(v) for k, v in default_limits.items()}
        if package == "karpenter_core_tpu":
            solver = TPUScheduler(pools, provider)
        else:
            solver = TorchScheduler(pools, provider, device="cpu")
        results.append((solver.solve(pods, state_nodes=nodes, daemonset_pods=daemons), pods))
    (ref, ref_pods), (res, pods) = results
    assert ref.oracle_results is None
    assert smoke.plan_stream(res) == smoke.plan_stream(ref)
    assert smoke.existing_stream(res) == smoke.existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    assert (res.node_count, res.pods_scheduled, res.total_price) == (
        ref.node_count, ref.pods_scheduled, ref.total_price,
    )
    if world == "both-pools-starved":
        assert any("exceed limits" in e for e in res.pod_errors.values())
    elif world == "existing-takes-all":
        assert res.node_count == 0 and res.pods_scheduled == len(pods)


@pytest.fixture(scope="module")
def solved(smoke):
    pools, provider, pods, nodes, daemons, missing = smoke.cluster_world(*SIZE)
    res, inputs = smoke.capture_pack_existing(
        lambda: TorchScheduler(pools, provider, device="cpu").solve(
            pods, state_nodes=nodes, daemonset_pods=daemons
        )
    )
    return res, pods, nodes, daemons, missing, inputs


def test_world_shape(smoke, solved):
    res, pods, nodes, daemons, missing, _ = solved
    assert len(pods) == 3000 and len(nodes) == 60 and len(daemons) == 3
    assert sum(1 for sn in nodes if sn.nodepool_name() == "reserved") == 2
    assert sum(1 for sn in nodes if sn.taints()) == 15
    # cni is missing on every 10th node, nowhere else
    assert [name for name, req in missing.items() if req] == [f"node-{m:04d}" for m in range(0, 60, 10)]
    assert all(sn.pod_requests for sn in nodes)


def test_checks_hold_on_the_cpu_plan(smoke, solved):
    res, pods, nodes, daemons, missing, _ = solved
    summary = smoke.check_cluster(res, pods, nodes, daemons, missing)
    assert summary["pods_on_existing"] > 0
    assert summary["new_nodes_by_pool"]["default"] > 0
    assert summary["new_nodes_by_pool"].get("reserved", 0) > 0
    assert summary["reserved_cpu_used"] <= 1000 and summary["reserved_memory_gi_used"] <= 1000


@pytest.mark.parametrize("fault", ["pod placed twice", "pod dropped", "node overcommitted"])
def test_checks_refuse_a_broken_plan(smoke, solved, fault):
    res, pods, nodes, daemons, missing, _ = solved
    bad = copy.copy(res)
    bad.existing_plans = [copy.copy(e) for e in res.existing_plans]
    bad.node_plans = list(res.node_plans)
    first = bad.existing_plans[0]
    if fault == "pod placed twice":
        first.pod_indices = first.pod_indices + [res.node_plans[0].pod_indices[0]]
    elif fault == "pod dropped":
        first.pod_indices = first.pod_indices[1:]
    else:
        spare = [i for p in res.node_plans for i in p.pod_indices][:200]
        bad.node_plans = [
            copy.copy(p) for p in res.node_plans
        ]
        for p in bad.node_plans:
            p.pod_indices = [i for i in p.pod_indices if i not in set(spare)]
        first.pod_indices = first.pod_indices + spare
    with pytest.raises(SystemExit):
        smoke.check_cluster(bad, pods, nodes, daemons, missing)


def test_pack_existing_check_on_the_solve_inputs(smoke, solved):
    *_, inputs = solved
    row = smoke.pack_existing_check(inputs, "cpu")
    assert row["max_abs_err"] == 0 and row["assigned"] > 0 and row["M"] == 60


# -- phases 6 and 7: bench config 3 whole, and with the cluster's kube store -----


def _ref_smoke():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        return _load("chip_smoke_ref", f.read().replace("karpenter_core_tpu_torch", "karpenter_core_tpu"))


SPREAD_WORLDS = {
    # (pods, types, nodes, ha-web pods)
    "config3": (3000, 200, None, None),
    "config3-wider": (5000, 400, None, None),
    "cluster-spread": (3000, 200, 60, 50),
    # more replicas than admitting nodes: the rest open capped new nodes
    "cluster-spread-more-replicas": (1500, 120, 40, 120),
}


def _spread_world(module, world):
    n_pods, n_types, n_nodes, n_ha = SPREAD_WORLDS[world]
    if n_nodes is None:
        pools, provider, pods = module.config3_world(n_pods, n_types)
        return pools, provider, pods, {}, None
    pools, provider, pods, nodes, daemons, _, kube = module.cluster_spread_world(
        n_pods, n_types, n_nodes, n_ha
    )
    return pools, provider, pods, dict(state_nodes=nodes, daemonset_pods=daemons), kube


@pytest.mark.parametrize("world", sorted(SPREAD_WORLDS))
def test_spread_world_plan_identity(smoke, monkeypatch, world):
    """Phases 6 and 7's worlds, cut down, from the JAX package's classes
    (the script's own builders with the package name swapped) solve to
    the same plans, all on the reference's tensor path."""
    from karpenter_core_tpu.solver import TPUScheduler
    from test_torch_existing import errors_by_index
    from test_torch_native import reference_native

    reference_native(monkeypatch)
    results = []
    for module in (_ref_smoke(), smoke):
        pools, provider, pods, kw, kube = _spread_world(module, world)
        if module is smoke:
            solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
        else:
            solver = TPUScheduler(pools, provider, kube_client=kube)
        results.append((solver.solve(pods, **kw), pods, solver))
    (ref, ref_pods, ref_solver), (res, pods, _) = results
    assert ref.oracle_results is None
    assert ref_solver.last_route_stats["oracle"] == 0 and ref_solver.last_route_stats["parked"] == 0
    assert smoke.plan_stream(res) == smoke.plan_stream(ref)
    assert smoke.existing_stream(res) == smoke.existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    assert (res.node_count, res.pods_scheduled, res.total_price) == (
        ref.node_count, ref.pods_scheduled, ref.total_price,
    )
    assert any(p.spec.topology_spread_constraints for p in pods)


@pytest.fixture(scope="module")
def spread_solved(smoke):
    pools, provider, pods, kw, kube = _spread_world(smoke, "cluster-spread")
    res = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
    return res, pods, kw["state_nodes"], provider, kube


def test_spread_world_shape(smoke, spread_solved):
    res, pods, nodes, provider, kube = spread_solved
    assert len(pods) == 3050 and len(nodes) == 60
    bound = kube.list("Pod")
    assert sum(1 for p in bound if p.metadata.labels.get("app") == "ha-web") == 12
    zone1 = {sn.name() for sn in nodes if sn.labels()["topology.kubernetes.io/zone"] == "test-zone-1"}
    svc5 = [p for p in bound if p.metadata.labels.get("app") == "svc-5"]
    assert svc5 and all(p.spec.node_name in zone1 for p in svc5)
    assert sum(len(sn.pod_requests) for sn in nodes) == len(bound)


def test_spread_checks_hold_on_the_cpu_plan(smoke, spread_solved):
    res, pods, nodes, provider, kube = spread_solved
    groups = smoke.check_spread(res, pods, nodes, provider, kube)
    by_sel = {g["selector"]["app"]: g for g in groups}
    assert set(by_sel) == {"svc-5", "svc-6"}
    # svc-5's zone-1 seeds steer its pending pods to zones 2 and 3
    assert "test-zone-1" not in by_sel["svc-5"]["placed_by_zone"]
    assert by_sel["svc-5"]["final_by_zone"]["test-zone-1"] > 0
    ha = smoke.check_hostname(res, pods, kube)
    assert ha["pods"] == 50 and ha["on_existing"] + ha["on_new"] == 50 and ha["bound_seeds"] == 12
    smoke.check_cluster(res, pods, nodes, *_daemons_missing(smoke))
    pools, provider3, pods3, _, _ = _spread_world(smoke, "config3")
    res3 = TorchScheduler(pools, provider3, device="cpu").solve(pods3)
    smoke.check_invariants(res3, pods3)
    assert [g["worst_skew"] for g in smoke.check_spread(res3, pods3, [], provider3)] == [0, 0]


def _daemons_missing(smoke):
    _, _, _, _, daemons, missing, _ = smoke.cluster_spread_world(*SPREAD_WORLDS["cluster-spread"][:3], 50)
    return daemons, missing


@pytest.mark.parametrize(
    "fault", ["zone skew", "two replicas on a new node", "replica beside a bound one"]
)
def test_spread_checks_refuse_a_broken_plan(smoke, spread_solved, fault):
    res, pods, nodes, provider, kube = spread_solved
    bad = copy.copy(res)
    bad.node_plans = [copy.copy(p) for p in res.node_plans]
    bad.existing_plans = [copy.copy(e) for e in res.existing_plans]
    ha = [p for p in bad.node_plans if any(pods[i].metadata.labels.get("app") == "ha-web" for i in p.pod_indices)]
    if fault == "zone skew":
        # every new node holding svc-6 pods in zone 2 moves to zone 1
        for p in bad.node_plans:
            if p.zone == "test-zone-2" and any(pods[i].metadata.labels.get("app") == "svc-6" for i in p.pod_indices):
                p.zone = "test-zone-1"
        with pytest.raises(SystemExit):
            smoke.check_spread(bad, pods, nodes, provider, kube)
        return
    first, second = ha[0], ha[1]
    moved = next(i for i in second.pod_indices if pods[i].metadata.labels.get("app") == "ha-web")
    second.pod_indices = [i for i in second.pod_indices if i != moved]
    if fault == "two replicas on a new node":
        first.pod_indices = first.pod_indices + [moved]
    else:
        seeded = next(
            e for e in bad.existing_plans
            if any(p.spec.node_name == e.state_node.name() and p.metadata.labels.get("app") == "ha-web"
                   for p in kube.list("Pod"))
        )
        seeded.pod_indices = seeded.pod_indices + [moved]
    with pytest.raises(SystemExit):
        smoke.check_hostname(bad, pods, kube)
