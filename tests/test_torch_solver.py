"""Plan identity: TorchScheduler ≡ TPUScheduler on the slice's mix.

Each case builds the same world twice from one numpy seed — once from
the JAX package's own classes, once from the port's — solves it with
``TPUScheduler`` (its default route, and again with the Pallas compat
route forced in interpret mode) and with ``TorchScheduler(device="cpu")``,
and requires the identical ordered plan stream
``(nodepool, instance type, zone, capacity type, price, pod indices)``
plus equal ``pod_errors`` (by pod index), ``node_count``,
``pods_scheduled`` and ``total_price``. The reference runs its default
pack route, the native packer at K = 1024 (``reference_native``). The mix is bench config 3's
(``bench.py:469``) without its topology-spread share: 3/9 capacity-type
selectors, 2/9 ``dedicated`` tolerations, 4/9 plain pods (the spread
share is in ``tests/test_torch_topology.py``). The shapes the JAX
package sends to its greedy oracle or relaxes solve to its plans and
claims too.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu_torch.solver import TorchScheduler
from karpenter_core_tpu_torch.solver.solver import PHASES
from test_torch_native import reference_native
from test_torch_oracle import assert_same_results, same_start

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"


def world(
    pkg: str,
    seed: int,
    n_pods: int = 2000,
    n_types: int = 60,
    pools: str = "one",
    unschedulable: bool = False,
):
    """(nodepools, provider, pods) of the slice's mix, built from
    ``pkg``'s classes; equal seeds give equal worlds in both packages."""
    wk = importlib.import_module(f"{pkg}.apis.labels")
    NodePool = importlib.import_module(f"{pkg}.apis.nodepool").NodePool
    fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
    ob = importlib.import_module(f"{pkg}.kube.objects")
    pq = importlib.import_module(f"{pkg}.kube.quantity").parse_quantity

    rng = np.random.RandomState(seed)
    provider = fake.FakeCloudProvider()
    provider.instance_types = fake.instance_types(n_types)
    nodepools = []
    default = NodePool()
    default.metadata.name = "default"
    nodepools.append(default)
    if pools == "two":
        # a heavier spot-only pool that labels its nodes: pods selecting
        # on-demand fall through to the default pool
        spot = NodePool()
        spot.metadata.name = "spot-pool"
        spot.spec.weight = 10
        spot.spec.template.metadata.labels = {"team": "batch"}
        spot.spec.template.requirements = [
            ob.NodeSelectorRequirement(wk.CAPACITY_TYPE_LABEL_KEY, ob.OP_IN, ["spot"])
        ]
        nodepools.append(spot)

    pods = []
    for i in range(n_pods):
        r = i % 9
        pod = ob.Pod()
        pod.metadata.name = f"p-{seed}-{i}"
        pod.metadata.labels = {"app": f"svc-{r}"}
        cpu = ["100m", "250m", "500m", "1", "1500m", "2"][rng.randint(6)]
        mem = ["128Mi", "256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(5)]
        requests = {"cpu": pq(cpu), "memory": pq(mem)}
        pod.spec = ob.PodSpec(
            containers=[ob.Container(name="main", resources=ob.ResourceRequirements(requests=requests))]
        )
        if r < 3:
            pod.spec.node_selector = {wk.CAPACITY_TYPE_LABEL_KEY: ["spot", "on-demand"][i % 2]}
        elif r < 5:
            pod.spec.tolerations = [ob.Toleration(key="dedicated", operator="Exists")]
        if unschedulable and i % 97 == 0:
            # no type admits these: too big for every type, or a label no
            # pool can satisfy
            if i % 2:
                requests["cpu"] = pq("100000")
            else:
                pod.spec.node_selector = {"team": "nobody"}
        pods.append(pod)
    return nodepools, provider, pods


def plan_stream(res) -> list:
    return [
        (p.nodepool_name, p.instance_type.name, p.zone, p.capacity_type, p.price, list(p.pod_indices))
        for p in res.node_plans
    ]


def errors_by_index(res, pods) -> dict:
    index = {p.uid: i for i, p in enumerate(pods)}
    return {index[uid]: err for uid, err in res.pod_errors.items()}


def assert_same_plans(port_res, port_pods, ref_res, ref_pods):
    assert plan_stream(port_res) == plan_stream(ref_res)
    assert errors_by_index(port_res, port_pods) == errors_by_index(ref_res, ref_pods)
    assert port_res.node_count == ref_res.node_count
    assert port_res.pods_scheduled == ref_res.pods_scheduled
    assert port_res.total_price == ref_res.total_price


def _solve_both(monkeypatch, route: str, **kw):
    reference_native(monkeypatch)
    if route == "pallas":
        monkeypatch.setenv("KARPENTER_TPU_PALLAS_MIN_S", "1")
        monkeypatch.setenv("KARPENTER_TPU_PALLAS_INTERPRET", "1")
    ref_pools, ref_provider, ref_pods = world(REF, **kw)
    ref = TPUScheduler(ref_pools, ref_provider).solve(ref_pods)
    pools, provider, pods = world(PORT, **kw)
    solver = TorchScheduler(pools, provider, device="cpu")
    res = solver.solve(pods)
    return res, pods, ref, ref_pods, solver


CASES = {
    "seed0": dict(seed=0),
    "seed1": dict(seed=1),
    "seed2": dict(seed=2),
    "two-pools": dict(seed=3, pools="two"),
    "unschedulable": dict(seed=4, unschedulable=True),
    "above-merge-all": dict(seed=5, n_types=3),  # > 256 nodes: tails-only merge
    "below-merge-all": dict(seed=6, n_pods=300),  # ≤ 256 nodes: every node merges
}


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_identity(monkeypatch, case, route):
    res, pods, ref, ref_pods, solver = _solve_both(monkeypatch, route, **CASES[case])
    assert_same_plans(res, pods, ref, ref_pods)
    if case == "above-merge-all":
        assert ref.node_count > 256
    if case == "below-merge-all":
        assert 0 < ref.node_count <= 256
    if case == "unschedulable":
        assert ref.pod_errors
    if case == "two-pools":
        assert {p.nodepool_name for p in res.node_plans} == {"default", "spot-pool"}
    assert set(solver.last_timings) == {"total_ms", "device_ms", "host_ms"} | {
        f"{name}_ms" for name in PHASES
    }
    assert set(PHASES) == {
        "group", "existing", "encode", "prepare", "pack", "finalize", "merge", "limits", "affinity",
        "relax", "oracle",
    }
    assert solver.last_timings["existing_ms"] == 0.0  # no existing nodes in this world
    assert solver.last_timings["affinity_ms"] == 0.0  # and no pod-affinity post-pass
    assert solver.last_timings["oracle_ms"] == 0.0  # nor a pod for the greedy scheduler
    assert sum(v for k, v in solver.last_timings.items() if k not in ("total_ms", "host_ms")) <= (
        solver.last_timings["total_ms"]
    )
    assert solver.last_timings["device_ms"] == 0.0  # the CPU run has no device time


def test_warm_solve_repeats_plans():
    pools, provider, pods = world(PORT, seed=8)
    solver = TorchScheduler(pools, provider, device="cpu")
    first = plan_stream(solver.solve(pods))
    assert plan_stream(solver.solve(pods)) == first


def test_vector_merge_matches_scalar_merge():
    """The vector engine's clusters equal the scalar reference loop's on
    the records of a real solve."""
    pools, provider, pods = world(PORT, seed=9, n_pods=600)
    solver = TorchScheduler(pools, provider, device="cpu")
    captured = []
    real = solver._merge_and_emit

    def capture(records, pods_, result):
        captured.append([dict(r, members=list(r["members"])) for r in records])
        real(records, pods_, result)

    solver._merge_and_emit = capture
    solver.solve(pods)
    records = captured[0]
    assert records
    records.sort(key=lambda r: -int(r["usage"][0]))
    from karpenter_core_tpu_torch.solver.merge import merge_records_vector

    def clusters(merged):
        return [(list(m["members"]), m["usage"].tolist()) for m in merged]

    vec = merge_records_vector(solver, [dict(r, members=list(r["members"])) for r in records], pods, 64)
    scal = solver._merge_scalar([dict(r, members=list(r["members"])) for r in records], pods)
    assert clusters(vec) == clusters(scal)


def _out_of_slice(kind: str, pkg: str = PORT):
    """(nodepools, provider, pods, solve kwargs, kube client) of one
    shape, built from ``pkg``'s classes."""
    ob = importlib.import_module(f"{pkg}.kube.objects")
    wk = importlib.import_module(f"{pkg}.apis.labels")
    pools, provider, pods = world(pkg, seed=10, n_pods=20)
    pod = pods[0]
    sel = ob.LabelSelector(match_labels={"app": "svc-0"})
    kwargs = {}
    kube = None
    if kind == "topology spread":
        # zone spread is in the slice; together with a host port it is
        # not (the JAX package sends that group to its oracle)
        pod.spec.topology_spread_constraints = [
            ob.TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE,
                when_unsatisfiable="DoNotSchedule", label_selector=sel,
            )
        ]
        pod.spec.containers[0].ports = [ob.ContainerPort(host_port=8080)]
    elif kind == "pod affinity":
        # required zone affinity is on the port's path (the post-pass);
        # with a preferred term the JAX package sends the group to its
        # oracle
        term = ob.PodAffinityTerm(topology_key=wk.LABEL_TOPOLOGY_ZONE, label_selector=sel)
        pod.spec.affinity = ob.Affinity(
            pod_affinity=ob.PodAffinity(
                required=[term], preferred=[ob.WeightedPodAffinityTerm(1, term)]
            )
        )
    elif kind == "pod anti-affinity":
        # hostname self-anti-affinity is in the slice; this selector also
        # matches other groups of the batch (app=svc-0 without the term)
        pod.spec.affinity = ob.Affinity(
            pod_anti_affinity=ob.PodAntiAffinity(
                required=[ob.PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME, label_selector=sel)]
            )
        )
    elif kind in ("host ports", "host ports with state_nodes"):
        # two pods on one wildcard port conflict; a third on a specific
        # IP of another port shares a node with either
        for p in pods[:2]:
            p.spec.containers[0].ports = [ob.ContainerPort(host_port=8080)]
        pods[2].spec.containers[0].ports = [ob.ContainerPort(host_port=9090, host_ip="10.0.0.1")]
    elif kind == "volumes":
        # a claim bound to a PersistentVolume in test-zone-2 pins its pod
        kube = importlib.import_module(f"{pkg}.kube.client").KubeClient()
        pv = ob.PersistentVolume(zones=["test-zone-2"], driver="ebs.csi.aws.com")
        pv.metadata.name = "pv-0"
        kube.create(pv)
        claim = ob.PersistentVolumeClaim(volume_name="pv-0")
        claim.metadata.name = "claim-0"
        kube.create(claim)
        pod.spec.volumes = [ob.Volume(name="data", persistent_volume_claim="claim-0")]
        pods[1].spec.volumes = [ob.Volume(name="scratch", ephemeral=True)]
    if kind == "host ports with state_nodes":
        # the existing node's own pod reserves the wildcard port
        node = ob.Node()
        node.metadata.name = "node-0"
        node.metadata.labels = {wk.LABEL_HOSTNAME: "node-0"}
        pq = importlib.import_module(f"{pkg}.kube.quantity").parse_quantity
        node.status.capacity = {"cpu": pq("8"), "memory": pq("32Gi"), "pods": pq("110")}
        node.status.allocatable = dict(node.status.capacity)
        sn = importlib.import_module(f"{pkg}.state.statenode").StateNode(node=node)
        holder = ob.Pod()
        holder.metadata.name = "holder"
        holder.spec = ob.PodSpec(node_name="node-0", containers=[ob.Container(name="main")])
        holder.spec.containers[0].ports = [ob.ContainerPort(host_port=9090)]
        sn.update_for_pod(holder)
        kwargs["state_nodes"] = [sn]
    return pools, provider, pods, kwargs, kube


# shapes the port refused before it carried host ports and volumes, and
# (the first three) before it carried the greedy fallback: each is a
# plan-identity case under its old id
SOLVED = ("host ports", "volumes", "host ports with state_nodes")


@pytest.mark.parametrize(
    "kind",
    [
        "topology spread",
        "pod affinity",
        "pod anti-affinity",
        "host ports",
        "volumes",
        "host ports with state_nodes",
    ],
)
def test_out_of_slice_features_raise(monkeypatch, kind):
    """Every shape solves to the JAX package's plans and greedy claims:
    the reference sends the first three to its oracle and keeps the
    host-port and volume shapes (``SOLVED``) on its tensor path."""
    reference_native(monkeypatch)
    same_start(monkeypatch)
    pools, provider, ref_pods, kwargs, kube = _out_of_slice(kind, REF)
    ref_solver = TPUScheduler(pools, provider, kube_client=kube)
    ref = ref_solver.solve(ref_pods, **kwargs)
    if kind in SOLVED:
        assert ref.oracle_results is None and ref_solver.last_route_stats["oracle"] == 0
    else:
        assert ref.oracle_results is not None and ref_solver.last_route_stats["oracle"] > 0
    same_start(monkeypatch)
    pools, provider, pods, kwargs, kube = _out_of_slice(kind, PORT)
    solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
    res = solver.solve(pods, **kwargs)
    assert_same_plans(res, pods, ref, ref_pods)
    assert_same_results(res, pods, ref, ref_pods)
    assert solver.last_route_stats == {
        k: v for k, v in ref_solver.last_route_stats.items() if k != "engine"
    }
    where = {i: p for p in res.node_plans for i in p.pod_indices}
    if kind == "volumes":
        assert where[0].zone == "test-zone-2"
    elif kind == "host ports":
        assert where[0] is not where[1]
    elif kind not in SOLVED:
        assert solver.last_timings["oracle_ms"] > 0.0


def _relaxed_by_reference(monkeypatch) -> list:
    """Record every relaxation the JAX package's preference ladder applies."""
    from karpenter_core_tpu.scheduler.preferences import Preferences

    applied = []
    real = Preferences.relax

    def relax(self, pod):
        out = real(self, pod)
        applied.append(out)
        return out

    monkeypatch.setattr(Preferences, "relax", relax)
    return applied


def _solve_relaxable(monkeypatch, mutate, seed):
    """The slice's world with ``mutate`` applied to pod 0, solved by both
    packages → (port result, port pods, port solver, reference result,
    reference pods, relaxations the reference applied)."""
    reference_native(monkeypatch)
    applied = _relaxed_by_reference(monkeypatch)
    out = []
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        pools, provider, pods = world(pkg, seed=seed, n_pods=10)
        mutate(pkg, pods[0])
        solver = (TPUScheduler(pools, provider) if pkg == REF else TorchScheduler(pools, provider, device="cpu"))
        out.append((solver.solve(pods), pods, solver))
    (ref, ref_pods, _), (res, pods, solver) = out
    return res, pods, solver, ref, ref_pods, applied


def test_schedule_anyway_spread_failure_raises(monkeypatch):
    """A failing pod with a ScheduleAnyway spread is one the JAX
    package's preference ladder relaxes (the constraint is stripped and
    the pod retried): the port relaxes it too, and both keep the error
    its node selector leaves."""

    def mutate(pkg, pod):
        ob = importlib.import_module(f"{pkg}.kube.objects")
        wk = importlib.import_module(f"{pkg}.apis.labels")
        pod.spec.node_selector = {"team": "nobody"}
        pod.spec.topology_spread_constraints = [
            ob.TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable="ScheduleAnyway",
                label_selector=ob.LabelSelector(match_labels={"app": "svc-0"}),
            )
        ]

    res, pods, solver, ref, ref_pods, applied = _solve_relaxable(monkeypatch, mutate, seed=12)
    assert True in applied  # the reference relaxed
    assert solver.last_relax_stats["rounds"] >= 1
    assert_same_results(res, pods, ref, ref_pods)
    assert pods[0].uid in res.pod_errors
    assert pods[0].spec.topology_spread_constraints  # relaxed on a copy


def test_relaxable_failure_raises(monkeypatch):
    """A failing pod the JAX package relaxes (preferred node affinity):
    the port relaxes it too, to the same plans and errors."""

    def mutate(pkg, pod):
        ob = importlib.import_module(f"{pkg}.kube.objects")
        pod.spec.node_selector = {"team": "nobody"}
        pod.spec.affinity = ob.Affinity(
            node_affinity=ob.NodeAffinity(
                preferred=[
                    ob.PreferredSchedulingTerm(
                        weight=1,
                        preference=ob.NodeSelectorTerm(
                            match_expressions=[ob.NodeSelectorRequirement("size", ob.OP_IN, ["small"])]
                        ),
                    )
                ]
            )
        )

    res, pods, solver, ref, ref_pods, applied = _solve_relaxable(monkeypatch, mutate, seed=11)
    assert True in applied
    assert solver.last_relax_stats["rounds"] >= 1
    assert_same_results(res, pods, ref, ref_pods)
