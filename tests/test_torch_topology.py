"""Topology spread on the port's tensor path ≡ the JAX package's.

Three layers, each against the JAX package run unchanged on the CPU:

- the quota math of ``solver/topology_tensor.py`` (``water_fill``,
  ``spread_quotas``, ``interleave_by_quota``, ``_fill_unbounded``) on
  seeded random inputs, equal element for element;
- seed counts (``seed_counts_for_constraint``/``_for_selector`` and
  ``count_matching_pods_by_domain``) on equal ``KubeClient`` worlds with
  node filters, terminal, terminating and unbound pods, other
  namespaces and unlabeled nodes, equal dict for dict;
- plan identity: every spread scenario of ``tests/test_tensor_topology.py``
  and ``tests/test_cross_topology.py::TestCrossSelectorSpread`` (its
  twenty randomized draws included) that the JAX package keeps on its
  tensor path, plus ``min_domains``, ScheduleAnyway, hostname spread,
  hostname self-anti-affinity and both together, limit-spill rounds with
  spread, zone requirements and node filters on seeded worlds,
  daemonsets, a one-zone pool, two namespaces, eight random clusters,
  and a merge a hostname limit rejects. The world is built twice
  from one description, once from each package's classes; the JAX
  ``TPUScheduler`` (with ``kube_client``) must route every pod to its
  tensor path (``last_route_stats``: no oracle, nothing parked), and the
  plan stream, existing plans, errors by pod index, count, pods
  scheduled and price must be identical. Nothing here has a tolerance:
  plans compare exactly.

The three shapes the port refused before it carried pod affinity and
zone and non-self anti-affinity (one pod-affinity group, zone
self-anti-affinity, anti-affinity against bound pods) are plan-identity
cases here too; the reference parks the first, and so are host ports
and volumes. The shapes the JAX package sends to its greedy oracle are
plan-identity cases as well, its claims included.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from karpenter_core_tpu.scheduler import topology as ref_topo
from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu.solver import topology_tensor as ref_tt
from karpenter_core_tpu_torch.scheduler import topology as port_topo
from karpenter_core_tpu_torch.solver import TorchScheduler
from karpenter_core_tpu_torch.solver import topology_tensor as port_tt
from test_torch_existing import Kit, errors_by_index, existing_stream, plan_stream
from test_torch_native import reference_native
from test_torch_oracle import solve_pair

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"
ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]


# -- quota math ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_quota_math_matches_reference(seed):
    rng = np.random.RandomState(seed)
    for _ in range(150):
        Z = int(rng.randint(1, 8))
        counts = rng.randint(0, 12, size=Z).astype(np.int64)
        pods = int(rng.randint(0, 40))
        ceiling = None if rng.rand() < 0.4 else int(rng.randint(0, 16))
        q, u = port_tt.water_fill(counts, pods, ceiling)
        rq, ru = ref_tt.water_fill(counts, pods, ceiling)
        np.testing.assert_array_equal(q, rq)
        assert u == ru
        np.testing.assert_array_equal(
            port_tt._fill_unbounded(counts, pods), ref_tt._fill_unbounded(counts, pods)
        )
        ext_min = None if rng.rand() < 0.5 else int(rng.randint(0, 10))
        min_domains = None if rng.rand() < 0.5 else int(rng.randint(1, 6))
        skew = int(rng.randint(1, 4))
        n_supported = Z + int(rng.randint(0, 3))
        q, u = port_tt.spread_quotas(counts, ext_min, skew, min_domains, n_supported, pods)
        rq, ru = ref_tt.spread_quotas(counts, ext_min, skew, min_domains, n_supported, pods)
        np.testing.assert_array_equal(q, rq)
        assert u == ru
        # descending pod ranks, at least as many as the quotas place
        order = np.arange(int(q.sum()) + int(rng.randint(0, 5)))[::-1].copy()
        parts = port_tt.interleave_by_quota(order, q)
        ref_parts = ref_tt.interleave_by_quota(order, q)
        assert len(parts) == len(ref_parts) == Z
        for a, b in zip(parts, ref_parts):
            np.testing.assert_array_equal(a, b)


# -- seed counts -----------------------------------------------------------------


def _seed_world(pkg: str, seed: int):
    """A kube store of nodes (some without a zone, some without a
    hostname label) and bound, unbound, terminal and terminating pods in
    two namespaces → (kube, pods by name)."""
    k = Kit(pkg)
    client = importlib.import_module(f"{pkg}.kube.client").KubeClient()
    rng = np.random.RandomState(seed)
    nodes = []
    for n in range(12):
        labels = {"disk": ["ssd", "hdd"][n % 2]}
        if n % 5 != 4:
            labels[k.wk.LABEL_TOPOLOGY_ZONE] = ZONES[n % 3]
        node = k.state_node(f"node-{n}", labels=labels).node
        if n % 7 == 6:
            del node.metadata.labels[k.wk.LABEL_HOSTNAME]
        client.create(node)
        nodes.append(node.name)
    by_name = {}
    for i in range(80):
        app = ["web", "db", "cache"][rng.randint(3)]
        bound = rng.rand() < 0.85
        pod = k.pod(
            f"pod-{i}", {"cpu": "100m"}, labels={"app": app, "tier": ["a", "b"][rng.randint(2)]},
            node_name=nodes[rng.randint(len(nodes))] if bound else "",
        )
        if rng.rand() < 0.2:
            pod.metadata.namespace = "other"
        roll = rng.rand()
        if roll < 0.1:
            pod.status.phase = "Succeeded"
        elif roll < 0.15:
            pod.status.phase = "Failed"
        elif roll < 0.22:
            pod.metadata.deletion_timestamp = 1.0
        client.create(pod)
        by_name[pod.name] = pod
    return k, client, by_name


def _exemplar(k, variant: str):
    """The pod whose constraint is counted: its node selection is the
    spread's node filter."""
    pod = k.pod("exemplar", {"cpu": "100m"}, labels={"app": "web"})
    if variant == "node-selector":
        pod.spec.node_selector = {"disk": "ssd"}
    elif variant == "node-affinity":
        ob = k.ob
        pod.spec.affinity = ob.Affinity(
            node_affinity=ob.NodeAffinity(
                required=ob.NodeSelector(
                    node_selector_terms=[
                        ob.NodeSelectorTerm(
                            match_expressions=[ob.NodeSelectorRequirement("disk", ob.OP_IN, ["hdd"])]
                        ),
                        ob.NodeSelectorTerm(
                            match_expressions=[
                                ob.NodeSelectorRequirement(
                                    k.wk.LABEL_TOPOLOGY_ZONE, ob.OP_IN, [ZONES[0]]
                                )
                            ]
                        ),
                    ]
                )
            )
        )
    return pod


@pytest.mark.parametrize("variant", ["no-filter", "node-selector", "node-affinity"])
@pytest.mark.parametrize("seed", range(3))
def test_seed_counts_match_reference(seed, variant):
    worlds = {}
    for pkg in (REF, PORT):
        k, client, by_name = _seed_world(pkg, seed)
        excluded = {by_name[f"pod-{i}"].uid for i in range(0, 80, 9)}
        worlds[pkg] = (k, client, excluded, _exemplar(k, variant))
    results = {}
    for pkg, tt in ((REF, ref_tt), (PORT, port_tt)):
        k, client, excluded, ex = worlds[pkg]
        ob, wk = k.ob, k.wk
        out = []
        for key in (wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME):
            for labels in ({"app": "web"}, {"tier": "a"}, {}):
                c = ob.TopologySpreadConstraint(
                    max_skew=1, topology_key=key, label_selector=ob.LabelSelector(match_labels=labels)
                )
                out.append(tt.seed_counts_for_constraint(client, ex, c, excluded))
                out.append(
                    tt.seed_counts_for_selector(
                        client, ex, key, ob.LabelSelector(match_labels=labels), excluded
                    )
                )
            out.append(tt.seed_counts_for_constraint(None, ex, c, excluded))
        results[pkg] = out
    assert results[PORT] == results[REF]
    assert any(results[PORT])


@pytest.mark.parametrize("seed", range(2))
def test_count_matching_pods_by_domain_matches_reference(seed):
    """The port's TopologyGroup node filter and selection against the
    reference's, counted directly."""
    out = {}
    for pkg, topo in ((REF, ref_topo), (PORT, port_topo)):
        k, client, by_name = _seed_world(pkg, seed)
        ex = _exemplar(k, "node-selector")
        sel = k.ob.LabelSelector(match_labels={"app": "web"})
        tg = topo.TopologyGroup(
            topo.TOPOLOGY_TYPE_SPREAD, k.wk.LABEL_TOPOLOGY_ZONE, ex, {"default", "other"}, sel,
            1, None, set(),
        )
        nil = topo.TopologyGroup(
            topo.TOPOLOGY_TYPE_POD_ANTI_AFFINITY, k.wk.LABEL_HOSTNAME, None, {"default"}, None,
            0, None, set(),
        )
        out[pkg] = (
            topo.count_matching_pods_by_domain(client, tg, set()),
            topo.count_matching_pods_by_domain(client, nil, set()),
            (tg.type, tg.key, sorted(tg.namespaces), tg.max_skew, tg.node_filter.key()),
            [tg.selects(p) for _, p in sorted(by_name.items())],
            nil.selects(ex),
        )
    assert out[PORT] == out[REF]


# -- plan identity ---------------------------------------------------------------


class TKit(Kit):
    """Kit with topology constructors."""

    def __init__(self, pkg: str):
        super().__init__(pkg)
        self.KubeClient = importlib.import_module(f"{pkg}.kube.client").KubeClient

    def spread(self, key, max_skew=1, labels=None, when="DoNotSchedule", min_domains=None):
        return self.ob.TopologySpreadConstraint(
            max_skew=max_skew, topology_key=key, when_unsatisfiable=when,
            label_selector=self.ob.LabelSelector(match_labels=dict(labels or {})),
            min_domains=min_domains,
        )

    def term(self, key, labels):
        return self.ob.PodAffinityTerm(
            topology_key=key, label_selector=self.ob.LabelSelector(match_labels=dict(labels))
        )

    def tpod(self, name, requests=None, labels=None, spread=(), anti=(), node_name="", **kw):
        pod = self.pod(name, requests or {"cpu": "500m"}, labels=labels, node_name=node_name, **kw)
        pod.spec.topology_spread_constraints = list(spread)
        if anti:
            pod.spec.affinity = self.ob.Affinity(
                pod_anti_affinity=self.ob.PodAntiAffinity(required=list(anti))
            )
        return pod

    def zone_node(self, name, zone, cpu="4"):
        return self.state_node(name, cpu=cpu, labels={self.wk.LABEL_TOPOLOGY_ZONE: zone})


def solve_both(monkeypatch, build, parked: bool = False):
    """Solve ``build(kit)`` → dict(pools, provider, pods, state_nodes,
    daemons, kube) with both packages; the reference must stay on its
    tensor path, parking pods for its pod-affinity post-pass exactly when
    ``parked``, and the results must be identical → (port result, port
    pods, port solver)."""
    reference_native(monkeypatch)
    out = []
    for pkg in (REF, PORT):
        w = build(TKit(pkg))
        if pkg == REF:
            solver = TPUScheduler(w["pools"], w["provider"], kube_client=w.get("kube"))
        else:
            solver = TorchScheduler(w["pools"], w["provider"], device="cpu", kube_client=w.get("kube"))
        res = solver.solve(
            w["pods"], state_nodes=w.get("state_nodes") or [], daemonset_pods=w.get("daemons") or []
        )
        out.append((res, w["pods"], solver))
    (ref, ref_pods, ref_solver), (res, pods, solver) = out
    assert ref.oracle_results is None
    assert ref_solver.last_route_stats["oracle"] == 0
    assert (ref_solver.last_route_stats["parked"] > 0) == parked
    assert plan_stream(res) == plan_stream(ref)
    assert existing_stream(res) == existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    assert (res.node_count, res.pods_scheduled, res.total_price) == (
        ref.node_count, ref.pods_scheduled, ref.total_price,
    )
    assert [(p.max_pods_per_node, _limits(p)) for p in res.node_plans] == [
        (p.max_pods_per_node, _limits(p)) for p in ref.node_plans
    ]
    return res, pods, solver


def _limits(plan) -> list:
    return [(dict(s.match_labels), ns, cap) for s, ns, cap in plan.node_limits]


def zone_counts(res, pods, app="web") -> dict:
    counts = {}
    for plan in res.node_plans:
        for i in plan.pod_indices:
            if pods[i].metadata.labels.get("app") == app:
                counts[plan.zone] = counts.get(plan.zone, 0) + 1
    for plan in res.existing_plans:
        z = plan.state_node.labels().get("topology.kubernetes.io/zone")
        for i in plan.pod_indices:
            if pods[i].metadata.labels.get("app") == app:
                counts[z] = counts.get(z, 0) + 1
    return counts


def _web_spread(k, **kw):
    return [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, labels={"app": "web"}, **kw)]


def _kube_with(k, state_nodes):
    kube = k.KubeClient()
    for sn in state_nodes:
        kube.create(sn.node)
    return kube


def _bind(k, kube, node_name, labels, n, prefix):
    for j in range(n):
        kube.create(k.pod(f"{prefix}-{j}", {"cpu": "100m"}, labels=labels, node_name=node_name))


# scenarios of tests/test_tensor_topology.py


def _spread_with_state_nodes(k):
    sns = [k.zone_node(f"node-{z}", z, cpu="2") for z in ZONES]
    pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=_web_spread(k)) for i in range(12)]
    pods += [k.pod(f"p-{i}", {"cpu": "500m"}) for i in range(6)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns,
                kube=_kube_with(k, sns))


def _seeded_counts(k):
    sns = [k.zone_node(f"node-{z}", z, cpu="8") for z in ZONES]
    kube = _kube_with(k, sns)
    _bind(k, kube, sns[0].name(), {"app": "web"}, 4, "seed")
    pods = [k.tpod(f"s-{i}", {"cpu": "100m"}, labels={"app": "web"}, spread=_web_spread(k))
            for i in range(8)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


def _use_existing_in_zone(k):
    sns = [k.zone_node(f"node-{z}", z, cpu="8") for z in ZONES]
    pods = [k.tpod(f"s-{i}", {"cpu": "1"}, labels={"app": "web"}, spread=_web_spread(k))
            for i in range(6)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns,
                kube=_kube_with(k, sns))


def _min_domains(n):
    def build(k):
        pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=_web_spread(k, min_domains=n))
                for i in range(9)]
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=k.KubeClient())
    return build


def _schedule_anyway(k):
    pods = [
        k.tpod(f"s-{i}", labels={"app": "web"},
               spread=_web_spread(k, when="ScheduleAnyway", min_domains=5))
        for i in range(9)
    ]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=k.KubeClient())


def _hostname_env(k, existing_per_node=(1, 0)):
    sns = [k.zone_node(f"hn-{i}", ZONES[i % 3], cpu="8") for i in range(len(existing_per_node))]
    kube = _kube_with(k, sns)
    for sn, n in zip(sns, existing_per_node):
        _bind(k, kube, sn.name(), {"app": "web"}, n, f"{sn.name()}-web")
    return sns, kube


def _hostname_spread_quotas(k):
    sns, kube = _hostname_env(k)
    pods = [k.tpod(f"s-{i}", labels={"app": "web"},
                   spread=[k.spread(k.wk.LABEL_HOSTNAME, max_skew=2, labels={"app": "web"})])
            for i in range(4)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


def _hostname_isolated(k):
    sns, kube = _hostname_env(k)
    pods = [k.tpod(f"s-{i}", labels={"app": "web"},
                   anti=[k.term(k.wk.LABEL_HOSTNAME, {"app": "web"})])
            for i in range(3)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


def _zone_and_hostname(k):
    sns = [k.zone_node(f"z1-{i}", ZONES[0], cpu="8") for i in range(2)]
    spread = [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, max_skew=1, labels={"app": "web"}),
              k.spread(k.wk.LABEL_HOSTNAME, max_skew=3, labels={"app": "web"})]
    pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=spread) for i in range(6)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns,
                kube=_kube_with(k, sns))


def _existing_only_zone(k):
    sns = [k.zone_node("z9-0", "test-zone-9", cpu="8")]
    spread = [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, max_skew=1, labels={"app": "web"}),
              k.spread(k.wk.LABEL_HOSTNAME, max_skew=2, labels={"app": "web"})]
    pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=spread) for i in range(6)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns,
                kube=_kube_with(k, sns))


def _hostname_spread_plus_anti(k):
    sns = [k.zone_node("occupied", ZONES[0], cpu="8")]
    kube = _kube_with(k, sns)
    _bind(k, kube, "occupied", {"tier": "db"}, 1, "blocker")
    pods = [
        k.tpod(f"s-{i}", labels={"app": "web", "tier": "db"},
               spread=[k.spread(k.wk.LABEL_HOSTNAME, max_skew=3, labels={"app": "web"})],
               anti=[k.term(k.wk.LABEL_HOSTNAME, {"tier": "db"})])
        for i in range(2)
    ]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


# scenarios of tests/test_cross_topology.py::TestCrossSelectorSpread


def _pure_cross(k):
    pods = [k.tpod(f"s-{i}", labels={"app": "spreader"},
                   spread=[k.spread(k.wk.LABEL_TOPOLOGY_ZONE, labels={"app": "other"})])
            for i in range(6)]
    pods += [k.pod(f"g-{i}", {"cpu": "500m"}, labels={"app": "other"}) for i in range(6)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=k.KubeClient())


def _cross_seeded(k):
    kube = k.KubeClient()
    for zi, count in ((0, 3), (1, 0), (2, 0)):
        node = k.zone_node(f"seed-node-{zi}", ZONES[zi], cpu="16").node
        kube.create(node)
        _bind(k, kube, node.name, {"app": "counted"}, count, f"seed-{zi}")
    pods = [k.tpod(f"s-{i}", labels={"app": "spreader"},
                   spread=[k.spread(k.wk.LABEL_TOPOLOGY_ZONE, labels={"app": "counted"})])
            for i in range(4)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=kube)


def _mutual(k):
    spread = lambda: [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, labels={"tier": "web"})]  # noqa: E731
    pods = [k.tpod(f"a-{i}", labels={"tier": "web", "grp": "a"}, spread=spread())
            for i in range(6)]
    pods += [k.tpod(f"b-{i}", {"cpu": "250m"}, labels={"tier": "web", "grp": "b"}, spread=spread())
             for i in range(6)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=k.KubeClient())


def _random_cross(seed):
    def build(k):
        rng = np.random.RandomState(seed)
        vals = ["a", "b", "c"]
        pods = []
        for i in range(rng.randint(8, 20)):
            labels = {"my-label": vals[rng.randint(3)]}
            spread = ()
            if rng.rand() < 0.5:
                spread = [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, max_skew=int(rng.randint(1, 3)),
                                   labels={"my-label": vals[rng.randint(3)]})]
            pods.append(k.tpod(f"p-{i}", {"cpu": ["250m", "500m", "1"][rng.randint(3)]},
                               labels=labels, spread=spread))
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=k.KubeClient())
    return build


# beyond the reference's own tests


def _isolated_and_spread_new_nodes(k):
    """Hostname spread and self anti-affinity on one group, no existing
    nodes, with plain pods whose nodes the merge may share."""
    pods = [
        k.tpod(f"s-{i}", {"cpu": "250m"}, labels={"app": "web"},
               spread=[k.spread(k.wk.LABEL_HOSTNAME, max_skew=2, labels={"app": "web"})],
               anti=[k.term(k.wk.LABEL_HOSTNAME, {"app": "web"})])
        for i in range(5)
    ]
    pods += [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(12)]
    return dict(pools=[k.nodepool()], provider=k.provider(n_types=6), pods=pods, kube=k.KubeClient())


def _hostname_spread_and_zone_with_existing(k):
    """Zone spread plus hostname spread against seeded existing nodes in
    every zone, with seeds on one node."""
    sns = [k.zone_node(f"n-{i}", ZONES[i % 3], cpu="4") for i in range(6)]
    kube = _kube_with(k, sns)
    _bind(k, kube, "n-0", {"app": "web"}, 2, "seed")
    spread = [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, max_skew=1, labels={"app": "web"}),
              k.spread(k.wk.LABEL_HOSTNAME, max_skew=2, labels={"app": "web"})]
    pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=spread) for i in range(10)]
    pods += [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(8)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


def _limit_spill(k):
    """A limited heavier pool takes spread pods until its limit strips
    plans; the spilled pods re-enter the zone water-fill on the next
    round and must count the placements kept before."""
    pools = [k.nodepool("reserved", limits={"cpu": "12"}, weight=10), k.nodepool("default")]
    sns = [k.zone_node(f"n-{z}", z, cpu="2") for z in ZONES]
    kube = _kube_with(k, sns)
    _bind(k, kube, sns[1].name(), {"app": "web"}, 2, "seed")
    pods = [k.tpod(f"s-{i}", {"cpu": ["500m", "1"][i % 2]}, labels={"app": "web"},
                   spread=_web_spread(k)) for i in range(40)]
    pods += [k.tpod(f"h-{i}", {"cpu": "250m"}, labels={"app": "ha"},
                    spread=[k.spread(k.wk.LABEL_HOSTNAME, labels={"app": "ha"})]) for i in range(6)]
    pods += [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(20)]
    return dict(pools=pools, provider=k.provider(n_types=8), pods=pods, state_nodes=sns, kube=kube)


def _isolated_with_existing_and_plain(k):
    """One replica per node over existing nodes with bound replicas and
    plain pods competing for the same free capacity."""
    sns = [k.zone_node(f"n-{i}", ZONES[i % 3], cpu="2") for i in range(8)]
    kube = _kube_with(k, sns)
    for i in (0, 3, 5):
        _bind(k, kube, f"n-{i}", {"app": "ha"}, 1, f"ha-{i}")
    pods = [k.tpod(f"h-{i}", {"cpu": "250m"}, labels={"app": "ha"},
                   anti=[k.term(k.wk.LABEL_HOSTNAME, {"app": "ha"})]) for i in range(12)]
    pods += [k.pod(f"p-{i}", {"cpu": "500m"}) for i in range(10)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


def _zone_requirement(k):
    """Spread pods limited to two zones by node affinity: the third
    zone's seeds are outside the pods' supported domains."""
    ob, wk = k.ob, k.wk
    kube = k.KubeClient()
    for zi, count in ((0, 1), (1, 0), (2, 5)):
        node = k.zone_node(f"seed-node-{zi}", ZONES[zi], cpu="16").node
        kube.create(node)
        _bind(k, kube, node.name, {"app": "web"}, count, f"seed-{zi}")
    pods = []
    for i in range(9):
        pod = k.tpod(f"s-{i}", labels={"app": "web"}, spread=_web_spread(k))
        pod.spec.affinity = ob.Affinity(
            node_affinity=ob.NodeAffinity(
                required=ob.NodeSelector(
                    node_selector_terms=[
                        ob.NodeSelectorTerm(
                            match_expressions=[
                                ob.NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, ob.OP_IN, ZONES[:2])
                            ]
                        )
                    ]
                )
            )
        )
        pods.append(pod)
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=kube)


def _node_filter_seeds(k):
    """Spread pods selecting ``disk=ssd`` nodes (the pool labels its
    nodes so): seeds on ``hdd`` nodes fall outside the spread's node
    filter."""
    sns = [
        k.state_node(f"n-{i}", cpu="4", labels={k.wk.LABEL_TOPOLOGY_ZONE: ZONES[i % 3],
                                                "disk": ["ssd", "hdd"][i // 3]})
        for i in range(6)
    ]
    kube = _kube_with(k, sns)
    _bind(k, kube, "n-0", {"app": "web"}, 2, "ssd-seed")
    _bind(k, kube, "n-4", {"app": "web"}, 3, "hdd-seed")
    pods = [k.tpod(f"s-{i}", {"cpu": "1"}, labels={"app": "web"}, spread=_web_spread(k),
                   node_selector={"disk": "ssd"}) for i in range(10)]
    pool = k.nodepool()
    pool.spec.template.metadata.labels = {"disk": "ssd"}
    return dict(pools=[pool], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)


def _cross_hostname(k):
    """A hostname spread whose selector counts other pods, not its own:
    the group packs alone on new nodes."""
    pods = [k.tpod(f"s-{i}", {"cpu": "250m"}, labels={"app": "spreader"},
                   spread=[k.spread(k.wk.LABEL_HOSTNAME, labels={"app": "other"})])
            for i in range(5)]
    pods += [k.pod(f"o-{i}", {"cpu": "250m"}, labels={"app": "other"}) for i in range(5)]
    sns = [k.zone_node("n-0", ZONES[0], cpu="8")]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns,
                kube=_kube_with(k, sns))


def _spread_with_daemonsets(k):
    """Zone spread and one-per-node replicas on nodes and new nodes that
    carry daemonset overhead."""
    sns = [k.zone_node(f"n-{i}", ZONES[i % 3], cpu="4") for i in range(6)]
    for sn in sns[:3]:
        sn.update_for_pod(k.pod(f"{sn.name()}-ds", {"cpu": "200m"}, node_name=sn.name(), daemonset=True))
    daemons = [k.pod("ds", {"cpu": "200m", "memory": "128Mi"}, daemonset=True)]
    pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=_web_spread(k)) for i in range(14)]
    pods += [k.tpod(f"h-{i}", {"cpu": "250m"}, labels={"app": "ha"},
                    anti=[k.term(k.wk.LABEL_HOSTNAME, {"app": "ha"})]) for i in range(8)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns,
                daemons=daemons, kube=_kube_with(k, sns))


def _zone_restricted_pool(k):
    """A heavier pool offering one zone only: the spread group takes it,
    its other supported zones pin the global min, and the rest fail."""
    ob, wk = k.ob, k.wk
    zonal = k.nodepool("zonal", weight=10)
    zonal.spec.template.requirements = [
        ob.NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, ob.OP_IN, [ZONES[0]])
    ]
    pods = [k.tpod(f"s-{i}", labels={"app": "web"}, spread=_web_spread(k)) for i in range(6)]
    pods += [k.pod(f"p-{i}", {"cpu": "500m"}) for i in range(4)]
    return dict(pools=[zonal, k.nodepool()], provider=k.provider(), pods=pods, kube=k.KubeClient())


def _two_namespaces(k):
    """One selector in two namespaces: each group counts its own
    namespace's pods, seeds included."""
    kube = k.KubeClient()
    node = k.zone_node("seed-node", ZONES[0], cpu="16").node
    kube.create(node)
    for j in range(3):
        p = k.pod(f"seed-{j}", {"cpu": "100m"}, labels={"app": "web"}, node_name=node.name)
        p.metadata.namespace = "team-b"
        kube.create(p)
    pods = []
    for ns in ("default", "team-b"):
        for i in range(6):
            p = k.tpod(f"{ns}-{i}", labels={"app": "web"}, spread=_web_spread(k))
            p.metadata.namespace = ns
            pods.append(p)
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=kube)


def _random_cluster(seed):
    """Random mixes over a random cluster with a kube store: plain pods,
    zone spreads (self and cross selectors, skew 1–2, some min_domains),
    hostname spreads and one-per-node groups under labels no other group
    carries."""
    def build(k):
        rng = np.random.RandomState(100 + seed)
        wk = k.wk
        sns = [k.zone_node(f"n-{m}", ZONES[int(rng.randint(3))], cpu=["2", "4", "8"][rng.randint(3)])
               for m in range(int(rng.randint(0, 8)))]
        kube = _kube_with(k, sns)
        apps = ["a", "b", "c"]
        for sn in sns:
            for j in range(int(rng.randint(0, 3))):
                kube.create(k.pod(f"{sn.name()}-b{j}", {"cpu": "250m"},
                                  labels={"app": apps[rng.randint(3)]}, node_name=sn.name()))
        pods = []
        for g in range(int(rng.randint(3, 8))):
            kind = rng.randint(4)
            label = {"app": apps[rng.randint(3)]}
            spread, anti = (), ()
            if kind == 1:
                spread = [k.spread(wk.LABEL_TOPOLOGY_ZONE, max_skew=int(rng.randint(1, 3)),
                                   labels={"app": apps[rng.randint(3)]},
                                   min_domains=[None, 2, 4][rng.randint(3)])]
            elif kind == 2:
                spread = [k.spread(wk.LABEL_HOSTNAME, max_skew=int(rng.randint(1, 3)), labels=label)]
            elif kind == 3:
                label = {"app": f"iso-{g}"}
                anti = [k.term(wk.LABEL_HOSTNAME, label)]
            cpu = ["250m", "500m", "1"][rng.randint(3)]
            pods += [k.tpod(f"g{g}-{i}", {"cpu": cpu}, labels=label, spread=spread, anti=anti)
                     for i in range(int(rng.randint(1, 9)))]
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=sns, kube=kube)
    return build


def _once_refused(kind: str):
    """A shape the port refused before it carried it: the pods of
    ``_refused(kind)``, with a bound ``app=bound`` pod on an existing
    node for the anti-affinity against other pods."""
    def build(k):
        sns = [k.zone_node(f"n-{z}", z, cpu="4") for z in ZONES]
        kube = _kube_with(k, sns)
        _bind(k, kube, sns[1].name(), {"app": "bound"}, 1, "bound")
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=_refused(kind, k),
                    state_nodes=sns, kube=kube)
    return build


# the reference parks these for its post-pack pod-affinity pass
PARKED = {"pod-affinity"}

SCENARIOS = {
    "pod-affinity": _once_refused("pod affinity"),
    "pod-anti-affinity-on-zone": _once_refused("pod anti-affinity on zone"),
    "pod-anti-affinity-against-other-pods": _once_refused("pod anti-affinity against other pods"),
    "zone-requirement-limits-domains": _zone_requirement,
    "node-filter-seeds": _node_filter_seeds,
    "cross-hostname-spread-solo": _cross_hostname,
    "spread-with-daemonsets": _spread_with_daemonsets,
    "zone-restricted-pool": _zone_restricted_pool,
    "two-namespaces": _two_namespaces,
    **{f"random-cluster-{s}": _random_cluster(s) for s in range(8)},
    "spread-with-state-nodes": _spread_with_state_nodes,
    "seeded-counts-balance": _seeded_counts,
    "spread-uses-existing-in-zone": _use_existing_in_zone,
    "min-domains-unsatisfiable": _min_domains(5),
    "min-domains-satisfied": _min_domains(3),
    "schedule-anyway": _schedule_anyway,
    "hostname-spread-node-quotas": _hostname_spread_quotas,
    "hostname-isolated-skips-occupied": _hostname_isolated,
    "zone-and-hostname-spread": _zone_and_hostname,
    "capped-group-existing-only-zone": _existing_only_zone,
    "hostname-spread-plus-anti": _hostname_spread_plus_anti,
    "cross-spread-pure": _pure_cross,
    "cross-spread-seeded-skew": _cross_seeded,
    "cross-spread-mutual": _mutual,
    "isolated-and-spread-new-nodes": _isolated_and_spread_new_nodes,
    "zone-and-hostname-with-seeded-existing": _hostname_spread_and_zone_with_existing,
    "limit-spill-rounds": _limit_spill,
    "isolated-with-existing-and-plain": _isolated_with_existing_and_plain,
    **{f"cross-spread-random-{s}": _random_cross(s) for s in range(20)},
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_topology_plan_identity(monkeypatch, case):
    res, pods, solver = solve_both(monkeypatch, SCENARIOS[case], parked=case in PARKED)
    assert res.pods_scheduled + len(res.pod_errors) == len(pods)
    counts = zone_counts(res, pods)
    if case == "seeded-counts-balance":
        # seeds (4, 0, 0): the 8 pods water-fill zones 2 and 3
        assert counts == {ZONES[1]: 4, ZONES[2]: 4}
    elif case == "spread-uses-existing-in-zone":
        assert res.node_count == 0 and sorted(counts.values()) == [2, 2, 2]
    elif case == "min-domains-unsatisfiable":
        assert res.pods_scheduled == 3 and all("max-skew" in e for e in res.pod_errors.values())
    elif case in ("min-domains-satisfied", "schedule-anyway"):
        assert res.pods_scheduled == 9 and not res.pod_errors
    elif case == "hostname-isolated-skips-occupied":
        assert all(e.state_node.name() != "hn-0" for e in res.existing_plans)
        assert all(len(p.pod_indices) == 1 for p in res.node_plans)
    elif case == "limit-spill-rounds":
        assert {p.nodepool_name for p in res.node_plans} == {"reserved", "default"}
    elif case == "pod-anti-affinity-against-other-pods":
        # the node holding the bound app=bound pod takes no anti pod
        assert all(
            e.state_node.name() != f"n-{ZONES[1]}" or all(pods[i].name != "a" for i in e.pod_indices)
            for e in res.existing_plans
        )
    elif case == "isolated-and-spread-new-nodes":
        assert all(p.max_pods_per_node == 1 for p in res.node_plans if any(
            pods[i].metadata.labels.get("app") == "web" for i in p.pod_indices))


def test_merge_rejected_by_hostname_limit(monkeypatch):
    """Two merge records each holding one replica of a one-per-node
    group: the port's exact merge check refuses the pair for the
    hostname limit alone (the same pair without limits merges), and the
    reference's check agrees."""
    res, pods, solver = solve_both(monkeypatch, _isolated_and_spread_new_nodes)
    captured = []
    real = solver._merge_and_emit

    def capture(records, pods_, result):
        captured.append([dict(r, members=list(r["members"])) for r in records])
        real(records, pods_, result)

    solver._merge_and_emit = capture
    solver.solve(pods)
    records = [r for r in captured[0] if r["limits"]]
    assert len(records) >= 2
    a, b = records[0], records[1]
    assert not solver._merge_pair_exact(dict(a, members=list(a["members"])), b, pods)
    assert solver._merge_pair_exact(
        dict(a, members=list(a["members"]), limits=[], _limit_counts={}), dict(b, limits=[]), pods
    )
    # every planned node keeps at most one replica
    for p in res.node_plans:
        assert sum(pods[i].metadata.labels.get("app") == "web" for i in p.pod_indices) <= 1
    # the vector merge engine's clusters equal the scalar reference's on
    # records that carry limits
    from karpenter_core_tpu_torch.solver.merge import merge_records_vector

    recs = sorted(captured[0], key=lambda r: -int(r["usage"][0]))

    def clusters(merged):
        return [(list(m["members"]), m["usage"].tolist()) for m in merged]

    vec = merge_records_vector(solver, [dict(r, members=list(r["members"])) for r in recs], pods, 64)
    scal = solver._merge_scalar([dict(r, members=list(r["members"])) for r in recs], pods)
    assert clusters(vec) == clusters(scal)


# -- shapes outside the slice ----------------------------------------------------


def _refused(kind: str, k):
    wk = k.wk
    pods = [k.pod(f"p-{i}", {"cpu": "500m"}, labels={"app": "plain"}) for i in range(4)]
    web = {"app": "web"}

    def with_affinity(pod, terms, anti=()):
        pod.spec.affinity = k.ob.Affinity(
            pod_affinity=k.ob.PodAffinity(required=list(terms)),
            pod_anti_affinity=k.ob.PodAntiAffinity(required=list(anti)) if anti else None,
        )
        return pod

    if kind == "pod affinity":
        a = k.tpod("a", labels=web)
        a.spec.affinity = k.ob.Affinity(
            pod_affinity=k.ob.PodAffinity(required=[k.term(wk.LABEL_TOPOLOGY_ZONE, web)])
        )
        pods.append(a)
    elif kind == "pod anti-affinity on zone":
        pods.append(k.tpod("a", labels=web, anti=[k.term(wk.LABEL_TOPOLOGY_ZONE, web)]))
    elif kind == "pod anti-affinity against other pods":
        pods.append(k.tpod("a", labels=web, anti=[k.term(wk.LABEL_HOSTNAME, {"app": "bound"})]))
    elif kind == "pod anti-affinity whose selector matches another group":
        pods.append(k.tpod("a", labels=web, anti=[k.term(wk.LABEL_HOSTNAME, {"app": "plain"})]))
    elif kind == "pod anti-affinity with preferred terms":
        a = k.tpod("a", labels=web)
        a.spec.affinity = k.ob.Affinity(
            pod_anti_affinity=k.ob.PodAntiAffinity(
                preferred=[k.ob.WeightedPodAffinityTerm(1, k.term(wk.LABEL_HOSTNAME, web))]
            )
        )
        pods.append(a)
    elif kind == "topology spread together with host ports":
        a = k.tpod("a", labels=web, spread=_web_spread(k))
        a.spec.containers[0].ports = [k.ob.ContainerPort(host_port=80)]
        pods.append(a)
    elif kind == "spread counted by an unported group":
        # a spread group the JAX package would keep, pulled off its
        # tensor path because a preferred-affinity pod selects it
        pods.append(k.tpod("s", labels=web, spread=_web_spread(k)))
        a = k.tpod("a", labels={"app": "x"})
        a.spec.affinity = k.ob.Affinity(
            pod_affinity=k.ob.PodAffinity(
                preferred=[k.ob.WeightedPodAffinityTerm(1, k.term(wk.LABEL_TOPOLOGY_ZONE, web))]
            )
        )
        pods.append(a)
    elif kind == "pod affinity mixed with anti-affinity":
        pods.append(with_affinity(
            k.tpod("a", labels=web), [k.term(wk.LABEL_TOPOLOGY_ZONE, web)],
            anti=[k.term(wk.LABEL_HOSTNAME, web)],
        ))
    elif kind == "two hostname affinity terms":
        pods.append(with_affinity(
            k.tpod("a", labels={"app": "web", "tier": "front"}),
            [k.term(wk.LABEL_HOSTNAME, web), k.term(wk.LABEL_HOSTNAME, {"tier": "front"})],
        ))
    elif kind == "host ports":
        for name in ("a", "b"):  # one wildcard port: never on one node
            a = k.tpod(name, labels=web)
            a.spec.containers[0].ports = [k.ob.ContainerPort(host_port=8080)]
            pods.append(a)
    elif kind == "volumes":
        a = k.tpod("a", labels=web)
        a.spec.volumes = [k.ob.Volume(name="data", ephemeral=True)]
        pods.append(a)
    return pods


# shapes the port refused before it carried the greedy fallback, with the
# feature each refusal named; the reference sends each to its oracle
REFUSED = {
    "pod anti-affinity whose selector matches another group": "matches another group",
    "pod anti-affinity with preferred terms": "pod anti-affinity with preferred terms",
    "topology spread together with host ports": "host ports",
    "spread counted by an unported group": "pod affinity with preferred terms",
    "pod affinity mixed with anti-affinity": "mixed with anti-affinity",
    "two hostname affinity terms": "several hostname terms",
    "host ports": "host ports",
    "volumes": "volumes",
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_shapes_raise(monkeypatch, kind):
    """Every shape solves to the JAX package's plans: host ports and
    volumes stay on both tensor paths; the other six go to the
    reference's greedy oracle, and the port's plans, errors and greedy
    claims equal it."""
    if kind in ("host ports", "volumes"):
        res, pods, _ = solve_both(
            monkeypatch,
            lambda k: dict(pools=[k.nodepool()], provider=k.provider(), pods=_refused(kind, k), kube=k.KubeClient()),
        )
        if kind == "host ports":
            where = {pods[i].name: id(p) for p in res.node_plans for i in p.pod_indices}
            assert where["a"] != where["b"]
        return
    res, w, solver, ref_solver = solve_pair(
        monkeypatch,
        lambda k: dict(pools=[k.nodepool()], provider=k.provider(), pods=_refused(kind, k), kube=k.KubeClient()),
        TKit,
    )
    assert ref_solver.last_route_stats["oracle"] > 0
    assert res.oracle_results is not None
    assert res.pods_scheduled + len(res.pod_errors) == len(w["pods"])
