"""Pod affinity and zone and non-self anti-affinity on the port's tensor
path ≡ the JAX package's.

Every case builds one world twice, once from each package's classes
(``TKit``), and solves it with ``TPUScheduler`` and with
``TorchScheduler(device="cpu")``; the reference must keep every pod off
its oracle (``last_route_stats``), parking pods for its post-pack
pod-affinity pass exactly where the case says, and the plan stream,
existing plans, errors by pod index (text included), count, pods
scheduled, price, per-node caps and node limits must be identical.
Nothing here has a tolerance.

Scenarios:

- from ``tests/test_cross_topology.py::TestCrossSelectorAffinity``: the
  zone affinity chain in dependency order, the dead affinity cycle, the
  hostname join to a planned anchor, parked groups under NodePool limits
  and the randomized cross-affinity mix;
- from ``tests/test_constraint_tensors.py``: zone exclusion of a seeded
  zone, the hostname exclusion mask on an existing node, the randomized
  anti-exclusion draws, multi-term parking, intersection wins, disjoint
  anchors fail, the bootstrap pinning one zone, hostname plus zone term;
- zone self-anti-affinity with and without existing nodes and seeds,
  full hostname anchors that reseed, joins and reseeds under a limit;
- ``chip_smoke.py``'s phases 8 (bench config 6) and 9 (config 13
  ``anti_dense`` against a live cluster) cut down, their checks on the
  port's plan, and the reference's route split without oracle pods.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_core_tpu_torch.solver import TorchScheduler
from test_torch_cluster import REPO, _load
from test_torch_existing import errors_by_index
from test_torch_native import reference_native
from test_torch_topology import ZONES, TKit, _bind, _kube_with, solve_both


def _aff(k, name, labels, terms, cpu="500m", **kw):
    """A pending pod with required pod-affinity ``terms``."""
    pod = k.tpod(name, {"cpu": cpu}, labels=labels, **kw)
    pod.spec.affinity = k.ob.Affinity(pod_affinity=k.ob.PodAffinity(required=list(terms)))
    return pod


def _seed(k, kube, name, labels, zone, node_name=None):
    """A running labeled pod bound to a node of ``zone`` in the kube
    store: seed material for anchors and exclusions."""
    node_name = node_name or f"seed-node-{name}"
    if kube.get("Node", node_name) is None:
        kube.create(k.zone_node(node_name, zone, cpu="16").node)
    kube.create(k.pod(name, {"cpu": "100m"}, labels=labels, node_name=node_name))


def _world(k, pods, kube=None, state_nodes=(), pools=None, n_types=10):
    return dict(pools=pools or [k.nodepool()], provider=k.provider(n_types=n_types), pods=pods,
                state_nodes=list(state_nodes), kube=kube if kube is not None else k.KubeClient())


# tests/test_cross_topology.py::TestCrossSelectorAffinity


def _zone_chain(k):
    zone = k.wk.LABEL_TOPOLOGY_ZONE
    pods = [_aff(k, f"a-{i}", {"t": "a"}, [k.term(zone, {"t": "a"})]) for i in range(3)]
    pods += [_aff(k, f"b-{i}", {"t": "b"}, [k.term(zone, {"t": "a"})]) for i in range(3)]
    pods += [_aff(k, f"c-{i}", {"t": "c"}, [k.term(zone, {"t": "b"})]) for i in range(3)]
    return _world(k, pods)


def _dead_cycle(k):
    zone = k.wk.LABEL_TOPOLOGY_ZONE
    pods = [_aff(k, "a-0", {"t": "a"}, [k.term(zone, {"t": "b"})]),
            _aff(k, "b-0", {"t": "b"}, [k.term(zone, {"t": "a"})])]
    return _world(k, pods)


def _hostname_join(k):
    pods = [k.pod(f"w-{i}", {"cpu": "500m"}, labels={"t": "w"}) for i in range(3)]
    pods += [_aff(k, f"j-{i}", {"t": "j"}, [k.term(k.wk.LABEL_HOSTNAME, {"t": "w"})]) for i in range(3)]
    return _world(k, pods)


def _parked_limits(k):
    pods = [_aff(k, f"a-{i}", {"t": "a"}, [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"t": "a"})], cpu="3")
            for i in range(4)]
    return _world(k, pods, pools=[k.nodepool(limits={"cpu": "4"})])


def _random_cross_affinity(seed):
    def build(k):
        rng = np.random.RandomState(1000 + seed)
        vals = ["a", "b", "c"]
        pods = []
        for i in range(rng.randint(6, 16)):
            v = vals[rng.randint(3)]
            if rng.rand() < 0.5:
                pods.append(k.pod(f"g-{i}", {"cpu": "250m"}, labels={"t": v}))
            else:
                key = k.wk.LABEL_TOPOLOGY_ZONE if rng.rand() < 0.5 else k.wk.LABEL_HOSTNAME
                pods.append(_aff(k, f"a-{i}", {"t": v}, [k.term(key, {"t": vals[rng.randint(3)]})]))
        return _world(k, pods)
    return build


# tests/test_constraint_tensors.py


def _anti(k, name, labels, terms, cpu="1"):
    return k.tpod(name, {"cpu": cpu}, labels=labels, anti=terms)


def _zone_exclusion(k):
    kube = k.KubeClient()
    _seed(k, kube, "redis-0", {"app": "redis"}, ZONES[0])
    pods = [_anti(k, f"w-{i}", {"app": "web"}, [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"app": "redis"})])
            for i in range(4)]
    return _world(k, pods, kube)


def _hostname_exclusion(k):
    kube = k.KubeClient()
    blocked, free = k.state_node("blocked-node", cpu="8"), k.state_node("free-node", cpu="8")
    _seed(k, kube, "noisy-0", {"app": "noisy"}, ZONES[0], node_name="blocked-node")
    pods = [_anti(k, "w-0", {"app": "web"}, [k.term(k.wk.LABEL_HOSTNAME, {"app": "noisy"})])]
    return _world(k, pods, kube, [blocked, free])


def _random_anti_exclusion(seed):
    def build(k):
        rng = np.random.RandomState(seed)
        kube = k.KubeClient()
        for z in ZONES:
            if rng.rand() < 0.6:
                _seed(k, kube, f"blk-{seed}-{z}", {"app": "blocker"}, z)
        cpus = ["250m", "500m", "1", "2"]
        pods = []
        for i in range(rng.randint(8, 20)):
            anti = rng.rand() < 0.5
            cpu = cpus[rng.randint(len(cpus))]
            terms = [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"app": "blocker"})] if anti else []
            pods.append(_anti(k, f"p-{i}", {"app": "web"}, terms, cpu=cpu))
        return _world(k, pods, kube)
    return build


def _two_zone_terms(k, name, labels, a="a", b="b"):
    zone = k.wk.LABEL_TOPOLOGY_ZONE
    return _aff(k, name, labels, [k.term(zone, {"app": a}), k.term(zone, {"app": b})], cpu="1")


def _multi_term_parks(k):
    kube = k.KubeClient()
    _seed(k, kube, "anchor-a", {"app": "a"}, ZONES[1])
    _seed(k, kube, "anchor-b", {"app": "b"}, ZONES[1])
    return _world(k, [_two_zone_terms(k, f"m-{i}", {}) for i in range(2)], kube)


def _intersection_wins(k):
    kube = k.KubeClient()
    _seed(k, kube, "a-z1", {"app": "a"}, ZONES[0])
    _seed(k, kube, "a-z2", {"app": "a"}, ZONES[1])
    _seed(k, kube, "b-z2", {"app": "b"}, ZONES[1])
    return _world(k, [_two_zone_terms(k, f"m-{i}", {}) for i in range(3)], kube)


def _disjoint_anchors(k):
    kube = k.KubeClient()
    _seed(k, kube, "a-z1", {"app": "a"}, ZONES[0])
    _seed(k, kube, "b-z2", {"app": "b"}, ZONES[1])
    return _world(k, [_two_zone_terms(k, "m-0", {"app": "neither"})], kube)


def _bootstrap_one_zone(k):
    kube = k.KubeClient()
    _seed(k, kube, "a-z1", {"app": "a"}, ZONES[0])
    _seed(k, kube, "a-z2", {"app": "a"}, ZONES[1])
    zone = k.wk.LABEL_TOPOLOGY_ZONE
    pods = [_aff(k, f"s-{i}", {"team": "self"}, [k.term(zone, {"app": "a"}), k.term(zone, {"team": "self"})],
                 cpu="1") for i in range(4)]
    return _world(k, pods, kube)


def _hostname_plus_zone(k):
    kube = k.KubeClient()
    sn = k.zone_node("anchor-node", ZONES[1], cpu="8")
    kube.create(sn.node)
    _seed(k, kube, "a-host", {"app": "a"}, ZONES[1], node_name="anchor-node")
    _seed(k, kube, "z-term", {"app": "z"}, ZONES[1])
    terms = [k.term(k.wk.LABEL_HOSTNAME, {"app": "a"}), k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"app": "z"})]
    return _world(k, [_aff(k, "h-0", {}, terms, cpu="1")], kube, [sn])


# zone self-anti-affinity, hostname anchors, limits


def _quorum(n, existing: bool, seeded: bool = False):
    """``n`` one-per-zone pods; with ``existing``, a node per zone and
    plain pods competing for them; with ``seeded``, a bound member in
    the first zone."""
    def build(k):
        sns = [k.zone_node(f"n-{z}", z, cpu="4") for z in ZONES] if existing else []
        kube = _kube_with(k, sns)
        if seeded:
            _bind(k, kube, sns[0].name() if sns else _seed_node(k, kube), {"app": "quorum"}, 1, "member")
        pods = [_anti(k, f"q-{i}", {"app": "quorum"}, [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"app": "quorum"})])
                for i in range(n)]
        pods += [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(6)]
        return _world(k, pods, kube, sns)
    return build


def _seed_node(k, kube):
    kube.create(k.zone_node("seed-node", ZONES[0], cpu="16").node)
    return "seed-node"


def _quorum_and_hostname(k):
    """Zone and hostname self-anti-affinity together, and a non-self
    hostname term beside them (cap 0 on merges and joins)."""
    sns = [k.zone_node(f"n-{i}", ZONES[i % 3], cpu="4") for i in range(4)]
    kube = _kube_with(k, sns)
    _bind(k, kube, "n-1", {"app": "cache"}, 1, "cache")
    terms = [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"app": "db"}), k.term(k.wk.LABEL_HOSTNAME, {"app": "db"})]
    pods = [_anti(k, f"db-{i}", {"app": "db"}, terms) for i in range(4)]
    pods += [_anti(k, f"w-{i}", {"app": "web"}, [k.term(k.wk.LABEL_HOSTNAME, {"app": "cache"})], cpu="500m")
             for i in range(6)]
    pods += [k.pod(f"p-{i}", {"cpu": "500m"}) for i in range(6)]
    return _world(k, pods, kube, sns)


def _avoid_cache_host(k):
    """A zone quorum and one-per-node replicas that must also avoid the
    node running a bound ``app=cache`` pod (a non-self hostname term):
    the quorum member of that node's zone and the replicas filling
    existing nodes skip it, and the replicas' new nodes carry the
    term's cap-0 node limit."""
    sns = [k.zone_node(f"n-{i}", ZONES[i % 3], cpu="4") for i in range(4)]
    kube = _kube_with(k, sns)
    _bind(k, kube, "n-1", {"app": "cache"}, 1, "cache")
    host, zone = k.wk.LABEL_HOSTNAME, k.wk.LABEL_TOPOLOGY_ZONE
    pods = [_anti(k, f"q-{i}", {"app": "quorum"}, [k.term(zone, {"app": "quorum"}), k.term(host, {"app": "cache"})])
            for i in range(3)]
    pods += [_anti(k, f"r-{i}", {"app": "web"}, [k.term(host, {"app": "web"}), k.term(host, {"app": "cache"})],
                   cpu="250m") for i in range(10)]
    pods += [k.pod(f"p-{i}", {"cpu": "500m"}) for i in range(4)]
    return _world(k, pods, kube, sns)


def _full_anchors(limits=None):
    """Hostname joiners whose planned anchor node is full: the anchor
    plan grows to its largest type, then gives up matching pods to seed
    fresh anchors (under a limit, only while it has headroom)."""
    def build(k):
        pods = [k.pod(f"w-{i}", {"cpu": "1"}, labels={"t": "w"}) for i in range(6)]
        pods += [_aff(k, f"j-{i}", {"t": "j"}, [k.term(k.wk.LABEL_HOSTNAME, {"t": "w"})], cpu="1")
                 for i in range(14)]
        pools = [k.nodepool(limits=limits)] if limits else None
        return _world(k, pods, pools=pools, n_types=6)
    return build


def _join_limited(cpu_limit):
    """Joins and reseeds under a limit, then a zone-affinity group that
    needs the headroom they leave: each charge must happen once."""
    def build(k):
        pods = [k.pod(f"w-{i}", {"cpu": "1"}, labels={"t": "w"}) for i in range(6)]
        pods += [_aff(k, f"j-{i}", {"t": "j"}, [k.term(k.wk.LABEL_HOSTNAME, {"t": "w"})], cpu="1")
                 for i in range(14)]
        pods += [_aff(k, f"z-{i}", {"t": "z"}, [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"t": "w"})], cpu="2")
                 for i in range(6)]
        limits = {"cpu": str(cpu_limit), "memory": "1000Gi", "pods": "1000"}
        return _world(k, pods, pools=[k.nodepool(limits=limits)], n_types=6)
    return build


def _self_hostname_bootstrap(k):
    """A self-selecting hostname group with no anchor: one co-located
    node, the pods beyond it fail."""
    pods = [_aff(k, f"s-{i}", {"t": "s"}, [k.term(k.wk.LABEL_HOSTNAME, {"t": "s"})], cpu="2")
            for i in range(8)]
    return _world(k, pods, n_types=6)


def _affinity_on_existing(k):
    """Anchors bound on existing nodes: zone and hostname joiners fill
    those nodes, then new nodes in the anchor zone."""
    sns = [k.zone_node(f"n-{i}", ZONES[i % 3], cpu="4") for i in range(6)]
    kube = _kube_with(k, sns)
    _bind(k, kube, "n-1", {"app": "cache"}, 1, "cache")
    pods = [_aff(k, f"h-{i}", {"app": "side"}, [k.term(k.wk.LABEL_HOSTNAME, {"app": "cache"})])
            for i in range(10)]
    pods += [_aff(k, f"z-{i}", {"app": "near"}, [k.term(k.wk.LABEL_TOPOLOGY_ZONE, {"app": "cache"})], cpu="1")
             for i in range(10)]
    pods += [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(8)]
    return _world(k, pods, kube, sns)


def _two_pools_exclusion(k):
    """A heavier pool offering only the excluded zone is skipped; the
    group takes the next pool's other zones."""
    ob, wk = k.ob, k.wk
    zonal = k.nodepool("zonal", weight=10)
    zonal.spec.template.requirements = [ob.NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, ob.OP_IN, [ZONES[0]])]
    kube = k.KubeClient()
    _seed(k, kube, "redis-0", {"app": "redis"}, ZONES[0])
    pods = [_anti(k, f"w-{i}", {"app": "web"}, [k.term(wk.LABEL_TOPOLOGY_ZONE, {"app": "redis"})])
            for i in range(4)]
    pods += [k.pod(f"p-{i}", {"cpu": "1"}) for i in range(4)]
    return _world(k, pods, kube, pools=[zonal, k.nodepool()])


CASES = {
    # name: (build, the reference parks pods)
    "zone-affinity-chain": (_zone_chain, True),
    "dead-affinity-cycle": (_dead_cycle, True),
    "hostname-join-planned-anchor": (_hostname_join, True),
    "parked-under-nodepool-limits": (_parked_limits, True),
    **{f"random-cross-affinity-{s}": (_random_cross_affinity(s), True) for s in range(10)},
    "zone-exclusion-seeded-zone": (_zone_exclusion, False),
    "hostname-exclusion-existing-node": (_hostname_exclusion, False),
    **{f"random-anti-exclusion-{s}": (_random_anti_exclusion(s), False) for s in range(3)},
    "multi-term-parks": (_multi_term_parks, True),
    "multi-term-intersection-wins": (_intersection_wins, True),
    "multi-term-disjoint-anchors-fail": (_disjoint_anchors, True),
    "multi-term-bootstrap-one-zone": (_bootstrap_one_zone, True),
    "hostname-plus-zone-term": (_hostname_plus_zone, True),
    "zone-quorum-new-nodes": (_quorum(5, existing=False), False),
    "zone-quorum-seeded-new-nodes": (_quorum(4, existing=False, seeded=True), False),
    "zone-quorum-existing-nodes": (_quorum(5, existing=True), False),
    "zone-quorum-existing-seeded": (_quorum(4, existing=True, seeded=True), False),
    "zone-and-hostname-anti": (_quorum_and_hostname, False),
    "hostname-anchors-reseed": (_full_anchors(), True),
    "hostname-anchors-reseed-limited": (_full_anchors(limits={"cpu": "40"}), True),
    "joins-and-reseeds-limited-24": (_join_limited(24), True),
    "joins-and-reseeds-limited-34": (_join_limited(34), True),
    "quorum-and-replicas-avoid-cache-host": (_avoid_cache_host, False),
    "self-hostname-bootstrap": (_self_hostname_bootstrap, True),
    "affinity-on-existing-anchors": (_affinity_on_existing, True),
    "exclusion-skips-pool": (_two_pools_exclusion, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_affinity_plan_identity(monkeypatch, case):
    build, parked = CASES[case]
    res, pods, solver = solve_both(monkeypatch, build, parked=parked)
    assert res.pods_scheduled + len(res.pod_errors) == len(pods)
    if case == "zone-affinity-chain":
        assert res.pods_scheduled == 9 and not res.pod_errors
        zones = {}
        for p in res.node_plans:
            for i in p.pod_indices:
                zones.setdefault(pods[i].metadata.labels["t"], set()).add(p.zone)
        assert zones["b"] <= zones["a"] and zones["c"] <= zones["b"]
    elif case == "dead-affinity-cycle":
        assert res.pods_scheduled == 0 and len(res.pod_errors) == 2
    elif case == "hostname-join-planned-anchor":
        assert res.pods_scheduled == 6
        assert all({pods[i].metadata.labels["t"] for i in p.pod_indices} != {"j"} for p in res.node_plans)
    elif case == "parked-under-nodepool-limits":
        assert sum(p.instance_type.capacity["cpu"] for p in res.node_plans) <= 4_000_000_000
        assert any("limits" in e for e in res.pod_errors.values())
    elif case == "zone-exclusion-seeded-zone":
        assert not res.pod_errors and all(p.zone != ZONES[0] for p in res.node_plans)
    elif case == "hostname-exclusion-existing-node":
        assert res.pods_scheduled == 1
        assert all(e.state_node.name() != "blocked-node" for e in res.existing_plans)
    elif case == "multi-term-intersection-wins":
        assert not res.pod_errors and all(p.zone == ZONES[1] for p in res.node_plans)
    elif case == "multi-term-disjoint-anchors-fail":
        assert len(res.pod_errors) == 1
    elif case == "multi-term-bootstrap-one-zone":
        assert not res.pod_errors and len({p.zone for p in res.node_plans}) == 1
    elif case == "hostname-plus-zone-term":
        assert not res.pod_errors and res.existing_plans[0].state_node.name() == "anchor-node"
    elif case.startswith("zone-quorum"):
        where = {i: p.zone for p in res.node_plans for i in p.pod_indices}
        where.update({i: e.state_node.labels()["topology.kubernetes.io/zone"]
                      for e in res.existing_plans for i in e.pod_indices})
        quorum = [where[i] for i, p in enumerate(pods) if p.name.startswith("q-") and i in where]
        seeded = "seeded" in case
        assert len(quorum) == len(set(quorum)) == 3 - seeded
        assert (ZONES[0] in quorum) != seeded
    elif case.startswith("hostname-anchors-reseed"):
        # every joiner shares its node with an anchor
        for p in res.node_plans:
            labels = [pods[i].metadata.labels["t"] for i in p.pod_indices]
            assert "w" in labels or not labels
    elif case == "quorum-and-replicas-avoid-cache-host":
        assert all(e.state_node.name() != "n-1" or all(pods[i].name.startswith("p-") for i in e.pod_indices)
                   for e in res.existing_plans)
        assert any(cap == 0 for p in res.node_plans for _, _, cap in p.node_limits)
    elif case == "self-hostname-bootstrap":
        # the first node is the group's anchor; the retry round joins it
        # and then reseeds fresh anchors from it
        assert res.pods_scheduled == 8 and res.node_count > 1
    elif case == "exclusion-skips-pool":
        web = [p for p in res.node_plans if any(pods[i].name.startswith("w-") for i in p.pod_indices)]
        assert web and all(p.nodepool_name == "default" and p.zone != ZONES[0] for p in web)


def test_reseed_moves_an_anchor(monkeypatch):
    """The full-anchor world goes through the reseed: a fresh node holds
    one pod moved off the anchor plan and joiners beside it, and its
    limits are charged once."""
    calls = []
    real = TorchScheduler._reseed_anchor_nodes

    def spy(self, left, *args, **kw):
        out = real(self, left, *args, **kw)
        calls.append((len(left), len(out)))
        return out

    monkeypatch.setattr(TorchScheduler, "_reseed_anchor_nodes", spy)
    res, pods, _ = solve_both(monkeypatch, _full_anchors(), parked=True)
    assert calls and any(after < before for before, after in calls)
    assert any(p._limits_accounted for p in res.node_plans)
    # under a limit without headroom for another node, nothing moves
    calls.clear()
    res, pods, _ = solve_both(monkeypatch, _full_anchors(limits={"cpu": "40"}), parked=True)
    assert calls and all(after == before for before, after in calls)
    assert not any(p._limits_accounted for p in res.node_plans)


def test_postpass_timed_as_its_own_phase(monkeypatch):
    """``affinity_ms`` holds the post-pass; the phases partition the
    solve."""
    res, pods, solver = solve_both(monkeypatch, _zone_chain, parked=True)
    t = solver.last_timings
    phases = [t[f"{name}_ms"] for name in ("group", "existing", "encode", "prepare", "pack",
                                           "finalize", "merge", "limits", "affinity")]
    assert t["affinity_ms"] > 0.0 and t["pack_ms"] > 0.0
    assert sum(phases) <= t["total_ms"] + 1e-6


def test_plan_match_cache_forgets_stripped_plans(monkeypatch):
    """Limit enforcement that strips plans resets the plan match cache
    (keyed on plan ids, which stripped plans free for reuse)."""
    res, pods, solver = solve_both(monkeypatch, _parked_limits, parked=True)
    solver._plan_match_cache = {("stale",): (1, True)}
    solver._fold_cache = {"x": {}}
    plan = res.node_plans[0]
    remaining = {plan.nodepool_name: {"cpu": 0}}
    solver._enforce_limits(res, 0, remaining, {i: 0 for p in res.node_plans for i in p.pod_indices})
    assert solver._plan_match_cache == {} and solver._fold_cache == {}


# chip_smoke.py phases 8 and 9, cut down


@pytest.fixture(scope="module")
def smokes():
    with open(f"{REPO}/chip_smoke.py", encoding="utf-8") as f:
        source = f.read()
    return (
        _load("chip_smoke_ref", source.replace("karpenter_core_tpu_torch", "karpenter_core_tpu")),
        _load("chip_smoke", source),
    )


def _both(smokes, monkeypatch, world, *args):
    """The world from both packages' classes, solved by each → (port
    result, port pods, port world, reference scheduler)."""
    from karpenter_core_tpu.solver import TPUScheduler

    reference_native(monkeypatch)
    out = []
    for module, ref in zip(smokes, (True, False)):
        w = getattr(module, world)(*args)
        pools, provider, pods = w[:3]
        kw = dict(state_nodes=w[3], daemonset_pods=w[4]) if len(w) > 3 else {}
        kube = w[6] if len(w) > 3 else None
        if ref:
            solver = TPUScheduler(pools, provider, kube_client=kube)
        else:
            solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
        out.append((solver.solve(pods, **kw), pods, w, solver))
    (ref, ref_pods, _, ref_solver), (res, pods, w, _) = out
    assert ref.oracle_results is None and ref_solver.last_route_stats["oracle"] == 0
    port_smoke = smokes[1]
    assert port_smoke.plan_stream(res) == port_smoke.plan_stream(ref)
    assert port_smoke.existing_stream(res) == port_smoke.existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    return res, pods, w, ref_solver


def test_config6_phase_cut_down(smokes, monkeypatch):
    """Phase 8's world (bench config 6) at 700 pods × 40 types: the
    reference parks the two affinity sevenths and sends nothing to its
    oracle; the port's plan passes the phase's checks."""
    res, pods, (pools, provider, _), ref_solver = _both(smokes, monkeypatch, "config6_world", 700, 40)
    stats = ref_solver.last_route_stats
    assert (stats["tensor"], stats["parked"], stats["oracle"]) == (500, 200, 0)
    smoke = smokes[1]
    smoke.check_invariants(res, pods)
    aff = smoke.check_affinity(res, pods)
    assert aff["affinity_placed"] + aff["affinity_errors"] == 200
    assert smoke.check_spread_serial(res, pods, provider)


@pytest.mark.parametrize("world,args", [
    ("anti_dense_world", (1000, 200)),
    ("anti_cluster_world", (1000, 200, 30)),
])
def test_anti_phase_cut_down(smokes, monkeypatch, world, args):
    """Phase 9's worlds (config 13 anti_dense and a six-pod zone quorum,
    as the bench builds it and against the cluster with the anchors on
    existing nodes) at 1,000 pods × 200 types (× 30 nodes): all on the
    reference's tensor path, plans equal, the phase's checks pass, three
    quorum members place, one per zone, and three fail with the
    reference's message."""
    res, pods, w, ref_solver = _both(smokes, monkeypatch, world, *args)
    assert ref_solver.last_route_stats["parked"] == 0
    pools, provider, _, nodes, daemons, missing, kube = w
    smoke = smokes[1]
    anti = smoke.check_anti(res, pods, kube)
    assert sorted(anti["quorum_by_zone"].values()) == [1, 1, 1]
    assert anti["quorum_errors"] == ["pod anti-affinity on zone: no zone without a matching pod"]
    assert anti["terms_checked"]["hostname"] > 0
    if nodes:
        smoke.check_cluster(res, pods, nodes, daemons, missing, spill=False)
        assert anti["anti_on_existing"] > 0
    else:
        smoke.check_invariants(res, pods)
        # the quorum members take unmerged one-pod nodes
        quorum = [p for p in res.node_plans if any(pods[i].name.startswith("quorum-") for i in p.pod_indices)]
        assert len(quorum) == 3 and all(len(p.pod_indices) == 1 for p in quorum)


def test_phase_checks_refuse_broken_plans(smokes, monkeypatch):
    """The affinity and anti-affinity checks fail a plan that breaks
    them: an anti pod moved into its excluded zone, an affinity pod
    moved away from every anchor."""
    res, pods, w, _ = _both(smokes, monkeypatch, "anti_cluster_world", 600, 200, 30)
    smoke = smokes[1]
    kube = w[6]
    i = next(i for p in res.node_plans for i in p.pod_indices
             if pods[i].metadata.labels.get("team", "").startswith("t-"))
    plan = next(p for p in res.node_plans if i in p.pod_indices)
    ext = pods[i].spec.affinity.pod_anti_affinity.required[0].label_selector.match_labels["app"]
    s = int(ext.split("-")[1])
    plan.zone = f"test-zone-{s % 3 + 1}"
    with pytest.raises(SystemExit):
        smoke.check_anti(res, pods, kube)
    res, pods, _, _ = _both(smokes, monkeypatch, "config6_world", 700, 40)
    hosted = [(p, i) for p in res.node_plans for i in p.pod_indices
              if pods[i].spec.affinity is not None and pods[i].spec.affinity.pod_affinity
              and pods[i].spec.affinity.pod_affinity.required[0].topology_key.endswith("hostname")
              and not pods[i].spec.affinity.pod_affinity.required[0].label_selector.matches(pods[i].metadata.labels)]
    plan, i = hosted[0]
    plan.pod_indices.remove(i)
    res.node_plans.append(type(plan)(plan.nodepool_name, plan.instance_type, plan.zone, plan.capacity_type,
                                     plan.price, [i]))
    with pytest.raises(SystemExit):
        smoke.check_affinity(res, pods)


def test_reseed_keeps_donors_anchored(smokes, monkeypatch):
    """Where the JAX package's reseed moves a pod away from every pod its
    own hostname affinity selects (config 6's mix drawn from
    RandomState(125) at 700 pods × 40 types: ``bench-588``, labeled
    ``e`` with a hostname term on ``d``, lands beside ``f`` pods alone),
    the port's post-pass sees the stranded pod at its fixpoint and runs
    again moving no such donor: its plan passes the affinity check the
    reference's fails."""
    from karpenter_core_tpu.solver import TPUScheduler

    reference_native(monkeypatch)
    ref_smoke, smoke = smokes
    pools, provider, pods = ref_smoke.config6_world(700, 40, seed=125)
    ref = TPUScheduler(pools, provider).solve(pods)
    with pytest.raises(SystemExit):
        ref_smoke.check_affinity(ref, pods)
    pools, provider, pods = smoke.config6_world(700, 40, seed=125)
    solver = TorchScheduler(pools, provider, device="cpu")
    res = solver.solve(pods)
    assert solver.last_reseed_redo
    smoke.check_affinity(res, pods)
    smoke.check_invariants(res, pods)
    assert res.pods_scheduled == ref.pods_scheduled
    assert smoke.plan_stream(res) != smoke.plan_stream(ref)


# config 6's mix at 700 pods × 40 types: the seeds where the port's
# donor guard once made its plan differ from a reference plan that keeps
# every hostname affinity, the seed where the reference's breaks one
# (125), and eight where the two always agreed
RESEED_SEEDS = (3, 52, 75, 77, 81, 82, 95, 104, 106, 133, 144, 125, 0, 1, 4, 7, 8, 9, 10, 11)


@pytest.mark.parametrize("seed", RESEED_SEEDS)
def test_reseed_equals_reference_where_its_plan_holds(smokes, monkeypatch, seed):
    """The port's plan keeps every pod affinity; it equals the JAX
    package's (plans, existing plans, errors) wherever the reference's
    plan keeps them too, without a second post-pass, and where the
    reference's breaks one, the port ran the post-pass again under the
    donor guard."""
    from karpenter_core_tpu.solver import TPUScheduler

    reference_native(monkeypatch)
    ref_smoke, smoke = smokes
    pools, provider, ref_pods = ref_smoke.config6_world(700, 40, seed=seed)
    ref = TPUScheduler(pools, provider).solve(ref_pods)
    pools, provider, pods = smoke.config6_world(700, 40, seed=seed)
    solver = TorchScheduler(pools, provider, device="cpu")
    res = solver.solve(pods)
    smoke.check_affinity(res, pods)
    try:
        ref_smoke.check_affinity(ref, ref_pods)
    except SystemExit:
        assert solver.last_reseed_redo
        assert res.pods_scheduled == ref.pods_scheduled
        return
    assert not solver.last_reseed_redo
    assert smoke.plan_stream(res) == smoke.plan_stream(ref)
    assert smoke.existing_stream(res) == smoke.existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)


def _predicate_pods(k):
    """One pod per affinity shape the predicates tell apart."""
    host, zone = k.wk.LABEL_HOSTNAME, k.wk.LABEL_TOPOLOGY_ZONE
    web, db = {"app": "web"}, {"app": "db"}
    pods = [
        _aff(k, "self-zone", web, [k.term(zone, web)]),
        _aff(k, "self-host", web, [k.term(host, web)]),
        _aff(k, "cross-zone", web, [k.term(zone, db)]),
        _aff(k, "multi", web, [k.term(zone, db), k.term(zone, web)]),
        _aff(k, "host-zone", web, [k.term(host, db), k.term(zone, web)]),
        _aff(k, "two-host", web, [k.term(host, db), k.term(host, web)]),
        _aff(k, "other-key", web, [k.term("rack", web)]),
        _anti(k, "anti-self-zone", web, [k.term(zone, web)]),
        _anti(k, "anti-cross", web, [k.term(zone, db), k.term(host, db)]),
        _anti(k, "anti-mixed", web, [k.term(zone, web), k.term(host, db)]),
        k.pod("plain", {"cpu": "1"}, labels=web),
    ]
    mixed = _aff(k, "aff-and-anti", web, [k.term(zone, web)])
    mixed.spec.affinity.pod_anti_affinity = k.ob.PodAntiAffinity(required=[k.term(host, web)])
    spread = _aff(k, "aff-and-spread", web, [k.term(zone, web)])
    spread.spec.topology_spread_constraints = [k.spread(zone, labels=web)]
    return pods + [mixed, spread]


def test_signature_group_predicates_match_reference():
    """The affinity predicates of ``SignatureGroup`` (the port's
    ``affinity_term``, ``affinity_self_selecting`` and
    ``self_pod_affinity`` among them) give the reference's answers on
    every shape."""
    import importlib

    out = {}
    for pkg in ("karpenter_core_tpu", "karpenter_core_tpu_torch"):
        encode = importlib.import_module(f"{pkg}.solver.encode")
        rows = []
        for g in encode.group_pods(_predicate_pods(TKit(pkg))):
            terms = g.tensor_affinity_terms()
            row = [
                g.exemplar.name, terms is None, g.tensor_pod_affinity(), g.zone_anti_isolated,
                g.hostname_isolated, g.has_relational, len(g.anti_exclusion_terms()),
                g.tensor_anti_terms() is None,
            ]
            if terms is not None:
                row += [g.affinity_term().topology_key, g.affinity_self_selecting(), g.self_pod_affinity()]
            rows.append(row)
        out[pkg] = rows
    assert out["karpenter_core_tpu_torch"] == out["karpenter_core_tpu"]
    assert any(r[-1] is not None for r in out["karpenter_core_tpu"] if len(r) > 8)
