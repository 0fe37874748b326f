"""Host ports and CSI volumes on the port's tensor path ≡ the JAX package's.

Four layers, each against the JAX package run unchanged on the CPU:

- ``solver/constraint_tensors.py`` on seeded random inputs:
  ``canonical_ports``, ``ports_conflict``, ``PortFeatures`` (features,
  caps, loads, free rows), ``port_conflict_matrix`` over wildcard and
  specific IPs, ``volume_admit_matrix``, ``eph_free_columns`` with
  overlays, and ``resolve_group_volumes``/``get_volumes`` on kube
  worlds with a missing claim, a default StorageClass, a claim's own
  class and a bound PersistentVolume's driver; ``VolumeTopology.inject``
  on PV and StorageClass zones;
- plan identity with ``TPUScheduler``: the host-port and volume
  scenarios of ``tests/test_constraint_tensors.py`` (``TestHostPortParity``,
  ``TestVolumeParity``) and ``tests/test_solver_existing.py``, with the
  CSI limits set on the state nodes; bench config 13 ``stateful_dense``
  at 1,200 pods with its nodes as ``bench.py`` builds them and in the
  solver's units, ``spread_skew``, and ``chip_smoke.py``'s stateful
  cluster cut down; the reference must keep every pod on its tensor
  path;
- zone pins: injected once, skipped on a warm re-solve with the same
  plan;
- the C++ existing-node first-fit against ``pack_existing_reference``
  and the JAX scan on inputs carrying port and ephemeral-driver
  columns; ``chip_smoke.py``'s ``check_ports``, ``check_volumes`` and
  ``check_zone_pins`` pass on the port's plan and fail on broken ones.

Nothing here has a tolerance: plans and arrays compare exactly.
"""

from __future__ import annotations

import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu.solver import constraint_tensors as ref_ct
from karpenter_core_tpu.solver import pack as ref_pack
from karpenter_core_tpu_torch.solver import TorchScheduler
from karpenter_core_tpu_torch.solver import constraint_tensors as port_ct
from karpenter_core_tpu_torch.solver import pack as port_pack
from test_torch_cluster import REPO, _load
from test_torch_existing import errors_by_index, existing_stream, plan_stream
from test_torch_native import reference_native
from test_torch_oracle import solve_pair
from test_torch_topology import TKit, solve_both

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"
DRIVER = "ebs.csi.aws.com"


# -- constraint_tensors ----------------------------------------------------------


def _random_triples(rng, n):
    sets = []
    for _ in range(n):
        t = set()
        for _ in range(rng.randint(0, 4)):
            t.add((
                ["TCP", "UDP"][rng.randint(2)],
                [80, 443, 8080][rng.randint(3)],
                ["0.0.0.0", "::", "10.0.0.1", "10.0.0.2"][rng.randint(4)],
            ))
        sets.append(tuple(sorted(t)))
    return sets


@pytest.mark.parametrize("seed", range(4))
def test_port_features_match_reference(seed):
    rng = np.random.RandomState(seed)
    sets = _random_triples(rng, 12)
    reserved = _random_triples(rng, 9)
    for a in sets:
        for b in sets:
            assert port_ct.ports_conflict(a, b) == ref_ct.ports_conflict(a, b)
    port, ref = port_ct.PortFeatures(sets), ref_ct.PortFeatures(sets)
    assert port.features == ref.features and port.index == ref.index
    np.testing.assert_array_equal(port.caps, ref.caps)
    np.testing.assert_array_equal(port.load_matrix(sets), ref.load_matrix(sets))
    port_res = [port_ct.ports_from_triples(t) for t in reserved]
    ref_res = [ref_ct.ports_from_triples(t) for t in reserved]
    np.testing.assert_array_equal(port.free_matrix(port_res), ref.free_matrix(ref_res))
    np.testing.assert_array_equal(
        port_ct.port_conflict_matrix(sets, port_res), ref_ct.port_conflict_matrix(sets, ref_res)
    )
    # the encoding is HostPort.matches: a load exceeds a free row exactly
    # when some port of the set conflicts with some reservation
    conflict = port_ct.port_conflict_matrix(sets, port_res)
    for g, t in enumerate(sets):
        for m, r in enumerate(port_res):
            assert conflict[g, m] == any(x.matches(y) for x in port_ct.ports_from_triples(t) for y in r)


def test_canonical_ports_match_reference():
    for pkg_ct, pkg in ((port_ct, PORT), (ref_ct, REF)):
        k = TKit(pkg)
        pod = k.pod("p", {"cpu": "1"})
        pod.spec.containers[0].ports = [
            k.ob.ContainerPort(host_port=80),
            k.ob.ContainerPort(host_port=53, protocol="UDP", host_ip="10.0.0.1"),
            k.ob.ContainerPort(container_port=8080),
        ]
        pod.spec.init_containers = [k.ob.Container(name="init", ports=[k.ob.ContainerPort(host_port=80)])]
        assert pkg_ct.canonical_ports(pod) == (("TCP", 80, "0.0.0.0"), ("UDP", 53, "10.0.0.1"))


def _group_vols(ct, rng, n):
    out = []
    for _ in range(n):
        gv = ct.GroupVolumes()
        for _ in range(rng.randint(0, 3)):
            gv.shared.add(["a", "b"][rng.randint(2)], f"ns/claim-{rng.randint(6)}")
        for d in ("a", "b"):
            if rng.rand() < 0.4:
                gv.eph_counts[d] = int(rng.randint(1, 3))
        gv.unresolved = bool(rng.rand() < 0.1)
        out.append(gv)
    return out


def _vol_nodes(pkg, rng, n):
    VolumeUsage = importlib.import_module(f"{pkg}.scheduling.volumes").VolumeUsage
    nodes = []
    for _ in range(n):
        limits = {d: int(rng.randint(0, 5)) for d in ("a", "b") if rng.rand() < 0.7}
        vu = VolumeUsage(limits)
        for d in ("a", "b"):
            for _ in range(rng.randint(0, 4)):
                vu.volumes.add(d, f"ns/claim-{rng.randint(6)}")
        nodes.append(SimpleNamespace(volume_usage=vu))
    return nodes


@pytest.mark.parametrize("seed", range(4))
def test_volume_columns_match_reference(seed):
    port_gv = _group_vols(port_ct, np.random.RandomState(seed), 10)
    ref_gv = _group_vols(ref_ct, np.random.RandomState(seed), 10)
    port_nodes = _vol_nodes(PORT, np.random.RandomState(100 + seed), 8)
    ref_nodes = _vol_nodes(REF, np.random.RandomState(100 + seed), 8)
    admit = port_ct.volume_admit_matrix(port_gv, port_nodes)
    np.testing.assert_array_equal(admit, ref_ct.volume_admit_matrix(ref_gv, ref_nodes))
    assert admit.any() and not admit.all()
    Volumes = importlib.import_module(f"{PORT}.scheduling.volumes").Volumes
    RefVolumes = importlib.import_module(f"{REF}.scheduling.volumes").Volumes
    overlays, ref_overlays = {}, {}
    for m in range(0, 8, 3):
        overlays[m], ref_overlays[m] = Volumes(), RefVolumes()
        for v in (overlays[m], ref_overlays[m]):
            v.add("a", f"ns/new-{m}")
            v.add("b", "ns/claim-1")
    for drivers in (["a"], ["a", "b"], ["b", "c"]):
        np.testing.assert_array_equal(
            port_ct.eph_free_columns(drivers, port_nodes, overlays),
            ref_ct.eph_free_columns(drivers, ref_nodes, ref_overlays),
        )
        np.testing.assert_array_equal(
            port_ct.eph_free_columns(drivers, port_nodes), ref_ct.eph_free_columns(drivers, ref_nodes)
        )


def _volume_kube(pkg, default: bool):
    """A kube store: StorageClasses ``fast`` and (``default``) the default
    ``standard``; PersistentVolume ``pv-1`` (driver ``pv.csi``); claims
    ``bound`` (to pv-1, class fast), ``classed`` (class fast), ``plain``
    (no class)."""
    ob = importlib.import_module(f"{pkg}.kube.objects")
    kube = importlib.import_module(f"{pkg}.kube.client").KubeClient()
    if default:
        sc = ob.StorageClass(provisioner="standard.csi")
        sc.metadata.name = "standard"
        sc.metadata.annotations = {"storageclass.kubernetes.io/is-default-class": "true"}
        kube.create(sc)
    fast = ob.StorageClass(provisioner="fast.csi", zones=["test-zone-3"])
    fast.metadata.name = "fast"
    kube.create(fast)
    pv = ob.PersistentVolume(zones=["test-zone-1", "test-zone-2"], driver="pv.csi")
    pv.metadata.name = "pv-1"
    kube.create(pv)
    for name, sc_name, volume in (("bound", "fast", "pv-1"), ("classed", "fast", ""), ("plain", None, "")):
        claim = ob.PersistentVolumeClaim(storage_class_name=sc_name, volume_name=volume)
        claim.metadata.name = name
        kube.create(claim)
    return kube


VOLUME_SETS = {
    "bound-pv-driver": [("data", "bound", False)],
    "claim-class": [("data", "classed", False)],
    "default-class": [("data", "plain", False), ("scratch", None, True)],
    "missing-claim": [("data", "ghost", False), ("other", "classed", False)],
    "mixed": [("a", "bound", False), ("b", "classed", False), ("c", "plain", False), ("d", None, True), ("e", None, True)],
}


@pytest.mark.parametrize("default", [True, False], ids=["default-class", "no-default-class"])
@pytest.mark.parametrize("case", sorted(VOLUME_SETS))
def test_group_volumes_match_reference(case, default):
    got = []
    for pkg, ct in ((PORT, port_ct), (REF, ref_ct)):
        kube = _volume_kube(pkg, default)
        k = TKit(pkg)
        pod = k.pod("p", {"cpu": "1"})
        pod.spec.volumes = [
            k.ob.Volume(name=n, persistent_volume_claim=c, ephemeral=e) for n, c, e in VOLUME_SETS[case]
        ]
        gv = ct.resolve_group_volumes(kube, SimpleNamespace(exemplar=pod))
        vols = importlib.import_module(f"{pkg}.scheduling.volumes")
        try:
            direct = dict(vols.get_volumes(kube, pod))
        except KeyError as e:
            direct = str(e)
        vt = importlib.import_module(f"{pkg}.scheduler.volumetopology").VolumeTopology(kube)
        vt.inject(pod)
        na = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        pins = [
            [(r.key, r.operator, list(r.values)) for r in t.match_expressions]
            for t in (na.required.node_selector_terms if na else [])
        ]
        got.append((dict(gv.shared), dict(gv.eph_counts), gv.unresolved, gv.empty, direct, pins))
    assert got[0] == got[1]
    if case == "missing-claim":
        assert got[0][2] and isinstance(got[0][4], str)
    if case == "bound-pv-driver":
        assert got[0][0] == {"pv.csi": {"default/bound"}}


# -- plan identity ---------------------------------------------------------------


def _state_node(k, name, cpu="8", memory="16Gi", pods="100", limit=None, zone=None):
    sn = k.state_node(name, cpu=cpu, memory=memory, pods=pods,
                      labels={k.wk.LABEL_TOPOLOGY_ZONE: zone} if zone else None)
    if limit is not None:
        sn.volume_usage.csi_limits = {DRIVER: limit}
    return sn


def _port_pod(k, name, ports, cpu="500m"):
    pod = k.pod(name, {"cpu": cpu})
    pod.spec.containers[0].ports = [
        p if isinstance(p, k.ob.ContainerPort) else k.ob.ContainerPort(host_port=p) for p in ports
    ]
    return pod


def _ports_random(seed):
    """TestHostPortParity's randomized draw: 10–23 pods with no port,
    8080, 9090 or both, against 0–2 existing nodes."""

    def build(k):
        rng = np.random.RandomState(seed)
        choices = [None, [8080], [8080], [9090], [8080, 9090]]
        pods = []
        for i in range(rng.randint(10, 24)):
            ports = choices[rng.randint(len(choices))]
            cpu = ["250m", "500m", "1"][rng.randint(3)]
            pods.append(_port_pod(k, f"p-{i}", ports, cpu) if ports else k.pod(f"p-{i}", {"cpu": cpu}))
        nodes = [_state_node(k, f"sn-{seed}-{m}") for m in range(rng.randint(0, 3))]
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=nodes)

    return build


def _port_colocates(k):
    pods = [_port_pod(k, "port", [8080])] + [k.pod(f"plain-{i}", {"cpu": "500m"}) for i in range(3)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods)


def _specific_ips(k):
    pods = [_port_pod(k, f"ip-{i}", [k.ob.ContainerPort(host_port=80, host_ip=f"10.0.0.{i + 1}")]) for i in range(2)]
    pods += [_port_pod(k, f"wild-{i}", [80]) for i in range(2)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods)


def _existing_port_conflict(k):
    sn = _state_node(k, "porty")
    holder = k.pod("holder", {"cpu": "100m"}, node_name="porty")
    holder.spec.containers[0].ports = [k.ob.ContainerPort(host_port=8080)]
    sn.update_for_pod(holder)
    pods = [_port_pod(k, "p", [8080], "1"), _port_pod(k, "q", [9090], "1")]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=[sn])


def _two_ports_one_node(k):
    """test_solver_existing: two 8080 pods and one 8-CPU node → one on
    the node, one on a new node."""
    pods = [_port_pod(k, f"p-{i}", [8080], "1") for i in range(2)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=[_state_node(k, "n")])


def _two_ports_no_node(k):
    pods = [_port_pod(k, f"p-{i}", [8080], "1") for i in range(2)]
    return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods)


def _csi(limit, n_pods, shared=False, mounted=0, ephemeral=False, missing=False):
    """TestVolumeParity's CSI world: StorageClass ``standard``
    (``ebs.csi.aws.com``), one claim per pod (or one ``shared`` claim),
    one node with attach limit ``limit`` already mounting ``mounted``
    claims through a bound pod."""

    def build(k):
        kube = k.KubeClient()
        sc = k.ob.StorageClass(provisioner=DRIVER)
        sc.metadata.name = "standard"
        sc.metadata.annotations = {"storageclass.kubernetes.io/is-default-class": "true"}
        kube.create(sc)
        sn = _state_node(k, "csi-node", limit=limit)
        if mounted:
            holder = k.pod("holder", {"cpu": "100m"}, node_name="csi-node")
            holder.spec.volumes = []
            for j in range(mounted):
                claim = k.ob.PersistentVolumeClaim(storage_class_name="standard")
                claim.metadata.name = f"held-{j}"
                kube.create(claim)
                holder.spec.volumes.append(k.ob.Volume(name=f"v{j}", persistent_volume_claim=claim.name))
            vols = importlib.import_module(f"{k.ob.__name__.split('.')[0]}.scheduling.volumes")
            sn.volume_usage.add(holder, vols.get_volumes(kube, holder))
        pods = []
        for i in range(n_pods):
            name = "data" if shared else f"data-{i}"
            if not ephemeral and (not shared or i == 0) and not missing:
                claim = k.ob.PersistentVolumeClaim(storage_class_name="standard")
                claim.metadata.name = name
                kube.create(claim)
            p = k.pod(f"vol-{i}", {"cpu": "100m"})
            p.spec.volumes = [
                k.ob.Volume(name="data", ephemeral=True) if ephemeral
                else k.ob.Volume(name="data", persistent_volume_claim="ghost" if missing else name)
            ]
            pods.append(p)
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, state_nodes=[sn], kube=kube)

    return build


def _zone_pin(bound: bool):
    """test_solver_existing's PVC zone pin: a claim bound to a PV in
    test-zone-2, or an unbound claim of a StorageClass allowing
    test-zone-3 only; plain pods beside it."""

    def build(k):
        kube = k.KubeClient()
        sc = k.ob.StorageClass(provisioner=DRIVER, zones=[] if bound else ["test-zone-3"])
        sc.metadata.name = "standard"
        kube.create(sc)
        claim = k.ob.PersistentVolumeClaim(storage_class_name="standard")
        claim.metadata.name = "data"
        if bound:
            pv = k.ob.PersistentVolume(zones=["test-zone-2"], driver=DRIVER)
            pv.metadata.name = "pv-1"
            kube.create(pv)
            claim.volume_name = "pv-1"
        kube.create(claim)
        pod = k.pod("db", {"cpu": "100m"})
        pod.spec.volumes = [k.ob.Volume(name="data", persistent_volume_claim="data")]
        pods = [pod] + [k.pod(f"plain-{i}", {"cpu": "100m"}) for i in range(3)]
        return dict(pools=[k.nodepool()], provider=k.provider(), pods=pods, kube=kube)

    return build


def _zone_pin_existing(k):
    """A pinned claim against existing nodes in three zones: only the
    node in the PV's zone takes the pod."""
    w = _zone_pin(True)(k)
    w["state_nodes"] = [_state_node(k, f"z{z}", zone=f"test-zone-{z}", limit=4) for z in (1, 2, 3)]
    return w


IDENTITY = {
    "ports-random-0": _ports_random(0),
    "ports-random-1": _ports_random(1),
    "ports-random-2": _ports_random(2),
    "port-colocates-with-portless": _port_colocates,
    "specific-ips-share-wildcards-split": _specific_ips,
    "existing-port-conflict": _existing_port_conflict,
    "two-ports-one-node": _two_ports_one_node,
    "two-ports-no-node": _two_ports_no_node,
    "attach-limit-1": _csi(1, 2),
    "attach-limit-4": _csi(4, 2),
    "missing-claim": _csi(4, 1, missing=True),
    "shared-claim-charged-once": _csi(1, 3, shared=True),
    "ephemeral-over-limit": _csi(3, 4, mounted=1, ephemeral=True),
    "full-node-refuses-volumes": _csi(2, 2, mounted=2),
    "pv-zone-pin": _zone_pin(True),
    "storage-class-zone-pin": _zone_pin(False),
    "zone-pin-on-existing": _zone_pin_existing,
}


@pytest.mark.parametrize("case", sorted(IDENTITY))
def test_stateful_plan_identity(monkeypatch, case):
    res, pods, _ = solve_both(monkeypatch, IDENTITY[case])
    on_existing = sum(len(e.pod_indices) for e in res.existing_plans)
    where = {pods[i].name: p for p in res.node_plans for i in p.pod_indices}
    if case == "attach-limit-1":
        assert on_existing == 1 and res.node_count == 1
    elif case == "attach-limit-4":
        assert on_existing == 2 and res.node_count == 0
    elif case in ("missing-claim", "full-node-refuses-volumes"):
        assert on_existing == 0
    elif case == "shared-claim-charged-once":
        assert on_existing == 3
    elif case == "ephemeral-over-limit":
        assert on_existing == 2
    elif case == "specific-ips-share-wildcards-split":
        assert where["ip-0"] is where["ip-1"] and where["wild-0"] is not where["wild-1"]
    elif case == "two-ports-one-node":
        assert on_existing == 1 and res.node_count == 1
    elif case == "two-ports-no-node":
        assert res.node_count == 2
    elif case == "existing-port-conflict":
        assert [pods[i].name for e in res.existing_plans for i in e.pod_indices] == ["q"]
    elif case == "pv-zone-pin":
        assert where["db"].zone == "test-zone-2"
    elif case == "storage-class-zone-pin":
        assert where["db"].zone == "test-zone-3"
    elif case == "zone-pin-on-existing":
        assert [e.state_node.name() for e in res.existing_plans if any(pods[i].name == "db" for i in e.pod_indices)] == ["z2"]


def test_zone_pin_injected_once(monkeypatch):
    """The pin joins the pod's node affinity on the first solve; a warm
    re-solve of the same pods injects nothing and gives the same plan."""
    vt = importlib.import_module(f"{PORT}.scheduler.volumetopology").VolumeTopology
    calls = []
    real = vt.inject
    monkeypatch.setattr(vt, "inject", lambda self, pod: (calls.append(pod.name), real(self, pod))[1])
    w = _zone_pin(True)(TKit(PORT))
    solver = TorchScheduler(w["pools"], w["provider"], device="cpu", kube_client=w["kube"])
    first = plan_stream(solver.solve(w["pods"]))
    assert calls == ["db"]
    terms = w["pods"][0].spec.affinity.node_affinity.required.node_selector_terms
    assert [[(r.key, list(r.values)) for r in t.match_expressions] for t in terms] == [
        [("topology.kubernetes.io/zone", ["test-zone-2"])]
    ]
    memo = w["pods"][0].__dict__["_karp_memo"]
    assert plan_stream(solver.solve(w["pods"])) == first
    assert calls == ["db"] and w["pods"][0].__dict__["_karp_memo"] is memo
    assert len(terms[0].match_expressions) == 1


def test_stateful_groups_with_topology_raise(monkeypatch):
    """Host ports or volumes together with topology spread or pod
    (anti-)affinity: the JAX package's oracle takes the group, and the
    port's greedy fallback gives its claims."""
    for variant in ("spread", "affinity", "anti-affinity"):

        def build(k):
            web = {"app": "web"}
            pod = k.tpod("a", labels=web)
            pod.spec.volumes = [k.ob.Volume(name="data", ephemeral=True)]
            if variant == "spread":
                pod.spec.topology_spread_constraints = [k.spread(k.wk.LABEL_TOPOLOGY_ZONE, labels=web)]
            elif variant == "affinity":
                pod.spec.affinity = k.ob.Affinity(
                    pod_affinity=k.ob.PodAffinity(required=[k.term(k.wk.LABEL_TOPOLOGY_ZONE, web)])
                )
            else:
                pod.spec.affinity = k.ob.Affinity(
                    pod_anti_affinity=k.ob.PodAntiAffinity(required=[k.term(k.wk.LABEL_HOSTNAME, web)])
                )
            return dict(pools=[k.nodepool()], provider=k.provider(), pods=[pod], kube=k.KubeClient())

        res, _, _, _ = solve_pair(monkeypatch, build, TKit, route={"oracle": 1})
        assert res.oracle_results is not None and res.pods_scheduled == 1, variant


# -- chip_smoke.py phase 10, cut down ---------------------------------------------


@pytest.fixture(scope="module")
def smokes():
    with open(f"{REPO}/chip_smoke.py", encoding="utf-8") as f:
        source = f.read()
    return (
        _load("chip_smoke_ref", source.replace("karpenter_core_tpu_torch", "karpenter_core_tpu")),
        _load("chip_smoke", source),
    )


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("bench")
    finally:
        sys.path.remove(REPO)


def _solve(world, ref: bool):
    pools, provider, pods, nodes, daemons, _, kube = world
    if ref:
        solver = TPUScheduler(pools, provider, kube_client=kube)
    else:
        solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
    return solver.solve(pods, state_nodes=nodes, daemonset_pods=daemons), solver


WORLDS = {
    # bench config 13 stateful_dense: the reference world straight from
    # bench.py, the port's from chip_smoke.py, nodes in the bench's units
    "stateful-dense-bench-units": ("stateful_dense_world", (1200, 200, True)),
    "stateful-dense": ("stateful_dense_world", (1200, 200)),
    "spread-skew": ("spread_skew_world", (1200, 200)),
    "stateful-cluster": ("stateful_cluster_world", (1200, 200, 60, 6)),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_phase10_world_plan_identity(smokes, bench, monkeypatch, world):
    reference_native(monkeypatch)
    ref_smoke, smoke = smokes
    fn, args = WORLDS[world]
    if world in ("stateful-dense-bench-units", "spread-skew"):
        scenario = "stateful_dense" if world.startswith("stateful") else "spread_skew"
        pods, provider, nodepool, kube, make_nodes = bench.constraint_env(scenario, args[0])
        ref_world = ([nodepool], provider, pods, make_nodes(), [], {}, kube)
    else:
        ref_world = getattr(ref_smoke, fn)(*args)
    ref, ref_solver = _solve(ref_world, True)
    stats = ref_solver.last_route_stats
    assert (stats["oracle"], stats["parked"]) == (0, 0) and ref.oracle_results is None
    port_world = getattr(smoke, fn)(*args)
    res, _ = _solve(port_world, False)
    pods = port_world[2]
    assert plan_stream(res) == plan_stream(ref)
    assert existing_stream(res) == existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_world[2])
    on_existing = sum(len(e.pod_indices) for e in res.existing_plans)
    if world == "stateful-dense-bench-units":
        assert on_existing == 0  # 110 nano-pods hold no pod
    elif world == "stateful-dense":
        # 457 as the reference places them: 48 with volumes, 70 with ports
        assert on_existing == 457
        ports = smoke.check_ports(res, pods, port_world[3])
        volumes = smoke.check_volumes(res, pods, port_world[3], port_world[6])
        assert (volumes["volume_pods_on_existing"], ports["port_pods_on_existing"]) == (48, 70)
    elif world == "spread-skew":
        smoke.check_spread(res, pods, [], port_world[1], port_world[6])


@pytest.fixture(scope="module")
def cluster(smokes):
    """The cut-down stateful cluster solved on the port → (smoke, result,
    world, the first-fit calls' inputs, the resource axis width)."""
    smoke = smokes[1]
    world = smoke.stateful_cluster_world(1200, 200, 60, 6)
    pools, provider, pods, nodes, daemons, _, kube = world
    solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
    res, calls = smoke.capture_pack_existing(
        lambda: solver.solve(pods, state_nodes=nodes, daemonset_pods=daemons), calls=None
    )
    return smoke, res, world, calls, solver._existing_ctx["axis"].count


def test_phase10_checks_pass(cluster):
    smoke, res, (pools, provider, pods, nodes, daemons, missing, kube), calls, width = cluster
    smoke.check_cluster(res, pods, nodes, daemons, missing, spill=False, pools=pools)
    ports = smoke.check_ports(res, pods, nodes)
    volumes = smoke.check_volumes(res, pods, nodes, kube)
    pins = smoke.check_zone_pins(res, pods, kube)
    assert ports["port_pods_on_existing"] > 0 and volumes["volume_pods_on_existing"] > 0
    assert pins["pinned_placed"] == 18  # every replica: PVs pin pg and redis, a class kafka
    assert not res.pod_errors
    packed = smoke.stateful_pack_check(calls, width, "cpu")
    assert packed["extended_calls"] > 0 and packed["max_R"] > width and packed["max_abs_err"] == 0


def _move(res, i, target):
    """Move pod ``i`` onto ``target`` (a NodePlan or ExistingNodePlan)."""
    for p in list(res.node_plans) + list(res.existing_plans):
        if i in p.pod_indices:
            p.pod_indices.remove(i)
    target.pod_indices.append(i)


def _port_of(pod):
    ports = [p.host_port for c in pod.spec.containers for p in c.ports if p.host_port]
    return ports[0] if ports else None


def _break_ports(smoke, res, pods, nodes, kube, how):
    port_pods = [i for i in range(len(pods)) if _port_of(pods[i]) is not None]
    if how == "new-node-pair":
        holders = {}
        for p in res.node_plans:
            for i in p.pod_indices:
                if _port_of(pods[i]) is not None:
                    holders.setdefault(_port_of(pods[i]), {}).setdefault(id(p), (p, i))
        (pa, _), (_, ib) = next(list(v.values())[:2] for v in holders.values() if len(v) > 1)
        _move(res, ib, pa)
    elif how == "node-reservation":
        agent = next(i for i in port_pods if _port_of(pods[i]) == 9100)
        exporter_node = next(
            e for e in res.existing_plans
            if any(ports for ports in e.state_node.host_port_usage.reserved.values())
        )
        _move(res, agent, exporter_node)
    else:  # "existing-pair": a second pod on a port an existing node's placement holds
        e = next(e for e in res.existing_plans if any(_port_of(pods[i]) for i in e.pod_indices))
        port = next(_port_of(pods[i]) for i in e.pod_indices if _port_of(pods[i]))
        other = next(i for i in port_pods if _port_of(pods[i]) == port and i not in e.pod_indices)
        _move(res, other, e)


def _break_volumes(smoke, res, pods, nodes, kube, how):
    by_name = {sn.name(): sn for sn in nodes}
    eph = [i for i in range(len(pods)) if any(v.ephemeral for v in pods[i].spec.volumes)]
    plans = res.existing_plans
    if how == "pile-up":  # one claim past the limit of a node with placements
        target = plans[0]
        sn = by_name[target.state_node.name()]
        for i in eph[: sn.volume_usage.csi_limits[smoke.CSI_DRIVER] + 1]:
            _move(res, i, target)
        return
    # the node mounting the most claims, filled to its limit with
    # ephemeral claims, then one more: an ephemeral claim ("full-node")
    # or a replica's own claim ("claim-on-full-node")
    sn = max(nodes, key=lambda n: len(n.volume_usage.volumes.get(smoke.CSI_DRIVER, ())))
    room = sn.volume_usage.csi_limits[smoke.CSI_DRIVER] - len(sn.volume_usage.volumes[smoke.CSI_DRIVER])
    target = next((e for e in plans if e.state_node.name() == sn.name()), None)
    if target is None:
        target = type(plans[0])(state_node=sn, pod_indices=[])
        plans.append(target)
    taken = [i for i in target.pod_indices if pods[i].spec.volumes]
    extra = [i for i in eph if i not in taken][: room - len(taken)]
    if how == "full-node":
        extra = [i for i in eph if i not in taken][: room - len(taken) + 1]
    else:
        extra.append(next(i for i in range(len(pods)) if pods[i].name.startswith("redis-")))
    for i in extra:
        _move(res, i, target)


def _break_pins(smoke, res, pods, nodes, kube, how):
    named = {pods[i].name: i for i in range(len(pods))}
    if how == "new-plan-zone":
        plan = next(p for p in res.node_plans if any(pods[i].name.startswith("pg-") for i in p.pod_indices))
        plan.zone = next(z for z in ("test-zone-1", "test-zone-2", "test-zone-3") if z != plan.zone)
    elif how == "existing-other-zone":
        i = named["redis-0"]  # pinned to test-zone-1
        node = next(e for e in res.existing_plans if e.state_node.labels()[TKit(PORT).wk.LABEL_TOPOLOGY_ZONE] != "test-zone-1")
        _move(res, i, node)
    else:  # "class-zones": a kafka replica onto a plan in test-zone-3
        i = named["kafka-0"]
        plan = next(p for p in res.node_plans if not any(pods[j].spec.volumes for j in p.pod_indices))
        plan.zone = "test-zone-3"
        _move(res, i, plan)


BREAKS = {
    "check_ports": (_break_ports, ("new-node-pair", "node-reservation", "existing-pair")),
    "check_volumes": (_break_volumes, ("full-node", "pile-up", "claim-on-full-node")),
    "check_zone_pins": (_break_pins, ("new-plan-zone", "existing-other-zone", "class-zones")),
}


@pytest.mark.parametrize(
    "check,how", [(c, h) for c, (_, hows) in sorted(BREAKS.items()) for h in hows]
)
def test_phase10_checks_refuse_broken_plans(smokes, check, how):
    """Each of the phase's checks fails a plan broken three ways."""
    import copy

    smoke = smokes[1]
    pools, provider, pods, nodes, daemons, missing, kube = smoke.stateful_cluster_world(1200, 200, 60, 6)
    res = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(
        pods, state_nodes=nodes, daemonset_pods=daemons
    )
    args = {
        "check_ports": (pods, nodes),
        "check_volumes": (pods, nodes, kube),
        "check_zone_pins": (pods, kube),
    }[check]
    getattr(smoke, check)(res, *args)
    broken = copy.deepcopy(res)
    for a, b in zip(broken.existing_plans, res.existing_plans):
        a.state_node = b.state_node
    BREAKS[check][0](smoke, broken, pods, nodes, kube, how)
    with pytest.raises(SystemExit):
        getattr(smoke, check)(broken, *args)


# -- the existing-node first-fit on extended columns --------------------------------


def _extended_inputs(seed):
    """Resource columns, then two port pair columns (capacity PORT_K, a
    wildcard loads all of it), one exact-IP column and one ephemeral
    driver column, over a few nodes."""
    rng = np.random.RandomState(seed)
    P, M = int(rng.randint(20, 120)), int(rng.randint(2, 12))
    K = int(port_ct.PORT_K)
    reqs = np.zeros((P, 6), dtype=np.int32)
    reqs[:, 0] = rng.randint(1, 5, size=P) * 250
    reqs[:, 1] = rng.randint(1, 4, size=P) * 256
    reqs[:, 2] = rng.choice([0, 1, K], size=P)
    reqs[:, 3] = rng.choice([0, K], size=P)
    reqs[:, 4] = (reqs[:, 2] == 1).astype(np.int32)
    reqs[:, 5] = rng.randint(0, 2, size=P)
    order = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
    reqs = np.ascontiguousarray(reqs[order])
    free = np.zeros((M, 6), dtype=np.int32)
    free[:, 0] = rng.randint(1, 20, size=M) * 250
    free[:, 1] = rng.randint(1, 20, size=M) * 256
    free[:, 2] = rng.choice([0, K - 1, K], size=M)
    free[:, 3] = rng.choice([0, K], size=M)
    free[:, 4] = rng.randint(0, 2, size=M)
    free[:, 5] = rng.choice([0, 3, 2**30 - 1], size=M)
    compat = (rng.rand(1, M) > 0.2).astype(np.uint8)
    return reqs, np.zeros(P, dtype=np.int32), compat, free


@pytest.mark.parametrize("seed", range(4))
def test_first_fit_on_extended_columns_matches_reference(seed):
    reqs, sig_ids, compat, free = _extended_inputs(seed)
    assign, left = port_pack.run_pack_existing(reqs, sig_ids, compat, free)
    ref_assign, ref_left = ref_pack.pack_existing(reqs, sig_ids, compat.astype(bool), free)
    np.testing.assert_array_equal(assign, np.asarray(ref_assign))
    np.testing.assert_array_equal(left, np.asarray(ref_left))
    plain_assign, plain_left = port_pack.pack_existing_reference(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (reqs, sig_ids, compat, free))
    )
    np.testing.assert_array_equal(plain_assign.numpy(), assign)
    np.testing.assert_array_equal(plain_left.numpy(), left)
    # no node took two wildcards of one pair axis, or a wildcard beside a
    # specific IP
    for m in range(free.shape[0]):
        placed = reqs[assign == m]
        assert placed[:, 2].astype(np.int64).sum() <= free[m, 2]
        assert placed[:, 3].astype(np.int64).sum() <= free[m, 3]
    assert (assign >= 0).any() and (assign < 0).any()


def test_first_fit_on_the_solve_inputs(cluster):
    """The stateful pass's own first-fits (port and ephemeral columns
    appended) against the plain version."""
    smoke, _, _, calls, width = cluster
    for reqs, sig_ids, compat, free in calls:
        if free.shape[1] > width:
            ref_assign, ref_left = ref_pack.pack_existing(reqs, sig_ids, compat.astype(bool), free)
            assign, left = port_pack.run_pack_existing(reqs, sig_ids, compat, free)
            np.testing.assert_array_equal(assign, np.asarray(ref_assign))
            np.testing.assert_array_equal(left, np.asarray(ref_left))
