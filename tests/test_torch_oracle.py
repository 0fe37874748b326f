"""The port's greedy scheduler ≡ the JAX package's.

``karpenter_core_tpu_torch.scheduler`` (queue, preference ladder,
topology engine, claims, existing nodes, ``build_scheduler``) and the
vectorised filter ``solver/oracle_bridge.py`` are copies of the JAX
package's; this file holds them to it on the same inputs, built
separately from each package:

- every scenario of ``tests/test_scheduler.py``,
  ``tests/test_scheduler_behavior.py``, ``tests/test_suite_port.py`` and
  ``tests/test_topology_port.py`` that drives ``build_scheduler(...)
  .solve`` (two drive the provisioner instead), as one parametrised table: the scenario's source runs once
  as written and once with the port's package in place of the JAX
  package's (its own assertions then hold the port too), every solve is
  captured, and the two runs' results must be identical claim for
  claim (nodepool, pods, instance-type options, requirements,
  requests), node for node, and error for error;
- ``fast_filter`` against the exact per-type loop: equal vectors on
  registered catalogs, and the exact loop (a bail-out) on Gt/Lt keys,
  lists under 32 types and unregistered lists;
- a filter call that grows the shared vocab between two
  ``TorchScheduler`` solves leaves the next solve's kernel inputs and
  plans right;
- 20 seeded random mixes (spreads, pod affinity and anti-affinity,
  required and preferred, node selectors, taints, existing nodes,
  daemonsets, a limited pool) through both greedy schedulers.

The claims' placeholder hostnames and generated object names come from
module counters in each package, and object uids (the greedy queue's
last tie-break) from uuid4: ``same_start`` restarts all of them before
each package builds and solves its world, and claims compare by
content, never by hostname.
"""

from __future__ import annotations

import ast
import hashlib
import importlib
import itertools
import json
import re
import sys
import types
import uuid
from pathlib import Path

import numpy as np
import pytest

from test_torch_existing import Kit, errors_by_index, existing_stream, plan_stream

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"
TESTS = Path(__file__).resolve().parent
SCENARIO_FILES = (
    "test_scheduler.py",
    "test_scheduler_behavior.py",
    "test_suite_port.py",
    "test_topology_port.py",
)


# -- shared comparison helpers (the port's TorchScheduler tests use them too) --


def same_start(monkeypatch) -> None:
    """Give the next world and solve of each package the same generated
    identities: both packages' claim-hostname counters and generated-name
    sequences restart at 1, and object uids count from 1 (the greedy
    queue breaks request and creation-time ties by uid, a random uuid4 by
    default)."""
    for pkg in (REF, PORT):
        importlib.import_module(f"{pkg}.scheduler.nodeclaim")._hostname_counter = itertools.count(1)
        importlib.import_module(f"{pkg}.kube.objects")._sequence = itertools.count(1)
    ids = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))


def _requirements_key(reqs) -> list:
    return sorted(
        (k, r.complement, sorted(r.values), r.greater_than, r.less_than) for k, r in reqs.items()
    )


def greedy_stream(res, pods) -> dict:
    """A greedy ``Results`` by content: claims (nodepool, pod indices,
    instance-type options, requirements, requests), existing nodes (name,
    pod indices, requests) and errors by pod index."""
    index = {p.uid: i for i, p in enumerate(pods)}
    return dict(
        claims=[
            (
                c.nodepool_name, [index[p.uid] for p in c.pods],
                [it.name for it in c.instance_type_options], _requirements_key(c.requirements),
                sorted(c.requests.items()),
            )
            for c in res.new_node_claims
        ],
        existing=[
            (e.name(), [index[p.uid] for p in e.pods], sorted(e.requests.items()))
            for e in res.existing_nodes
        ],
        errors={index[uid]: err for uid, err in res.pod_errors.items()},
    )


def oracle_claims(res, pods):
    """The greedy fallback of a batched solve: its claims (nodepool, pod
    indices, instance-type options) and its existing nodes' pods, or None
    when the solve had no fallback."""
    if res.oracle_results is None:
        return None
    g = greedy_stream(res.oracle_results, pods)
    return (
        [c[:3] for c in g["claims"]],
        [e[:2] for e in g["existing"] if e[1]],
    )


def plan_sha256(res) -> str:
    return hashlib.sha256(json.dumps(plan_stream(res)).encode()).hexdigest()


def assert_same_results(res, pods, ref, ref_pods) -> None:
    """The batched solves agree: plan stream (and its sha256), existing
    plans, errors by pod index, the greedy fallback's claims, and the
    counts."""
    assert plan_stream(res) == plan_stream(ref)
    assert plan_sha256(res) == plan_sha256(ref)
    assert existing_stream(res) == existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    assert oracle_claims(res, pods) == oracle_claims(ref, ref_pods)
    assert (res.node_count, res.pods_scheduled, res.total_price) == (
        ref.node_count, ref.pods_scheduled, ref.total_price,
    )


def solve_pair(monkeypatch, build, kit, route=None):
    """Build ``build(kit(pkg))`` → dict(pools, provider, pods,
    state_nodes, daemons, kube) once per package and solve it with
    ``TPUScheduler`` and ``TorchScheduler`` on the CPU; the results must
    be identical, and so must the route splits; the reference's
    ``last_route_stats`` must match ``route`` (pod counts) where given →
    (port result, port world, port solver, reference solver)."""
    from karpenter_core_tpu.solver import TPUScheduler
    from karpenter_core_tpu_torch.solver import TorchScheduler
    from test_torch_native import reference_native

    reference_native(monkeypatch)
    out = []
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        w = build(kit(pkg))
        if pkg == REF:
            solver = TPUScheduler(w["pools"], w["provider"], kube_client=w.get("kube"))
        else:
            solver = TorchScheduler(w["pools"], w["provider"], device="cpu", kube_client=w.get("kube"))
        res = solver.solve(
            w["pods"], state_nodes=w.get("state_nodes") or [], daemonset_pods=w.get("daemons") or []
        )
        out.append((res, w, solver))
    (ref, ref_w, ref_solver), (res, w, solver) = out
    for k, v in (route or {}).items():
        assert ref_solver.last_route_stats[k] == v, (k, ref_solver.last_route_stats)
    assert_same_results(res, w["pods"], ref, ref_w["pods"])
    assert {k: solver.last_route_stats[k] for k in ("tensor", "parked", "oracle")} == {
        k: ref_solver.last_route_stats[k] for k in ("tensor", "parked", "oracle")
    }
    return res, w, solver, ref_solver


# -- the greedy scenarios of the JAX tests, run against both packages ----------


def _port_helpers():
    """tests/helpers.py over the port's classes (module ``_port_helpers``)."""
    mod = sys.modules.get("_port_helpers")
    if mod is None:
        src = (TESTS / "helpers.py").read_text()
        mod = types.ModuleType("_port_helpers")
        mod.__file__ = str(TESTS / "helpers.py")
        sys.modules["_port_helpers"] = mod
        exec(compile(re.sub(r"\bkarpenter_core_tpu\b", PORT, src), mod.__file__, "exec"), mod.__dict__)
    return mod


_MIRRORS: dict = {}


def _capturing_scheduler(cls, captured: list):
    """``cls`` (a batched scheduler class) whose solves land in
    ``captured`` by content."""

    def make(*args, **kwargs):
        solver = cls(*args, **kwargs)
        solve = solver.solve

        def captured_solve(pods, *a, **kw):
            res = solve(pods, *a, **kw)
            pods = list(pods)
            captured.append(
                dict(
                    plans=plan_stream(res), existing=existing_stream(res),
                    errors=errors_by_index(res, pods), oracle=oracle_claims(res, pods),
                    counts=(res.node_count, res.pods_scheduled, res.total_price),
                    route=solver.last_route_stats["oracle"],
                )
            )
            return res

        solver.solve = captured_solve
        return solver

    return make


def _mirror(file: str, pkg: str):
    """The test file's module, its package swapped for ``pkg`` (the
    JAX package's ``TPUScheduler`` becomes the port's ``TorchScheduler``
    on the CPU), its fixtures plain functions, and its ``build_scheduler``
    and batched scheduler capturing every solve into
    ``module._captured``."""
    key = (file, pkg)
    if key in _MIRRORS:
        return _MIRRORS[key]
    src = (TESTS / file).read_text()
    src = src.replace("@pytest.fixture\n", "")
    if pkg == PORT:
        _port_helpers()
        src = re.sub(r"\bkarpenter_core_tpu\b", PORT, src)
        src = src.replace("from helpers import", "from _port_helpers import")
    mod = types.ModuleType(f"_mirror_{pkg}_{file[:-3]}")
    mod.__file__ = str(TESTS / file)
    mod._captured = []
    # every import of the batched scheduler, module-level or local, binds
    # the capturing one
    src = src.replace(f"from {pkg}.solver import TPUScheduler", "TPUScheduler = _BATCHED")
    if pkg == PORT:
        from karpenter_core_tpu_torch.solver import TorchScheduler

        batched = lambda *a, **kw: TorchScheduler(*a, device="cpu", **kw)  # noqa: E731
    else:
        from karpenter_core_tpu.solver import TPUScheduler as batched
    mod._BATCHED = _capturing_scheduler(batched, mod._captured)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    if "build_scheduler" in mod.__dict__:
        real = mod.build_scheduler

        def capturing(*args, **kwargs):
            scheduler = real(*args, **kwargs)
            solve = scheduler.solve

            def captured_solve(pods):
                res = solve(pods)
                mod._captured.append(greedy_stream(res, list(pods)))
                return res

            scheduler.solve = captured_solve
            return scheduler

        mod.build_scheduler = capturing
    _MIRRORS[key] = mod
    return mod


def scenarios(files) -> list:
    """(file, class, test, case) for every test of ``files`` that drives
    a scheduler, one entry per parametrised case. The tests that drive
    the provisioner (which is not ported) are left out."""
    out = []
    for file in files:
        text = (TESTS / file).read_text()
        tree = ast.parse(text)
        for cls in tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test")):
                    continue
                if ".provisioning" in ast.get_source_segment(text, fn):
                    continue
                n_cases = 1
                for dec in fn.decorator_list:
                    if isinstance(dec, ast.Call) and getattr(dec.func, "attr", "") == "parametrize":
                        n_cases = len(dec.args[1].elts)
                for case in range(n_cases):
                    out.append((file, cls.name, fn.name, case))
    return out


SCENARIOS = scenarios(SCENARIO_FILES)


def run_scenario(file: str, cls: str, name: str, case: int, pkg: str, monkeypatch) -> list:
    mod = _mirror(file, pkg)
    mod._captured.clear()
    same_start(monkeypatch)
    instance = getattr(mod, cls)()
    if hasattr(instance, "setup_method"):
        instance.setup_method(getattr(instance, name))
    fn = getattr(instance, name)
    kwargs = {}
    for mark in getattr(fn, "pytestmark", ()):
        if mark.name == "parametrize":
            names = [n.strip() for n in mark.args[0].split(",")]
            values = mark.args[1][case]
            kwargs.update(zip(names, values if len(names) > 1 else (values,)))
    if "provider" in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        kwargs["provider"] = mod.provider()
    fn(**kwargs)
    return list(mod._captured)


def test_scenario_table_covers_the_files():
    assert len(SCENARIOS) > 100
    assert {s[0] for s in SCENARIOS} == set(SCENARIO_FILES)


@pytest.mark.parametrize(
    "file,cls,name,case", SCENARIOS, ids=[f"{f[5:-3]}::{c}::{n}[{k}]" for f, c, n, k in SCENARIOS]
)
def test_greedy_scenario_matches_reference(monkeypatch, file, cls, name, case):
    ref = run_scenario(file, cls, name, case, REF, monkeypatch)
    port = run_scenario(file, cls, name, case, PORT, monkeypatch)
    assert ref, "the scenario drives the greedy scheduler"
    assert port == ref


# -- the vectorised filter against the exact loop -------------------------------


def _filter_world(seed: int, n_types: int = 48):
    """A port catalog whose types carry a custom key (negative, positive or
    absent), and seeded requirement sets over zone, capacity type, arch,
    the instance type and that key."""
    k = Kit(PORT)
    wk, ob = k.wk, k.ob
    from karpenter_core_tpu_torch.scheduling import Requirement, Requirements

    rng = np.random.RandomState(seed)
    types_ = k.fake.instance_types(n_types)
    # a custom key negative on a third of the types (NotIn), positive on
    # another third: NotIn/DoesNotExist requirements then meet the
    # both-negative carve-out of Intersects
    for j, it in enumerate(types_):
        if j % 3 == 0:
            it.requirements.add(Requirement("example.com/tier", ob.OP_NOT_IN, ["gold"]))
        elif j % 3 == 1:
            it.requirements.add(Requirement("example.com/tier", ob.OP_IN, ["silver"]))
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    reqs = []
    for _ in range(40):
        r = Requirements()
        tier = rng.rand()
        if tier < 0.2:
            r.add(Requirement("example.com/tier", ob.OP_NOT_IN, [["bronze", "silver"][rng.randint(2)]]))
        elif tier < 0.3:
            r.add(Requirement("example.com/tier", ob.OP_DOES_NOT_EXIST))
        elif tier < 0.4:
            r.add(Requirement("example.com/tier", ob.OP_IN, ["silver"]))
        roll = rng.rand()
        if roll < 0.3:
            r.add(Requirement(wk.LABEL_TOPOLOGY_ZONE, ob.OP_IN, list(rng.choice(zones, rng.randint(1, 3), replace=False))))
        elif roll < 0.5:
            r.add(Requirement(wk.LABEL_TOPOLOGY_ZONE, ob.OP_NOT_IN, [zones[rng.randint(3)]]))
        if rng.rand() < 0.4:
            r.add(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, ob.OP_IN, [["spot", "on-demand"][rng.randint(2)]]))
        if rng.rand() < 0.3:
            r.add(Requirement(wk.LABEL_ARCH, ob.OP_IN, [["amd64", "arm64"][rng.randint(2)]]))
        if rng.rand() < 0.3:
            # a value no type lists: interned into the shared vocab
            r.add(Requirement(wk.LABEL_INSTANCE_TYPE, ob.OP_NOT_IN, [f"novel-{rng.randint(5)}"]))
        requests = {"cpu": k.pq(["100m", "1", "4", "16", "200"][rng.randint(5)]), "memory": k.pq("1Gi")}
        reqs.append((r, requests))
    return types_, reqs


def _exact(instance_types, requirements, requests):
    from karpenter_core_tpu_torch.scheduler import nodeclaim

    return (
        np.array([nodeclaim._compatible(it, requirements) for it in instance_types], dtype=bool),
        np.array([nodeclaim._fits(it, requests) for it in instance_types], dtype=bool),
        np.array([nodeclaim._has_offering(it, requirements) for it in instance_types], dtype=bool),
    )


@pytest.mark.parametrize("seed", range(3))
def test_fast_filter_matches_exact_loop(seed):
    from karpenter_core_tpu_torch.solver import oracle_bridge

    types_, reqs = _filter_world(seed)
    oracle_bridge.refresh(types_)
    rng = np.random.RandomState(100 + seed)
    for requirements, requests in reqs:
        # the full list, and a sublist as a claim narrows it
        for its in (types_, [it for it in types_ if rng.rand() < 0.8]):
            got = oracle_bridge.fast_filter(its, requirements, requests)
            if len(its) < 32:
                assert got is None
                continue
            assert got is not None
            for a, b in zip(got, _exact(its, requirements, requests)):
                np.testing.assert_array_equal(a, b)


def _bounded_catalog():
    """48 types, every fourth carrying a Gt bound on an integer label."""
    k = Kit(PORT)
    from karpenter_core_tpu_torch.scheduling import Requirement

    types_ = k.fake.instance_types(48)
    for j, it in enumerate(types_):
        if j % 4 == 0:
            it.requirements.add(Requirement("example.com/gen", k.ob.OP_GT, ["3"]))
    return k, types_


def test_fast_filter_bails_on_bounds_small_and_unregistered_lists():
    """Each bail-out leaves the exact loop to the caller: Gt/Lt bounds on
    a shared key (catalog side or requirement side), fewer than 32 types,
    and types no refresh registered; filter_instance_types_by_requirements
    then equals the exact loop."""
    from karpenter_core_tpu_torch.scheduler import nodeclaim
    from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
    from karpenter_core_tpu_torch.solver import oracle_bridge

    k, types_ = _bounded_catalog()
    oracle_bridge.refresh(types_)
    requests = {"cpu": k.pq("1"), "memory": k.pq("1Gi")}
    on_bounded_key = Requirements(Requirement("example.com/gen", k.ob.OP_IN, ["2", "5"]))
    assert oracle_bridge.fast_filter(types_, on_bounded_key, requests) is None
    plain_types = k.fake.instance_types(48)
    oracle_bridge.refresh(plain_types)
    bounded_req = Requirements(Requirement(k.wk.LABEL_INSTANCE_TYPE, k.ob.OP_GT, ["3"]))
    assert oracle_bridge.fast_filter(plain_types, bounded_req, requests) is None
    assert oracle_bridge.fast_filter(plain_types[:31], Requirements(), requests) is None
    unregistered = k.fake.instance_types(48)
    assert oracle_bridge.fast_filter(unregistered, Requirements(), requests) is None
    mixed = plain_types[:20] + unregistered[20:]
    assert oracle_bridge.fast_filter(mixed, Requirements(), requests) is None
    assert oracle_bridge.fast_filter(plain_types, Requirements(), requests) is not None
    for its, reqs in (
        (types_, on_bounded_key), (plain_types, bounded_req), (plain_types[:31], Requirements()),
        (unregistered, Requirements()), (mixed, Requirements()),
    ):
        got = nodeclaim.filter_instance_types_by_requirements(its, reqs, requests)
        compat, fits, offering = _exact(its, reqs, requests)
        assert [it.name for it in got.remaining] == [
            it.name for it, ok in zip(its, compat & fits & offering) if ok
        ]
        assert (got.requirements_met, got.fits, got.has_offering) == (
            bool(compat.any()), bool(fits.any()), bool(offering.any()),
        )


def test_stale_entry_is_never_served():
    """An in-place offering change makes the next refresh encode the
    catalog afresh; the filter then reads the new availability."""
    from karpenter_core_tpu_torch.scheduling import Requirements
    from karpenter_core_tpu_torch.solver import oracle_bridge

    k = Kit(PORT)
    types_ = k.fake.instance_types(40)
    oracle_bridge.refresh(types_)
    requests = {"cpu": k.pq("100m")}
    _, _, before = oracle_bridge.fast_filter(types_, Requirements(), requests)
    assert before.all()
    for o in types_[0].offerings:
        o.available = False
    oracle_bridge.refresh(types_)
    _, _, after = oracle_bridge.fast_filter(types_, Requirements(), requests)
    assert not after[0] and after[1:].all()


def _vocab_world(pkg: str, value: str):
    k = Kit(pkg)
    pools = [k.nodepool()]
    provider = k.provider(n_types=40)
    pods = [
        k.pod(f"p-{i}", {"cpu": "500m"}, node_selector={k.wk.LABEL_ARCH: "amd64"} if i % 3 else None)
        for i in range(30)
    ]
    for i in range(0, 30, 4):
        pods[i].spec.affinity = k.ob.Affinity(
            node_affinity=k.ob.NodeAffinity(
                required=k.ob.NodeSelector(
                    node_selector_terms=[
                        k.ob.NodeSelectorTerm(
                            match_expressions=[
                                k.ob.NodeSelectorRequirement(k.wk.LABEL_INSTANCE_TYPE, k.ob.OP_NOT_IN, [value])
                            ]
                        )
                    ]
                )
            )
        )
    return pools, provider, pods


def test_vocab_growth_between_solves_keeps_kernel_inputs_right():
    """The greedy filter interns a value the first solve never saw into
    the catalog entry's vocab; the next solve's kernel inputs (the type
    side, re-packed for the wider vocab) equal a fresh encoding's, and its
    plans equal a fresh scheduler's and the JAX package's."""
    from karpenter_core_tpu.solver import TPUScheduler
    from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
    from karpenter_core_tpu_torch.solver import TorchScheduler, oracle_bridge

    pools, provider, pods = _vocab_world(PORT, "fresh-type")
    solver = TorchScheduler(pools, provider, device="cpu")
    solver.solve(pods)
    catalog = provider.get_instance_types(pools[0])
    entry = solver._catalog_entry(catalog)
    before = solver._device_catalog(entry)
    width = entry.vocab.key_vocab(Kit(PORT).wk.LABEL_INSTANCE_TYPE).size
    oracle_bridge.refresh(catalog, solver._catalog_entry)
    grown = Requirements(Requirement(Kit(PORT).wk.LABEL_INSTANCE_TYPE, "NotIn", ["fresh-type", "other-new"]))
    assert oracle_bridge.fast_filter(catalog, grown, {"cpu": 1}) is not None
    assert entry.vocab.key_vocab(Kit(PORT).wk.LABEL_INSTANCE_TYPE).size == width + 1
    res = solver.solve(pods)
    after = solver._device_catalog(entry)
    assert after is not before
    fresh_solver = TorchScheduler(pools, provider, device="cpu")
    fresh_solver.solve(pods)
    fresh = fresh_solver._device_catalog(fresh_solver._catalog_entry(catalog))
    # the same type side for every value the pods name: the grown entry
    # holds one slot more on the instance-type key
    assert after.n_types == fresh.n_types
    assert plan_stream(res) == plan_stream(fresh_solver.solve(pods))
    ref_pools, ref_provider, ref_pods = _vocab_world(REF, "fresh-type")
    assert plan_stream(res) == plan_stream(TPUScheduler(ref_pools, ref_provider).solve(ref_pods))
    # the bridge's width check also holds the host masks to the vocab
    for key, mask in entry.enc.key_masks.items():
        assert mask.shape[1] == entry.vocab.key_vocab(key).size


# -- the preference ladder ---------------------------------------------------------


def _ladder_pod(pkg: str, seed: int):
    """A pod with every soft constraint the ladder strips, drawn from
    ``seed``: required node-affinity terms, preferred pod affinity and
    anti-affinity and node affinity of several weights, and spreads of
    both kinds in a seeded order."""
    k = Kit(pkg)
    wk, ob = k.wk, k.ob
    rng = np.random.RandomState(seed)

    def term(zone):
        return ob.NodeSelectorTerm(match_expressions=[ob.NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, "In", [zone])])

    def pod_term(app):
        return ob.PodAffinityTerm(
            topology_key=wk.LABEL_HOSTNAME, label_selector=ob.LabelSelector(match_labels={"app": app})
        )

    pod = k.pod("ladder", {"cpu": "1"}, labels={"app": "a"})
    weights = [int(w) for w in rng.choice(np.arange(1, 100), 3, replace=False)]
    pod.spec.affinity = ob.Affinity(
        node_affinity=ob.NodeAffinity(
            required=ob.NodeSelector(node_selector_terms=[term(f"z-{j}") for j in range(int(rng.randint(1, 4)))]),
            preferred=[ob.PreferredSchedulingTerm(weight=w, preference=term(f"p-{w}")) for w in weights],
        ),
        pod_affinity=ob.PodAffinity(
            preferred=[ob.WeightedPodAffinityTerm(w, pod_term(f"aff-{w}")) for w in weights[:2]]
        ),
        pod_anti_affinity=ob.PodAntiAffinity(
            preferred=[ob.WeightedPodAffinityTerm(w, pod_term(f"anti-{w}")) for w in weights[1:]]
        ),
    )
    pod.spec.topology_spread_constraints = [
        ob.TopologySpreadConstraint(
            max_skew=j + 1, topology_key=wk.LABEL_TOPOLOGY_ZONE,
            when_unsatisfiable=["DoNotSchedule", "ScheduleAnyway"][int(rng.randint(2))],
            label_selector=ob.LabelSelector(match_labels={"app": f"s-{j}"}),
        )
        for j in range(4)
    ]
    if rng.rand() < 0.5:
        pod.spec.tolerations = [ob.Toleration(key="x", operator="Exists", effect="PreferNoSchedule")]
    return pod


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prefer_no_schedule", [False, True])
def test_preference_ladder_matches_reference(seed, prefer_no_schedule):
    """Relaxing the same pod step by step gives the same spec after every
    step, in the reference's order (required term, preferred pod
    affinity, anti-affinity, node affinity, ScheduleAnyway spreads with
    their swap-remove, the PreferNoSchedule toleration), and drops the
    pod's memo each time."""
    steps = []
    for pkg in (REF, PORT):
        prefs = importlib.import_module(f"{pkg}.scheduler.preferences").Preferences(prefer_no_schedule)
        pod = _ladder_pod(pkg, seed)
        trail = []
        for _ in range(30):
            pod.__dict__["_karp_memo"] = "stale"
            relaxed = prefs.relax(pod)
            trail.append((relaxed, "_karp_memo" in pod.__dict__, repr(pod.spec.affinity),
                          repr(pod.spec.topology_spread_constraints), repr(pod.spec.tolerations)))
            if not relaxed:
                break
        steps.append(trail)
    assert steps[1] == steps[0]
    assert len(steps[0]) > 5 and not steps[0][-1][0]


# -- seeded random mixes through both greedy schedulers ----------------------------


def random_mix(pkg: str, seed: int) -> dict:
    """A mixed batch over ``pkg``'s classes → build_scheduler's inputs."""
    k = Kit(pkg)
    wk, ob = k.wk, k.ob
    rng = np.random.RandomState(seed)
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    apps = ["web", "api", "db", "cache"]
    pools = [k.nodepool("default")]
    gpu = k.nodepool("tainted", taints=[dict(key="team", value="ml", effect="NoSchedule")], weight=5)
    pools.append(gpu)
    if rng.rand() < 0.5:
        pools.append(k.nodepool("limited", limits={"cpu": "24"}, weight=10))
    provider = k.provider(n_types=int(rng.choice([12, 40])))
    kube = importlib.import_module(f"{pkg}.kube.client").KubeClient()

    def sel(app):
        return ob.LabelSelector(match_labels={"app": app})

    pods = []
    for i in range(int(rng.randint(25, 60))):
        app = apps[rng.randint(len(apps))]
        pod = k.pod(
            f"m{seed}-{i}",
            {"cpu": ["100m", "250m", "500m", "1", "2"][rng.randint(5)], "memory": ["128Mi", "512Mi", "1Gi"][rng.randint(3)]},
            labels={"app": app},
        )
        roll = rng.rand()
        if roll < 0.15:
            pod.spec.topology_spread_constraints = [
                ob.TopologySpreadConstraint(
                    max_skew=int(rng.randint(1, 3)),
                    topology_key=[wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME][rng.randint(2)],
                    when_unsatisfiable=["DoNotSchedule", "ScheduleAnyway"][rng.randint(2)],
                    label_selector=sel(app),
                )
            ]
        elif roll < 0.3:
            term = ob.PodAffinityTerm(
                topology_key=[wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME][rng.randint(2)],
                label_selector=sel(apps[rng.randint(len(apps))]),
            )
            if rng.rand() < 0.5:
                pod.spec.affinity = ob.Affinity(
                    pod_anti_affinity=ob.PodAntiAffinity(
                        preferred=[ob.WeightedPodAffinityTerm(int(rng.randint(1, 100)), term)]
                    )
                    if rng.rand() < 0.5
                    else ob.PodAntiAffinity(required=[term])
                )
            else:
                pod.spec.affinity = ob.Affinity(
                    pod_affinity=ob.PodAffinity(
                        preferred=[ob.WeightedPodAffinityTerm(int(rng.randint(1, 100)), term)]
                    )
                    if rng.rand() < 0.5
                    else ob.PodAffinity(required=[term])
                )
        elif roll < 0.45:
            pod.spec.affinity = ob.Affinity(
                node_affinity=ob.NodeAffinity(
                    preferred=[
                        ob.PreferredSchedulingTerm(
                            weight=int(rng.randint(1, 100)),
                            preference=ob.NodeSelectorTerm(
                                match_expressions=[
                                    ob.NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, ob.OP_IN, [zones[rng.randint(3)]])
                                ]
                            ),
                        )
                    ]
                )
            )
        elif roll < 0.55:
            pod.spec.node_selector = {wk.CAPACITY_TYPE_LABEL_KEY: ["spot", "on-demand"][rng.randint(2)]}
        elif roll < 0.62:
            pod.spec.tolerations = [ob.Toleration(key="team", operator="Exists")]
        elif roll < 0.66:
            pod.spec.node_selector = {"team": "nobody"}
        pods.append(pod)
    state_nodes = []
    for n in range(int(rng.randint(0, 4))):
        node = k.state_node(
            f"node-{n}", cpu=["2", "4"][rng.randint(2)],
            labels={wk.LABEL_TOPOLOGY_ZONE: zones[n % 3], wk.CAPACITY_TYPE_LABEL_KEY: "on-demand"},
            initialized=bool(n % 2 == 0 or rng.rand() < 0.5),
        )
        state_nodes.append(node)
        kube.create(node.node)
        bound = k.pod(f"b{seed}-{n}", {"cpu": "250m"}, labels={"app": apps[n % 4]}, node_name=node.name())
        node.update_for_pod(bound)
        kube.create(bound)
    daemons = [k.pod("ds", {"cpu": "100m", "memory": "64Mi"}, daemonset=True)] if rng.rand() < 0.5 else []
    return dict(pools=pools, provider=provider, pods=pods, state_nodes=state_nodes, daemons=daemons, kube=kube)


def greedy_solve(pkg: str, w: dict):
    builder = importlib.import_module(f"{pkg}.scheduler.builder")
    scheduler = builder.build_scheduler(
        w["kube"], None, w["pools"], w["provider"], w["pods"],
        state_nodes=w["state_nodes"], daemonset_pods=w["daemons"],
    )
    return scheduler.solve(w["pods"])


@pytest.mark.parametrize("seed", range(20))
def test_random_mix_greedy_matches_reference(monkeypatch, seed):
    same_start(monkeypatch)
    ref_w = random_mix(REF, seed)
    ref = greedy_solve(REF, ref_w)
    same_start(monkeypatch)
    port_w = random_mix(PORT, seed)
    port = greedy_solve(PORT, port_w)
    assert greedy_stream(port, port_w["pods"]) == greedy_stream(ref, ref_w["pods"])
    # relaxed in place by both ladders alike
    assert [repr(p.spec.affinity) for p in port_w["pods"]] == [repr(p.spec.affinity) for p in ref_w["pods"]]


def test_recorder_and_cluster_are_refused(monkeypatch):
    """The recorder and the cluster-state object are taken, as the JAX
    package's greedy scheduler takes them: with both, four random mixes
    give the same claims, the same failure and nomination events, and
    the same nominated nodes in both packages (the cluster mirrors the
    mix's kube store through its informers)."""
    for seed in range(4):
        out = {}
        for pkg in (REF, PORT):
            same_start(monkeypatch)
            w = random_mix(pkg, seed)
            imp = lambda m, pkg=pkg: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
            kube = w["kube"] or imp("kube.client").KubeClient()
            cluster = imp("state.cluster").Cluster(kube, w["provider"], clock=lambda: 100.0)
            informers = imp("state.informers").Informers(kube, cluster)
            informers.start()
            recorder = imp("events").Recorder(clock=lambda: 100.0)
            scheduler = imp("scheduler.builder").build_scheduler(
                kube, cluster, w["pools"], w["provider"], w["pods"],
                state_nodes=w["state_nodes"], daemonset_pods=w["daemons"], recorder=recorder,
            )
            res = scheduler.solve(w["pods"])
            informers.stop()
            out[pkg] = dict(
                stream=greedy_stream(res, w["pods"]),
                events=[(e.type, e.reason, e.involved_object.name, e.message) for e in recorder.events],
                nominated=sorted(pid for pid in cluster.nodes if cluster.is_node_nominated(pid)),
            )
        assert out[REF]["events"], seed
        assert out[PORT] == out[REF], seed
