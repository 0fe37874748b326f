"""Seeded disruption worlds through both packages: the port's decisions ≡
the JAX package's.

Each world is built twice from one ``RandomState``, once from each
package's classes (``helpers.Env``; the port's with its provisioner on
the CPU), with the generated names and uids restarted (``same_start``):
two NodePools, nodes of mixed types, zones and capacity types carrying
0-5 bound pods, an hour on the clock. Then, on both packages, under both
``use_tpu_solver`` values:

- multi-node and single-node consolidation decide under the batched
  engine (twice: the second decision on warm memos) and the sequential
  path, and every decision's command key (action, disrupted nodes,
  replacement types), engine stats (bounds, subsets screened, feasible
  and verified, family cap, per-order verdicts, the memo counts), the
  batched simulation scheduler's cache counts and the events it
  published are equal across the packages; batched equals sequential
  within each;
- the condition cohorts (Expiration, Drift) decide the same way;
- ``DisruptionController.reconcile`` runs until it returns nothing, then
  ``OrchestrationQueue.reconcile``: the executed methods, the nodes'
  taints, the replacement NodeClaims, the cluster's deletion marks, the
  events and the disruption metric samples are equal.

``chip_smoke.py``'s phase 15 runs cut down at the end.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_disruption import disrupt_helpers
from test_torch_incremental import reset_both
from test_torch_kube_client import PORT, REF
from test_torch_native import reference_native
from test_torch_oracle import same_start

SEEDS = (11, 22, 33)
ENGINE_ENV = {REF: "KARPENTER_TPU_DISRUPT_ENGINE", PORT: "KARPENTER_TORCH_DISRUPT_ENGINE"}
STAT_KEYS = (
    "engine", "cohort", "candidates", "screen_upper_k", "repack_lower_k", "subsets_screened",
    "screen_feasible_subsets", "subsets_verified", "family_capped", "orders", "best_family", "cache",
)


def cmd_key(cmd) -> tuple:
    reps = tuple(
        tuple(sorted(it.name for it in r.instance_type_options)) for r in (cmd.replacements or [])
    )
    return (cmd.action(), tuple(sorted(c.name() for c in cmd.candidates)), reps)


def build(pkg: str, seed: int, use_tpu: bool, monkeypatch):
    """One package's seeded world → its Env."""
    same_start(monkeypatch)
    h = importlib.import_module("helpers") if pkg == REF else disrupt_helpers()
    rng = np.random.RandomState(seed)
    env = h.Env()
    env.provisioner.use_tpu_solver = use_tpu
    main = env.nodepool
    spare = h.make_nodepool(name="spare")
    spare.spec.disruption.consolidate_after = 0.0
    env.kube.create(spare)
    for _ in range(int(rng.randint(8, 14))):
        env.nodepool = spare if rng.rand() < 0.35 else main
        pods = [
            h.running_pod(cpu=f"{int(rng.choice([100, 200, 400, 900]))}m")
            for _ in range(int(rng.randint(0, 6)))
        ]
        env.make_initialized_node(
            instance_type_name=f"fake-it-{int(rng.randint(2, 9))}",
            zone=f"test-zone-{1 + int(rng.randint(2))}",
            capacity_type="spot" if rng.rand() < 0.3 else "on-demand",
            pods=pods,
        )
    env.nodepool = main
    env.now += 3600.0
    assert env.cluster.synced()
    return env


def decide(pkg: str, env, method_name: str, mode: str, monkeypatch) -> dict:
    """One decision of ``method_name`` under ``mode`` → its readings."""
    methods = importlib.import_module(f"{pkg}.disruption.methods")
    helpers = importlib.import_module(f"{pkg}.disruption.helpers")
    monkeypatch.setenv(ENGINE_ENV[pkg], mode)
    method = getattr(methods, method_name)(env.controller.ctx)
    n_events = len(env.recorder.events)
    candidates = helpers.get_candidates(
        env.cluster, env.kube, env.recorder, env.clock, env.provider,
        method.should_disrupt, env.controller.queue,
    )
    cmd = method.compute_command(candidates)
    stats = method.last_decision_stats or {}
    sim = getattr(env.provisioner, "_sim_tpu_solver", None)
    return dict(
        key=cmd_key(cmd),
        stats={k: stats[k] for k in STAT_KEYS if k in stats},
        sim_cache=(sim[1].last_cache_stats if sim is not None else None),
        events=[
            (e.type, e.reason, getattr(e.involved_object, "name", ""), e.message)
            for e in env.recorder.events[n_events:]
        ],
    )


def both(seed: int, use_tpu: bool, monkeypatch, run, make=None) -> dict:
    """``run(pkg, env)`` on each package's seeded world (or ``make(pkg)``'s)
    → {pkg: result}."""
    reference_native(monkeypatch)
    out = {}
    for pkg in (REF, PORT):
        reset_both()
        env = make(pkg) if make else build(pkg, seed, use_tpu, monkeypatch)
        try:
            out[pkg] = run(pkg, env)
        finally:
            env.stop()
    return out


@pytest.mark.parametrize("use_tpu", [False, True], ids=["greedy-sim", "batched-sim"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method_name", ["MultiNodeConsolidation", "SingleNodeConsolidation"])
def test_consolidation_decisions_equal_reference(monkeypatch, method_name, seed, use_tpu):
    def run(pkg, env):
        return [
            decide(pkg, env, method_name, mode, monkeypatch)
            for mode in ("batched", "batched", "sequential")
        ]

    got = both(seed, use_tpu, monkeypatch, run)
    assert got[PORT] == got[REF]
    batched, warm, sequential = got[PORT]
    assert batched["key"] == warm["key"] == sequential["key"]
    assert batched["stats"]["engine"] == "batched"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("condition", ["Expired", "Drifted"])
def test_condition_cohorts_equal_reference(monkeypatch, condition, seed):
    """Every claim with pods marked at spread transition times: the
    cohort decides with a simulation per candidate in order."""

    def run(pkg, env):
        nodeclaim = importlib.import_module(f"{pkg}.apis.nodeclaim")
        cond = {"Expired": nodeclaim.COND_EXPIRED, "Drifted": nodeclaim.COND_DRIFTED}[condition]
        rng = np.random.RandomState(seed + 7)
        busy = {p.spec.node_name for p in env.kube.list("Pod") if p.spec.node_name}
        names = {n.spec.provider_id: n.metadata.name for n in env.kube.list("Node")}
        for nc in sorted(env.kube.list("NodeClaim"), key=lambda c: c.metadata.name):
            if names.get(nc.status.provider_id) in busy:
                nc.set_condition(cond, "True")
                nc.get_condition(cond).last_transition_time = env.now - float(rng.randint(60, 3000))
                env.kube.apply(nc)
        method_name = {"Expired": "Expiration", "Drifted": "Drift"}[condition]
        return [decide(pkg, env, method_name, mode, monkeypatch) for mode in ("batched", "sequential")]

    got = both(seed, True, monkeypatch, run)
    assert got[PORT] == got[REF]
    assert got[PORT][0]["key"] == got[PORT][1]["key"]


def controller_world(pkg: str, env, seed: int) -> None:
    """Add to a seeded world what every method of the controller acts
    on: the provider reports no drift of its own; one claim of the main
    pool carries a stale pool hash (drift); the spare pool's nodes
    outlive its ``expire_after`` (expiration); a third pool consolidates
    when empty and holds two empty nodes (emptiness); the main pool stays
    underutilized (consolidation)."""
    h = importlib.import_module("helpers") if pkg == REF else disrupt_helpers()
    nodepool = importlib.import_module(f"{pkg}.apis.nodepool")
    labels = importlib.import_module(f"{pkg}.apis.labels")
    env.provider.drifted = ""
    rng = np.random.RandomState(seed + 5)
    spare = env.kube.get("NodePool", "spare")
    spare.spec.disruption.expire_after = 1800.0
    env.kube.apply(spare)
    main = env.nodepool
    empty = h.make_nodepool(name="empty")
    empty.spec.disruption.consolidation_policy = nodepool.CONSOLIDATION_POLICY_WHEN_EMPTY
    empty.spec.disruption.consolidate_after = 0.0
    env.kube.create(empty)
    env.nodepool = empty
    for _ in range(2):
        env.make_initialized_node(instance_type_name="fake-it-3")
    env.nodepool = main
    claims = sorted(
        (nc for nc in env.kube.list("NodeClaim") if nc.metadata.labels.get(labels.NODEPOOL_LABEL_KEY) == "default"),
        key=lambda nc: nc.metadata.name,
    )
    stale = claims[int(rng.randint(len(claims)))]
    stale.metadata.annotations[labels.NODEPOOL_HASH_ANNOTATION_KEY] = "stale"
    env.kube.apply(stale)
    for pool in env.kube.list("NodePool"):
        pool.metadata.annotations[labels.NODEPOOL_HASH_ANNOTATION_KEY] = pool.static_hash()
        env.kube.apply(pool)
    assert env.cluster.synced()


def controller_run(pkg: str, env) -> dict:
    """Markers, then the disruption controller until it returns nothing,
    then the orchestration queue → the store and the samples."""
    metrics_mod = importlib.import_module(f"{pkg}.metrics.registry")
    markers = importlib.import_module(f"{pkg}.disruption.markers")
    metrics = metrics_mod.Metrics()
    env.controller.metrics = metrics
    env.controller.queue.metrics = metrics
    markers.NodeClaimDisruptionController(env.kube, env.provider, env.cluster, clock=env.clock).reconcile_all()
    nodeclaim = importlib.import_module(f"{pkg}.apis.nodeclaim")
    for nc in env.kube.list("NodeClaim"):
        # conditions carry wall-clock stamps; the world runs on env's clock
        cond = nc.get_condition(nodeclaim.COND_EMPTY)
        if cond is not None:
            cond.last_transition_time = env.now - 60.0
    passes = []
    for _ in range(12):
        done = env.controller.reconcile()
        passes.append(done)
        if done is None:
            break
    env.controller.queue.reconcile()
    return dict(
        passes=passes,
        conditions=sorted(
            (nc.metadata.name, sorted((c.type, c.status) for c in nc.status.conditions))
            for nc in env.kube.list("NodeClaim")
        ),
        taints=sorted(
            (n.metadata.name, sorted((t.key, t.value, t.effect) for t in n.spec.taints))
            for n in env.kube.list("Node")
        ),
        claims=sorted(
            (
                nc.metadata.name,
                sorted(nc.metadata.labels.items()),
                sorted((r.key, r.operator, tuple(sorted(r.values))) for r in nc.spec.requirements),
                nc.metadata.deletion_timestamp is not None,
            )
            for nc in env.kube.list("NodeClaim")
        ),
        marked=sorted(pid for pid, n in env.cluster.nodes.items() if n.marked_for_deletion),
        events=sorted(
            (e.type, e.reason, getattr(e.involved_object, "name", ""), e.message) for e in env.recorder.events
        ),
        actions=sorted(metrics.disruption_actions.values.items()),
        eligible=sorted(metrics.eligible_nodes.values.items()),
        subsets=sorted(metrics.disruption_subsets.values.items()),
        evaluations=sorted(metrics.disruption_evaluation_duration.totals.items()),
        disrupted=sorted(metrics.nodeclaims_disrupted.values.items()),
    )


@pytest.mark.parametrize("use_tpu", [False, True], ids=["greedy-sim", "batched-sim"])
@pytest.mark.parametrize("seed", SEEDS)
def test_controller_end_to_end_equals_reference(monkeypatch, seed, use_tpu):
    def run(pkg, env):
        controller_world(pkg, env, seed)
        return controller_run(pkg, env)

    got = both(seed, use_tpu, monkeypatch, run)
    assert got[PORT] == got[REF]
    assert {"expiration", "drift", "emptiness"} <= set(got[PORT]["passes"])


def test_sim_scheduler_keyed_by_device(monkeypatch):
    """A CPU simulation never shares its scheduler with a card one: the
    device is part of the cached scheduler's key, so a provisioner moved
    to the card builds a card scheduler (which raises here, with no
    card) instead of reusing the CPU one."""
    from karpenter_core_tpu_torch.disruption import helpers

    reset_both()
    env = build(PORT, 11, True, monkeypatch)
    try:
        pools = [p for p in env.kube.list("NodePool") if p.metadata.deletion_timestamp is None]
        first = helpers._sim_scheduler(env.kube, env.cluster, env.provisioner, pools)
        assert str(first.device) == "cpu"
        assert helpers._sim_scheduler(env.kube, env.cluster, env.provisioner, pools) is first
        env.provisioner.device = "cuda"
        with pytest.raises(RuntimeError, match="is_available"):
            helpers._sim_scheduler(env.kube, env.cluster, env.provisioner, pools)
    finally:
        env.stop()


def test_config4_world_equals_reference(monkeypatch):
    """Bench config 4's world cut to 1,200 nodes (1,000 candidates after
    the screen cap, 200 nodes of fleet): the memory column's sums pass
    2^24, and the decision, its bounds and its family verdicts still
    equal the JAX package's."""

    def run(pkg, env):
        objects = importlib.import_module(f"{pkg}.kube.objects")
        quantity = importlib.import_module(f"{pkg}.kube.quantity")
        for i in range(1_200):
            pod = objects.Pod()
            pod.metadata.name = f"r-{i}"
            pod.spec = objects.PodSpec(containers=[objects.Container(name="c", resources=objects.ResourceRequirements(
                requests={"cpu": quantity.parse_quantity("100m"), "memory": quantity.parse_quantity("128Mi")}))])
            env.make_initialized_node(instance_type_name="fake-it-4", pods=[pod])
        env.now += 3600.0
        return decide(pkg, env, "MultiNodeConsolidation", "batched", monkeypatch)

    def make(pkg):
        same_start(monkeypatch)
        return (importlib.import_module("helpers") if pkg == REF else disrupt_helpers()).Env()

    got = both(0, False, monkeypatch, run, make)
    assert got[PORT] == got[REF]
    assert got[PORT]["key"][0] == "delete"
    assert got[PORT]["stats"]["candidates"] == 1_200 and got[PORT]["stats"]["subsets_screened"] == 999


@pytest.mark.parametrize("part", ["config4", "config9", "controller"])
def test_chip_smoke_phase15_cut_down(part):
    """``chip_smoke.py``'s phase 15 parts on the CPU, cut down, with all
    their checks (the CPU run against itself: identities restart)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phase15", Path(__file__).resolve().parent.parent / "chip_smoke.py"
    )
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if part == "config4":
        a, b = cs.run_config4("cpu", 300), cs.run_config4("cpu", 300)
        assert a["key"] == b["key"] and a["engine"] == b["engine"] and a["action"] != "no-op"
        assert a["engine"]["subsets_screened"] == 299
    elif part == "config9":
        row = cs.run_config9("cpu", 60, 40, steady=2)
        assert [s["step"] for s in row["steps"]] == ["A0", "B1", "B2", "B3", "B4", "single"]
        assert row["pods"] == 60 * 40 and row["keys"] == cs.run_config9("cpu", 60, 40, steady=0, sequential=False)["keys"]
        assert any(k[0] != "no-op" for k in row["keys"])
    else:
        a = cs.run_controller_e2e("cpu", 24)
        assert a["store"] == cs.run_controller_e2e("cpu", 24)["store"]
