"""Production-shaped pod streams: the scenario half of the traffic
generator.

Counterpart of the scenario model of
``karpenter_core_tpu/serving/trafficgen.py`` (``PodSpecLite``, ``Step``,
``Scenario``, the ``scenario_*`` generators, ``build_scenario``,
``_catalog``, ``materialize_spec``). Scenarios are pure data, each
deterministic given its seed, materialized to Pod objects when a driver
injects them:

  rollout      — deployment rollouts: team-by-team waves replace pods
                 with a new revision whose requests differ
  spot_storm   — a spot-interruption storm: a large slice of BOUND pods
                 evicted at once and re-created pending
  cascade      — cascading evictions: waves of growing size (5→10→20%)
  diurnal      — arrival-rate ramp up and back down
  churn10x     — half the fleet swapped per step, concentrated on a few
                 teams, with periodic catalog price mutation
  restart_wave — steady redeploy churn: each wave re-creates one team's
                 shapes under fresh names

The harness half replays them through the serving pipeline: a
``TrafficHarness`` per run (kube + cluster + provider + provisioner on
``device`` + a kubelet binder), the lockstep and free drivers, the
kill-the-process-mid-stream drivers and the CLI
(``python -m karpenter_core_tpu_torch.serving.trafficgen``; ``--device
cpu`` for the plain versions). Two drive modes:

  lockstep — scenario steps are the batch boundaries (inject, release,
             quiesce). Runs through the pipeline AND the sequential
             loop; the canonical plan streams must be byte-identical
             (the overlap-safety gate).
  free     — events paced on the wall clock, batches form by window:
             the decision-latency SLO measurement.

The chaos pack (``run_chaos``, ``--chaos FAULT``) drives a scenario in
lockstep through the pipeline with one fault kind injected from a seeded
schedule (``--chaos none``: the clean twin whose plan hash a faulted
run's must equal). The fleet mode (``run_fleet_measurement``, ``--fleet
N --engine batched|solo``) drives N independent tenant streams of one
scenario through a ``FleetScheduler`` on one device; its plan hash is
equal across engines and devices.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..apis import labels as wk
from ..apis.nodeclaim import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
)
from ..apis.nodepool import NodePool
from ..cloudprovider.fake import FakeCloudProvider, new_instance_type
from ..events import Recorder
from ..kube.client import KubeClient
from ..kube.objects import (
    Condition,
    Container,
    Node,
    NodeSelectorRequirement,
    Pod,
    PodCondition,
    PodSpec,
    ResourceRequirements,
)
from ..kube.quantity import parse_quantity
from ..metrics import Metrics
from ..provisioning import Provisioner
from ..state.cluster import Cluster
from ..state.informers import Informers
from .pipeline import PipelineConfig, SequentialLoop, ServingPipeline

_CPUS = ["100m", "250m", "500m", "1", "2", "4"]
_MEMS = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"]


# ---------------------------------------------------------------------------
# scenario model: pure data, materialized to Pod objects at injection time
# so two runs of the same scenario inject identical streams


@dataclass(frozen=True)
class PodSpecLite:
    name: str
    cpu: str
    mem: str
    gpu: Optional[str]
    team: int


@dataclass
class Step:
    creates: List[PodSpecLite] = field(default_factory=list)
    # names of live pods to evict: delete (bound or not) and re-create
    # pending under a fresh name with the same shape
    evicts: List[str] = field(default_factory=list)
    # names of live pods to delete outright (scale-down)
    deletes: List[str] = field(default_factory=list)
    mutate_catalog: bool = False


@dataclass
class Scenario:
    name: str
    seed: int
    teams: int
    steps: List[Step]

    @property
    def total_creates(self) -> int:
        return sum(len(s.creates) for s in self.steps)


class _NameGen:
    def __init__(self, scenario: str):
        self.scenario = scenario
        self.n = 0

    def next(self) -> str:
        self.n += 1
        return f"{self.scenario}-p{self.n:06d}"


def _mk_spec(names: _NameGen, rng, team: int, rev: int = 0) -> PodSpecLite:
    """One pod shape. ``rev`` models a deployment revision: real
    rollouts ship new resource requests, so each revision's sizes are a
    fresh request quantum — fresh signatures the encoder has never seen
    (what keeps 10×-churn from degenerating into an all-cached replay)."""
    cpu_m = [100, 250, 500, 1000, 2000, 4000][rng.randint(6)] + (rev % 97)
    mem_mi = [128, 512, 1024, 2048, 4096][rng.randint(5)] + (rev % 97)
    return PodSpecLite(
        name=names.next(),
        cpu=f"{cpu_m}m",
        mem=f"{mem_mi}Mi",
        gpu="1" if rng.rand() < 0.1 else None,
        team=team,
    )


class _LivePods:
    """Scenario-construction-time mirror of which pods are alive, so
    evict/delete selections are deterministic data, not runtime
    choices."""

    def __init__(self):
        self.by_name: Dict[str, PodSpecLite] = {}

    def add(self, specs: List[PodSpecLite]) -> None:
        for s in specs:
            self.by_name[s.name] = s

    def remove(self, names: List[str]) -> None:
        for n in names:
            self.by_name.pop(n, None)

    def pick(self, rng, frac: float, teams: Optional[List[int]] = None) -> List[PodSpecLite]:
        pool = sorted(self.by_name)
        if teams is not None:
            tset = set(teams)
            pool = [n for n in pool if self.by_name[n].team in tset]
        k = max(1, int(len(pool) * frac)) if pool else 0
        if not k:
            return []
        idx = rng.choice(len(pool), size=min(k, len(pool)), replace=False)
        return [self.by_name[pool[i]] for i in sorted(idx)]

    def pick_concentrated(self, rng, count: int, teams: List[int]) -> List[PodSpecLite]:
        """``count`` pods, drawn from ``teams`` first and spilling
        uniformly once those are exhausted (a deployment-rollout shape
        at rates the hit teams alone can't supply)."""
        tset = set(teams)
        pool = sorted(self.by_name)
        hit = [n for n in pool if self.by_name[n].team in tset]
        rest = [n for n in pool if self.by_name[n].team not in tset]
        chosen = hit[:count]
        short = count - len(chosen)
        if short > 0 and rest:
            idx = rng.choice(len(rest), size=min(short, len(rest)), replace=False)
            chosen += [rest[i] for i in sorted(idx)]
        return [self.by_name[n] for n in chosen]


def _base_steps(names: _NameGen, live: _LivePods, rng, n_pods: int, teams: int) -> Step:
    specs = [_mk_spec(names, rng, t % teams) for t in range(n_pods)]
    live.add(specs)
    return Step(creates=specs)


def scenario_rollout(scale: int = 1000, teams: int = 10, seed: int = 101, waves: int = 8) -> Scenario:
    rng = np.random.RandomState(seed)
    names = _NameGen("rollout")
    live = _LivePods()
    steps = [_base_steps(names, live, rng, scale, teams)]
    for w in range(waves):
        team = int(w % teams)
        old = live.pick(rng, 1.0, teams=[team])
        # the new revision: same team, revision-bumped sizes (a fresh
        # request shape per wave is what a real image+resources bump
        # looks like)
        new = [_mk_spec(names, rng, team, rev=w + 1) for _ in old]
        live.remove([s.name for s in old])
        live.add(new)
        steps.append(Step(creates=new, evicts=[s.name for s in old]))
    return Scenario("rollout", seed, teams, steps)


def scenario_spot_storm(scale: int = 1000, teams: int = 10, seed: int = 102) -> Scenario:
    rng = np.random.RandomState(seed)
    names = _NameGen("spotstorm")
    live = _LivePods()
    steps = [_base_steps(names, live, rng, scale, teams)]
    # steady trickle, then the storm: 30% of the fleet interrupted at once
    for _ in range(2):
        trickle = [_mk_spec(names, rng, int(rng.randint(teams))) for _ in range(max(1, scale // 50))]
        live.add(trickle)
        steps.append(Step(creates=trickle))
    storm = live.pick(rng, 0.30)
    replacements = [_mk_spec(names, rng, s.team, rev=1) for s in storm]
    live.remove([s.name for s in storm])
    live.add(replacements)
    steps.append(Step(creates=replacements, evicts=[s.name for s in storm]))
    # recovery trickle
    trickle = [_mk_spec(names, rng, int(rng.randint(teams))) for _ in range(max(1, scale // 50))]
    live.add(trickle)
    steps.append(Step(creates=trickle))
    return Scenario("spot_storm", seed, teams, steps)


def scenario_cascade(scale: int = 1000, teams: int = 10, seed: int = 103) -> Scenario:
    rng = np.random.RandomState(seed)
    names = _NameGen("cascade")
    live = _LivePods()
    steps = [_base_steps(names, live, rng, scale, teams)]
    for i, frac in enumerate((0.05, 0.10, 0.20)):
        wave = live.pick(rng, frac)
        repl = [_mk_spec(names, rng, s.team, rev=i + 1) for s in wave]
        live.remove([s.name for s in wave])
        live.add(repl)
        steps.append(Step(creates=repl, evicts=[s.name for s in wave]))
    return Scenario("cascade", seed, teams, steps)


def scenario_diurnal(scale: int = 1000, teams: int = 10, seed: int = 104) -> Scenario:
    rng = np.random.RandomState(seed)
    names = _NameGen("diurnal")
    live = _LivePods()
    steps = []
    profile = [0.125, 0.25, 0.5, 1.0, 0.5, 0.25, 0.125]
    for load in profile:
        n = max(1, int(scale * load / 4))
        specs = [_mk_spec(names, rng, int(rng.randint(teams))) for _ in range(n)]
        live.add(specs)
        step = Step(creates=specs)
        # down-ramp: scale the oldest pods away
        if len(live.by_name) > scale and load < 1.0:
            victims = sorted(live.by_name)[: n // 2]
            live.remove(victims)
            step.deletes = victims
        steps.append(step)
    return Scenario("diurnal", seed, teams, steps)


def scenario_churn10x(
    scale: int = 1000, teams: int = 20, seed: int = 105, ticks: int = 10, churn: float = 0.5
) -> Scenario:
    """Config 7's churn shape at 10× its 5% rate: per step, ``churn`` of
    the WHOLE fleet swapped — concentrated on teams//10 teams, spilling
    uniformly beyond them (10× is more than two teams hold) — with
    catalog price mutation every 4th step."""
    rng = np.random.RandomState(seed)
    names = _NameGen("churn10x")
    live = _LivePods()
    steps = [_base_steps(names, live, rng, scale, teams)]
    for tick in range(ticks):
        if tick > 0 and tick % 4 == 0:
            # a spot-price storm: catalog mutation arrives as its own
            # event between churn waves (price feeds are asynchronous
            # to pod traffic — they never ride along with a rollout)
            steps.append(Step(mutate_catalog=True))
        hit = rng.choice(teams, max(1, teams // 10), replace=False)
        swap = live.pick_concentrated(
            rng, max(1, int(len(live.by_name) * churn)), [int(t) for t in hit]
        )
        repl = [_mk_spec(names, rng, s.team, rev=tick + 1) for s in swap]
        live.remove([s.name for s in swap])
        live.add(repl)
        steps.append(Step(creates=repl, evicts=[s.name for s in swap]))
    return Scenario("churn10x", seed, teams, steps)


def scenario_restart_wave(
    scale: int = 800, teams: int = 10, seed: int = 106, waves: int = 12
) -> Scenario:
    """Config-7-shaped steady redeploy churn for the restart scenario:
    each wave rolls one team — evict its live pods, re-create
    the SAME shape multiset under fresh names (steady replicas of a
    stable deployment, the common production case; rollout's per-wave
    revision bumps model the rarer size-changing deploy). Shapes are
    drawn per (seed, team), so a wave's request matrices are
    content-identical to that team's earlier waves — exactly the content
    a restarted process's restored job memos can serve. One catalog
    price mutation early in the run keeps the snapshotted world honest
    (the snapshot must reflect post-mutation prices)."""
    rng = np.random.RandomState(seed)
    names = _NameGen("restart")
    live = _LivePods()

    def team_shapes(team: int, count: int) -> List[tuple]:
        trng = np.random.RandomState(seed * 1009 + team)
        return [
            (
                f"{[100, 250, 500, 1000, 2000, 4000][trng.randint(6)]}m",
                f"{[128, 512, 1024, 2048, 4096][trng.randint(5)]}Mi",
                "1" if trng.rand() < 0.1 else None,
            )
            for _ in range(count)
        ]

    per_team = max(1, scale // teams)
    base: List[PodSpecLite] = []
    for t in range(teams):
        base.extend(
            PodSpecLite(names.next(), cpu, mem, gpu, t)
            for cpu, mem, gpu in team_shapes(t, per_team)
        )
    live.add(base)
    steps = [Step(creates=base)]
    for w in range(waves):
        if w == 1:
            steps.append(Step(mutate_catalog=True))
        team = int(w % teams)
        old = live.pick(rng, 1.0, teams=[team])
        new = [
            PodSpecLite(names.next(), cpu, mem, gpu, team)
            for cpu, mem, gpu in team_shapes(team, len(old))
        ]
        live.remove([s.name for s in old])
        live.add(new)
        steps.append(Step(creates=new, evicts=[s.name for s in old]))
    return Scenario("restart_wave", seed, teams, steps)


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "rollout": scenario_rollout,
    "spot_storm": scenario_spot_storm,
    "cascade": scenario_cascade,
    "diurnal": scenario_diurnal,
    "churn10x": scenario_churn10x,
    "restart_wave": scenario_restart_wave,
}


def build_scenario(name: str, scale: int = 1000, seed: Optional[int] = None) -> Scenario:
    fn = SCENARIOS[name]
    return fn(scale=scale) if seed is None else fn(scale=scale, seed=seed)


# ---------------------------------------------------------------------------
# the harness's catalog and pod materialization


def _catalog(n_types: int) -> List:
    cat = [
        new_instance_type(
            f"st-{i}",
            {"cpu": str((i % 64) + 1), "memory": f"{2 * ((i % 64) + 1)}Gi", "pods": "110"},
        )
        for i in range(max(1, n_types - 8))
    ]
    for g in range(min(8, n_types)):
        cat.append(
            new_instance_type(
                f"st-gpu-{g}",
                {
                    "cpu": str(8 * (g + 1)),
                    "memory": f"{16 * (g + 1)}Gi",
                    "pods": "110",
                    "nvidia.com/gpu": str(min(8, g + 1)),
                },
            )
        )
    return cat


def materialize_spec(spec: PodSpecLite) -> Pod:
    """A pending Pod from one scenario spec."""
    pod = Pod()
    pod.metadata.name = spec.name
    pod.metadata.labels = {"team": f"t{spec.team}"}
    requests = {"cpu": parse_quantity(spec.cpu), "memory": parse_quantity(spec.mem)}
    if spec.gpu:
        requests["nvidia.com/gpu"] = parse_quantity(spec.gpu)
    pod.spec = PodSpec(
        node_selector={"team": f"t{spec.team}"},
        containers=[
            Container(name="main", resources=ResourceRequirements(requests=requests))
        ],
    )
    pod.status.conditions = [
        PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
    ]
    return pod


class TrafficHarness:
    """One self-contained serving world. Create one per run — plan
    identity is compared across runs, so runs must not share mutable
    state (each gets its own provider, and with it its own warm-state
    entry).

    ``restore`` (a ``dump_state()`` payload from a killed process)
    rebuilds the apiserver world instead of starting empty: objects
    re-create in store order so informers rebuild identical cluster
    state, name/claim sequences fast-forward, and pods re-enter WITHOUT
    their ``_karp_memo`` — a restarted process reads pods from the
    apiserver, and the old process's interned ids must never leak into
    the new interner's id space.

    ``device`` is the batched solve's (None: the card), passed to the
    provisioner and every scheduler the harness builds."""

    def __init__(
        self,
        teams: int = 20,
        n_types: int = 96,
        metrics: Optional[Metrics] = None,
        restore: Optional[dict] = None,
        device=None,
    ):
        self.device = device
        self.kube = KubeClient()
        self.provider = FakeCloudProvider()
        self.provider.instance_types = (
            list(restore["catalog"]) if restore is not None else _catalog(n_types)
        )
        self.provider.bump_catalog_generation()  # harness owns invalidation
        self.cluster = Cluster(self.kube, self.provider)
        self.informers = Informers(self.kube, self.cluster)
        self.informers.start()
        self.recorder = Recorder(self.kube)
        self.metrics = metrics or Metrics()
        if restore is None:
            self.nodepool = NodePool()
            self.nodepool.metadata.name = "default"
            self.nodepool.spec.template.requirements = [
                NodeSelectorRequirement("team", "In", [f"t{t}" for t in range(teams)])
            ]
            self.kube.create(self.nodepool)
        else:
            from ..kube.objects import resume_name_sequence
            from ..solver import podcache

            for kind, obj in restore["objects"]:
                if kind == "Pod":
                    obj.__dict__.pop("_karp_memo", None)
                self.kube.create(obj)
            self.nodepool = self.kube.get("NodePool", "default")
            resume_name_sequence(restore["name_mark"])
            # the memo maps must be empty (fresh-interpreter contract):
            # any surviving memo would carry the dead process's ids
            podcache.reset()
        self.provisioner = Provisioner(
            self.kube,
            self.provider,
            self.cluster,
            recorder=self.recorder,
            use_tpu_solver=True,
            metrics=self.metrics,
            device=device,
        )
        self._node_seq = restore["node_seq"] if restore is not None else 0
        # catalog-event fanout: the serving pipeline's catalog ingest
        # (observe_catalog_event), wired per run mode
        self.on_catalog_event: Optional[Callable[[], None]] = None
        # arrival bookkeeping for the parity test: pod uid -> (name, step)
        self.arrivals: Dict[str, Tuple[str, int]] = {}
        self.uid_to_name: Dict[str, str] = {}
        self._live: Dict[str, Pod] = {}  # name -> live Pod object
        if restore is not None:
            self.arrivals = {u: tuple(v) for u, v in restore["arrivals"].items()}
            self.uid_to_name = dict(restore["uid_to_name"])
            for name in restore["live_names"]:
                pod = self.kube.get("Pod", name)
                if pod is not None:
                    self._live[name] = pod

    def dump_state(self) -> dict:
        """Serialize the apiserver world + harness bookkeeping for a
        process handoff (the kill-the-process-mid-stream scenario): the
        durable state a real restart would re-read from the apiserver
        and the cloud provider, nothing from the solver's memory."""
        from ..kube.objects import name_sequence_mark

        objects = []
        # claims before their nodes, nodes before the pods bound to them
        # — re-creation replays the live flow's event order
        for kind in ("NodePool", "DaemonSet", "NodeClaim", "Node", "Pod"):
            for obj in self.kube.list(kind):
                objects.append((kind, obj))
        return {
            "version": 1,
            "objects": objects,
            "catalog": list(self.provider.instance_types),
            "node_seq": self._node_seq,
            "name_mark": name_sequence_mark(),
            "arrivals": {u: list(v) for u, v in self.arrivals.items()},
            "uid_to_name": dict(self.uid_to_name),
            "live_names": sorted(self._live),
        }

    # -- injection ----------------------------------------------------------

    def _materialize(self, spec: PodSpecLite) -> Pod:
        return materialize_spec(spec)

    def inject_step(self, step: Step, step_index: int) -> None:
        """Apply one scenario step to the kube store (deletes/evictions
        first — the replacements in ``creates`` arrive after the
        interruption, like real controllers re-creating pods)."""
        for name in step.deletes:
            pod = self._live.pop(name, None)
            if pod is not None:
                self.kube.delete(pod)
        for name in step.evicts:
            pod = self._live.pop(name, None)
            if pod is not None:
                self.kube.delete(pod)
        if step.mutate_catalog:
            its = self.provider.get_instance_types(self.nodepool)
            for it in its[:: max(1, len(its) // 16)]:
                for o in it.offerings:
                    o.price *= 1.01
            self.provider.bump_catalog_generation()
            if self.on_catalog_event is not None:
                self.on_catalog_event()
        for spec in step.creates:
            pod = self._materialize(spec)
            self.kube.create(pod)
            self._live[spec.name] = pod
            self.uid_to_name[pod.uid] = spec.name
            self.arrivals[pod.uid] = (spec.name, step_index)

    # -- kubelet binder (the on_decision hook) -------------------------------

    def bind(self, tick: int, results) -> None:
        """Complete each emitted plan's lifecycle synchronously on the
        authoritative thread: launch the claim, join its node, bind the
        pods — so the next tick's pending listing is exactly 'everything
        not yet decided', in both pipeline and sequential modes."""
        for plan in getattr(results, "tpu_plans", []) or []:
            name = getattr(plan, "created_claim_name", None)
            if not name:
                continue
            self._launch_and_bind(name, plan.instance_type, plan.zone, plan.capacity_type, plan.pods)
        for claim in results.new_node_claims:
            name = getattr(claim, "created_claim_name", None)
            if not name or not claim.instance_type_options:
                continue
            it = claim.instance_type_options[0]
            off = it.offerings.available()
            zone = off[0].zone if off else "test-zone-1"
            ct = off[0].capacity_type if off else wk.CAPACITY_TYPE_ON_DEMAND
            self._launch_and_bind(name, it, zone, ct, claim.pods)
        for plan in getattr(results, "existing_plans", []) or []:
            self._bind_pods(plan.state_node.name(), getattr(plan, "pods", []) or [])
        for ex in results.existing_nodes:
            self._bind_pods(ex.state_node.name(), ex.pods)

    def _launch_and_bind(self, claim_name: str, it, zone: str, ct: str, pods) -> None:
        nc = self.kube.get("NodeClaim", claim_name)
        if nc is None:
            return
        self._node_seq += 1
        provider_id = f"fake:///serve-{self._node_seq:06d}"
        nc.status.provider_id = provider_id
        nc.status.capacity = dict(it.capacity)
        nc.status.allocatable = it.allocatable()
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            nc.set_condition(cond, "True")
        self.kube.update(nc)
        node = Node()
        node.metadata.name = f"node-{claim_name}"
        node.metadata.labels = {
            **nc.metadata.labels,
            wk.LABEL_INSTANCE_TYPE: it.name,
            wk.LABEL_TOPOLOGY_ZONE: zone,
            wk.CAPACITY_TYPE_LABEL_KEY: ct,
            wk.LABEL_HOSTNAME: f"node-{claim_name}",
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.NODE_INITIALIZED_LABEL_KEY: "true",
        }
        node.spec.provider_id = provider_id
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = it.allocatable()
        node.status.conditions = [Condition(type="Ready", status="True")]
        self.kube.create(node)
        self._bind_pods(node.metadata.name, pods)

    def _bind_pods(self, node_name: str, pods) -> None:
        for pod in pods:
            pod.spec.node_name = node_name
            pod.status.phase = "Running"
            pod.status.conditions = []
            self.kube.apply(pod)

    def warmup(self) -> None:
        """Pay one-time costs (kernel library loads, catalog encode)
        outside the measured window."""
        from ..solver import TorchScheduler

        warm_pod = self._materialize(PodSpecLite("warmup-0", "250m", "256Mi", None, 0))
        TorchScheduler([self.nodepool], self.provider, device=self.device).solve([warm_pod])

    def warmup_compile_only(
        self, n_pods: int = 64, pay_compiles: bool = True
    ) -> Optional[dict]:
        """Device warmup that does NOT touch this harness's catalog
        entry: the restart phases measure the first post-restart solve,
        and the catalog re-encode is exactly the cold cost the warm-state
        snapshot exists to skip — warming it here would flatter the cold
        baseline. A content-DISJOINT throwaway catalog of the same size
        (fresh names → fresh fingerprint → its own cache entry) pays the
        CUDA context, one solve's first launches, and then
        ``solver.prewarm.warmup_compile_only`` (the kernel libraries and,
        on the card, the LP calibration) — the same code the serving
        pipeline's boot prewarm runs, so bench lanes and the production
        boot path cannot drift. → the prewarm outcome.

        ``pay_compiles=False`` (the cold-resume lane) only initialises
        CUDA, when the harness runs on the card, and leaves the library
        loads and first launches to the first measured solve, as a real
        unsnapshot restart pays them. → None."""
        from ..apis.nodepool import NodePool as _NodePool
        from ..solver import TorchScheduler, prewarm
        from ..solver.backend import init_cuda

        if not pay_compiles:
            init_cuda(self.device)
            return None
        provider = FakeCloudProvider()
        warm_cat = _catalog(len(self.provider.instance_types))
        for it in warm_cat:
            it.name = f"warm-{it.name}"
        provider.instance_types = warm_cat
        provider.bump_catalog_generation()
        np_ = _NodePool()
        np_.metadata.name = "warmup"
        pods = []
        for i in range(max(1, n_pods)):
            pod = self._materialize(
                PodSpecLite(f"warmup-{i}", _CPUS[i % len(_CPUS)], _MEMS[i % len(_MEMS)], None, 0)
            )
            pod.spec.node_selector = {}
            pods.append(pod)
        sched = TorchScheduler([np_], provider, device=self.device)
        sched.solve(pods)
        return prewarm.warmup_compile_only(sched)

    def close(self) -> None:
        self.informers.stop()


# ---------------------------------------------------------------------------
# runners


@dataclass
class RunResult:
    mode: str
    scenario: str
    plan_stream: List[tuple] = field(default_factory=list)  # per non-empty tick
    decisions: List[Tuple[int, str]] = field(default_factory=list)  # (tick, pod name)
    arrivals: Dict[str, int] = field(default_factory=dict)  # pod name -> step
    latency_ms: dict = field(default_factory=dict)
    samples_ms: List[float] = field(default_factory=list)
    # steady-phase slice: pods that arrived AFTER the initial base-load
    # step — the cold ramp is a restart artifact, the SLO is steady state
    steady_samples_ms: List[float] = field(default_factory=list)
    wall_s: float = 0.0
    ticks: int = 0
    pods_decided: int = 0
    errors: int = 0
    stage_stats: dict = field(default_factory=dict)

    def plan_bytes(self) -> bytes:
        """The byte-identity witness: the canonical plan stream,
        serialized."""
        return repr(self.plan_stream).encode()


def _canon_results(harness: TrafficHarness, results) -> Optional[tuple]:
    """Canonical, run-comparable identity of one tick's emitted plans
    (pods keyed by name — uids differ across runs)."""
    plans = []
    for plan in getattr(results, "tpu_plans", []) or []:
        if not getattr(plan, "created_claim_name", None):
            continue
        plans.append(
            (
                plan.nodepool_name,
                plan.instance_type.name,
                plan.zone,
                plan.capacity_type,
                round(plan.price, 9),
                tuple(sorted(p.metadata.name for p in plan.pods)),
            )
        )
    for claim in results.new_node_claims:
        if not getattr(claim, "created_claim_name", None):
            continue
        plans.append(
            (
                claim.nodepool_name,
                "oracle",
                tuple(sorted(p.metadata.name for p in claim.pods)),
            )
        )
    for plan in getattr(results, "existing_plans", []) or []:
        pods = getattr(plan, "pods", []) or []
        plans.append(("existing", plan.state_node.name(), tuple(sorted(p.metadata.name for p in pods))))
    errors = tuple(
        sorted(harness.uid_to_name.get(uid, uid) for uid in results.pod_errors)
    )
    if not plans and not errors:
        return None
    return (tuple(sorted(plans)), errors)


class _StreamRecorder:
    """Wraps the harness binder to also record the canonical plan
    stream in emit order (it runs on the authoritative thread, so the
    stream order IS the observable emit order)."""

    def __init__(self, harness: TrafficHarness):
        self.harness = harness
        self.stream: List[tuple] = []
        self.decision_ticks: List[Tuple[int, str]] = []

    def __call__(self, tick: int, results) -> None:
        canon = _canon_results(self.harness, results)
        if canon is not None:
            self.stream.append(canon)
            for plan_key in canon[0]:
                for pod_name in plan_key[-1]:
                    self.decision_ticks.append((tick, pod_name))
        self.harness.bind(tick, results)


def _finalize_result(
    rr: RunResult, harness: TrafficHarness, rec: _StreamRecorder, latency, wall_s: float
) -> RunResult:
    rr.plan_stream = rec.stream
    rr.decisions = rec.decision_ticks
    rr.arrivals = {name: step for (name, step) in harness.arrivals.values()}
    rr.latency_ms = latency.percentiles()
    rr.samples_ms = latency.samples_ms()
    rr.steady_samples_ms = [
        lat * 1000.0
        for (uid, lat, _step, _tick, _err) in latency.decisions()
        if harness.arrivals.get(uid, ("", 0))[1] >= 1
    ]
    rr.wall_s = round(wall_s, 3)
    rr.pods_decided = latency.decided_count()
    rr.errors = sum(1 for d in latency.decisions() if d[4])
    return rr


def run_lockstep(
    scenario: Scenario,
    mode: str = "pipeline",
    teams: Optional[int] = None,
    config: Optional[PipelineConfig] = None,
    quiesce_timeout: float = 60.0,
    device=None,
) -> RunResult:
    """Drive the scenario with steps as batch boundaries; plans recorded
    per tick. Pipeline mode runs with full stage concurrency (prewarm
    racing the authoritative solve) — only the batch boundary is
    pinned. ``device``: the solves' (None: the card)."""
    harness = TrafficHarness(teams=teams or scenario.teams, device=device)
    rec = _StreamRecorder(harness)
    config = config or PipelineConfig(
        idle_seconds=0.02, max_seconds=1.0, solve_queue_cap=1, telemetry_queue_cap=1024
    )
    rr = RunResult(mode=mode, scenario=scenario.name)
    harness.warmup()
    t0 = time.perf_counter()
    if mode == "pipeline":
        pipe = ServingPipeline(
            harness.provisioner, metrics=harness.metrics, config=config, on_decision=rec
        )
        harness.on_catalog_event = pipe.observe_catalog_event
        pipe.attach_watch()
        pipe.hold()
        pipe.start()
        try:
            for i, step in enumerate(scenario.steps):
                harness.inject_step(step, i)
                pipe.release()
                if not pipe.quiesce(timeout=quiesce_timeout):
                    raise TimeoutError(
                        f"pipeline failed to quiesce at step {i} of {scenario.name}"
                    )
                pipe.hold()
            latency = pipe.latency
            rr.ticks = pipe.ticks()
            rr.stage_stats = pipe.debug_state()
        finally:
            pipe.stop()
    elif mode == "sequential":
        loop = SequentialLoop(
            harness.provisioner, metrics=harness.metrics, config=config, on_decision=rec
        )
        loop.attach_watch()
        try:
            for i, step in enumerate(scenario.steps):
                harness.inject_step(step, i)
                loop.step_once()
            latency = loop.latency
            rr.ticks = loop.ticks()
        finally:
            loop.stop()
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = _finalize_result(rr, harness, rec, latency, time.perf_counter() - t0)
    harness.close()
    return out


def monotonic_decision_order(rr: RunResult) -> bool:
    """The ordering witness: emitted decisions carry non-decreasing tick
    ordinals (the authoritative thread never reorders observable
    state), and no pod is decided twice."""
    last = 0
    seen = set()
    for tick, name in rr.decisions:
        if tick < last or name in seen:
            return False
        last = tick
        seen.add(name)
    return True


def run_free(
    scenario: Scenario,
    mode: str = "pipeline",
    pace_s: float = 0.05,
    teams: Optional[int] = None,
    config: Optional[PipelineConfig] = None,
    drain_timeout: float = 120.0,
    device=None,
) -> RunResult:
    """Free-running mode: steps injected on a wall-clock pace while the
    serving loop forms its own batches — the decision-latency SLO
    measurement. Identical config for both modes keeps the comparison
    honest (the pipeline's edge is overlap, not a smaller window). Plan
    identity is a lockstep property only: here batches form by window.
    ``device``: the solves' (None: the card)."""
    harness = TrafficHarness(teams=teams or scenario.teams, device=device)
    rec = _StreamRecorder(harness)
    config = config or PipelineConfig(
        idle_seconds=0.02, max_seconds=0.5, solve_queue_cap=1, telemetry_queue_cap=1024
    )
    rr = RunResult(mode=mode, scenario=scenario.name)
    harness.warmup()
    if mode == "pipeline":
        serve = ServingPipeline(
            harness.provisioner, metrics=harness.metrics, config=config, on_decision=rec
        )
        harness.on_catalog_event = serve.observe_catalog_event
    elif mode == "sequential":
        serve = SequentialLoop(
            harness.provisioner, metrics=harness.metrics, config=config, on_decision=rec
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")
    serve.attach_watch()
    serve.start()
    t0 = time.perf_counter()
    try:
        for i, step in enumerate(scenario.steps):
            harness.inject_step(step, i)
            if pace_s:
                time.sleep(pace_s)
        # drain: every injected pod decided (or the timeout names the jam)
        deadline = time.monotonic() + drain_timeout
        while time.monotonic() < deadline:
            if serve.latency.pending_count() == 0:
                break
            time.sleep(0.005)
        rr.ticks = serve.ticks()
        if hasattr(serve, "debug_state"):
            rr.stage_stats = serve.debug_state()
        latency = serve.latency
    finally:
        serve.stop()
    out = _finalize_result(rr, harness, rec, latency, time.perf_counter() - t0)
    harness.close()
    return out


# ---------------------------------------------------------------------------
# kill-the-process-mid-stream: snapshot on quiesce, restart
# subprocess, restore, resume the stream. The kill phase and each resume
# phase run in their OWN processes (the config-8 pyperf discipline —
# a resumed process must inherit nothing but the handoff + snapshot
# files); plan streams concatenate across the kill point and must hash
# identical to an unkilled reference run.


def _restart_config() -> PipelineConfig:
    # prewarm off: the measurement is the FIRST authoritative solve
    # after restart — a racing speculative encode would warm the caches
    # between release and solve and blur the cold/warm contrast (plan
    # identity is unaffected either way). The boot prewarm is NOT this
    # knob: it runs only after a restore (part of the warm path under
    # measurement); the cold lane's measured first solve pays the
    # library loads (warmup_compile_only(pay_compiles=False): CUDA
    # init only).
    return PipelineConfig(
        idle_seconds=0.02, max_seconds=1.0, solve_queue_cap=1,
        telemetry_queue_cap=1024, prewarm=False,
        warmstore_dir=None, warmstore_restore=None,
    )


def _drive_steps(pipe, harness, steps, first_index, quiesce_timeout):
    """Lockstep-drive ``steps`` through a held pipeline; returns the
    per-solve tick records (step_ms/solve_host_ms of ticks that decided
    pods) and the last quiesce() return (the snapshot path when the
    pipeline's warmstore_dir is set for the final step)."""
    solve_ticks: List[dict] = []
    seen = set()
    out = True
    for i, step in enumerate(steps):
        harness.inject_step(step, first_index + i)
        pipe.release()
        out = pipe.quiesce(timeout=quiesce_timeout)
        if not out:
            raise TimeoutError(f"pipeline failed to quiesce at resumed step {first_index + i}")
        pipe.hold()
        for tick_rec in pipe.debug_state()["last_ticks"]:
            if tick_rec.get("tick") in seen:
                continue
            seen.add(tick_rec.get("tick"))
            if tick_rec.get("decided", 0) > 0:
                solve_ticks.append(
                    {
                        "tick": tick_rec.get("tick"),
                        "step_ms": tick_rec.get("step_ms", 0.0),
                        "solve_host_ms": tick_rec.get("solve_host_ms", 0.0),
                        "solve_device_ms": tick_rec.get("solve_device_ms", 0.0),
                        "solve_compiles": tick_rec.get("solve_compiles"),
                    }
                )
    return solve_ticks, out


def run_restart_kill(
    scenario_name: str,
    kill_step: int,
    workdir: str,
    scale: int = 800,
    seed: Optional[int] = None,
    teams: Optional[int] = None,
    n_types: int = 480,
    quiesce_timeout: float = 120.0,
    device=None,
) -> dict:
    """Phase A of the kill scenario: drive steps [0, kill_step) through
    a serving pipeline on ``device`` (None: the card), quiesce (which
    snapshots the warm planes and returns the snapshot path), dump the
    apiserver world + partial plan stream to ``workdir/handoff.pkl`` (a
    pickle of the port's objects), and return a summary. The caller
    then EXITS — everything the resumed process may use is on disk."""
    sc = build_scenario(scenario_name, scale=scale, seed=seed)
    if not 0 < kill_step < len(sc.steps):
        raise ValueError(f"kill_step must be in (0, {len(sc.steps)}), got {kill_step}")
    harness = TrafficHarness(teams=teams or sc.teams, n_types=n_types, device=device)
    rec = _StreamRecorder(harness)
    pipe = ServingPipeline(
        harness.provisioner, metrics=harness.metrics, config=_restart_config(),
        on_decision=rec,
    )
    harness.on_catalog_event = pipe.observe_catalog_event
    harness.warmup_compile_only()
    pipe.attach_watch()
    pipe.hold()
    pipe.start()
    try:
        solve_ticks, _ = _drive_steps(
            pipe, harness, sc.steps[: kill_step - 1], 0, quiesce_timeout
        )
        # final pre-kill step: arm the snapshot — quiesce() returns the
        # snapshot path (the satellite contract: no side channel needed
        # to hand the restarted process its warm state)
        pipe.config.warmstore_dir = workdir
        last_ticks, path = _drive_steps(
            pipe, harness, [sc.steps[kill_step - 1]], kill_step - 1, quiesce_timeout
        )
        solve_ticks.extend(last_ticks)
        snapshot_path = path if isinstance(path, str) else None
    finally:
        pipe.stop()
    steady = [t["step_ms"] for t in solve_ticks[1:]] or [t["step_ms"] for t in solve_ticks]
    handoff = harness.dump_state()
    handoff.update(
        scenario=scenario_name, scale=scale, seed=sc.seed, teams=teams or sc.teams,
        n_types=n_types, kill_step=kill_step, device=str(device or "cuda"),
        plan_stream=rec.stream, decision_ticks=rec.decision_ticks,
        snapshot_path=snapshot_path,
        steady_step_ms_p50=float(np.median(steady)) if steady else 0.0,
    )
    handoff_path = os.path.join(workdir, "handoff.pkl")
    import pickle

    with open(handoff_path, "wb") as f:
        pickle.dump(handoff, f, protocol=4)
    harness.close()
    return {
        "phase": "kill",
        "scenario": scenario_name,
        "kill_step": kill_step,
        "steps_driven": kill_step,
        "snapshot_path": snapshot_path,
        "handoff_path": handoff_path,
        "plans_emitted": len(rec.stream),
        "steady_step_ms_p50": handoff["steady_step_ms_p50"],
    }


def run_restart_resume(
    handoff_path: str,
    restore: bool = True,
    quiesce_timeout: float = 120.0,
    device=None,
) -> dict:
    """Phase B: rebuild the world from the handoff (the durable state a
    restarted operator re-reads), restore the warm-state snapshot
    (``restore=False`` = the unsnapshot cold-restart baseline), resume
    the stream from the kill step on ``device`` (None: the card), and
    report the full-stream plan hash plus the post-restart warm-up
    trajectory. A snapshot restored on another device than the one
    that wrote it (the handoff's ``device``) keeps its host planes and
    drops its device-computed ones, counted in ``warmstore``.
    ``first_solve_compiles``: the device plane's compile events (library
    loads) of the first authoritative solve."""
    import hashlib
    import pickle

    with open(handoff_path, "rb") as f:
        handoff = pickle.load(f)
    sc = build_scenario(handoff["scenario"], scale=handoff["scale"], seed=handoff["seed"])
    kill_step = handoff["kill_step"]
    harness = TrafficHarness(
        teams=handoff["teams"] or sc.teams, n_types=handoff["n_types"], restore=handoff,
        device=device,
    )
    rec = _StreamRecorder(harness)
    pipe = ServingPipeline(
        harness.provisioner, metrics=harness.metrics, config=_restart_config(),
        on_decision=rec,
    )
    harness.on_catalog_event = pipe.observe_catalog_event
    snapshot_path = handoff.get("snapshot_path")
    # cold lane: CUDA init only — the measured first solve pays the
    # library loads and first launches a prewarmed process skips
    harness.warmup_compile_only(pay_compiles=bool(restore and snapshot_path))
    restore_ms = 0.0
    warmstore_outcome = None
    if restore and snapshot_path:
        # restore BEFORE the first tick (the pipeline hook); timed
        # separately so bench can report restore_ms on its own
        t0 = time.perf_counter()
        warmstore_outcome = pipe.restore_warm_state(snapshot_path)
        restore_ms = (time.perf_counter() - t0) * 1000.0
    pipe.attach_watch()
    pipe.hold()
    pipe.start()
    try:
        solve_ticks, _ = _drive_steps(
            pipe, harness, sc.steps[kill_step:], kill_step, quiesce_timeout
        )
        # boot prewarm outcome: settled by now — the plan thread's first
        # tick waited on the prewarm gate
        boot_replay = pipe.debug_state()["prewarm"].get("boot_replay")
    finally:
        pipe.stop()
    harness.close()
    full_stream = list(handoff["plan_stream"]) + list(rec.stream)
    steady_p50 = handoff.get("steady_step_ms_p50") or 0.0
    # warm-up trajectory: 1-indexed post-restart solve tick at which the
    # pipeline is back to the killed process's steady p50 (x1.5 + 2 ms
    # of jitter headroom); 0 = never within the driven window
    ticks_to_warm = 0
    for i, t in enumerate(solve_ticks):
        if steady_p50 and t["step_ms"] <= steady_p50 * 1.5 + 2.0:
            ticks_to_warm = i + 1
            break
    return {
        "phase": "resume",
        "mode": "warm" if (restore and snapshot_path) else "cold",
        "device": str(device or "cuda"),
        "snapshot_device": handoff.get("device"),
        "scenario": handoff["scenario"],
        "kill_step": kill_step,
        "restored": warmstore_outcome is not None,
        "restore_ms": round(restore_ms, 3),
        "warmstore": warmstore_outcome,
        "first_solve_ms": solve_ticks[0]["step_ms"] if solve_ticks else 0.0,
        "first_solve_host_ms": solve_ticks[0]["solve_host_ms"] if solve_ticks else 0.0,
        "first_solve_device_ms": solve_ticks[0]["solve_device_ms"] if solve_ticks else 0.0,
        # the device plane's compile events (library loads) of the first
        # authoritative solve: 0 once the boot prewarm loaded them
        "first_solve_compiles": solve_ticks[0].get("solve_compiles") if solve_ticks else None,
        # the boot prewarm's outcome (libraries, compile events, calibration, ms)
        "prewarm_ms": (boot_replay or {}).get("prewarm_ms", 0.0),
        "prewarm": boot_replay,
        "post_restart_step_ms": [round(t["step_ms"], 3) for t in solve_ticks],
        "steady_step_ms_p50": steady_p50,
        "ticks_to_warm": ticks_to_warm,
        "plans_emitted": len(full_stream),
        "plan_sha256": hashlib.sha256(repr(full_stream).encode()).hexdigest(),
    }


def run_restart_reference(
    scenario_name: str,
    scale: int = 800,
    seed: Optional[int] = None,
    teams: Optional[int] = None,
    n_types: int = 480,
    quiesce_timeout: float = 120.0,
    device=None,
) -> dict:
    """The unkilled oracle: the same scenario driven end to end in one
    process on ``device`` (None: the card), same pipeline config and
    harness shape as the kill/resume phases — its full-stream plan hash
    is what the concatenated killed-run stream must equal (byte identity
    across the kill point)."""
    import hashlib

    sc = build_scenario(scenario_name, scale=scale, seed=seed)
    harness = TrafficHarness(teams=teams or sc.teams, n_types=n_types, device=device)
    rec = _StreamRecorder(harness)
    pipe = ServingPipeline(
        harness.provisioner, metrics=harness.metrics, config=_restart_config(),
        on_decision=rec,
    )
    harness.on_catalog_event = pipe.observe_catalog_event
    harness.warmup_compile_only()
    pipe.attach_watch()
    pipe.hold()
    pipe.start()
    try:
        solve_ticks, _ = _drive_steps(pipe, harness, sc.steps, 0, quiesce_timeout)
    finally:
        pipe.stop()
    harness.close()
    return {
        "phase": "reference",
        "scenario": scenario_name,
        "steps": len(sc.steps),
        "plans_emitted": len(rec.stream),
        "plan_sha256": hashlib.sha256(repr(list(rec.stream)).encode()).hexdigest(),
        "solve_ticks": len(solve_ticks),
    }


def run_measurement(
    scenario: str,
    mode: str,
    drive: str,
    scale: int,
    pace: float,
    seed: Optional[int] = None,
    idle_s: float = 0.02,
    max_s: float = 0.5,
    device=None,
) -> dict:
    """One scenario × mode × drive measurement on ``device`` (None: the
    card) → plain-JSON summary (the subprocess payload)."""
    import hashlib

    from .latency import percentiles_ms

    sc = build_scenario(scenario, scale=scale, seed=seed)
    config = PipelineConfig(idle_seconds=idle_s, max_seconds=max_s)
    if drive == "lockstep":
        rr = run_lockstep(sc, mode=mode, config=config, device=device)
    elif drive == "free":
        rr = run_free(sc, mode=mode, pace_s=pace, config=config, device=device)
    else:
        raise ValueError(f"unknown drive {drive!r}")
    out = {
        "scenario": scenario,
        "mode": mode,
        "drive": drive,
        "device": str(device or "cuda"),
        "steps": len(sc.steps),
        "pods_injected": sc.total_creates,
        "ticks": rr.ticks,
        "pods_decided": rr.pods_decided,
        "pod_errors": rr.errors,
        "wall_s": rr.wall_s,
        "plans_emitted": len(rr.plan_stream),
        "plan_sha256": hashlib.sha256(rr.plan_bytes()).hexdigest(),
        "monotonic_decision_order": monotonic_decision_order(rr),
        "decision_latency_ms": percentiles_ms(rr.samples_ms),
        "steady_decision_latency_ms": percentiles_ms(rr.steady_samples_ms),
        "steady_samples": len(rr.steady_samples_ms),
        "pods_per_sec": round(rr.pods_decided / rr.wall_s, 1) if rr.wall_s else 0.0,
    }
    if rr.stage_stats:
        out["queues"] = rr.stage_stats.get("queues", {})
        out["prewarm"] = rr.stage_stats.get("prewarm", {})
        # flight-recorder health: timeline reconstruction coverage +
        # orphan spans over the whole run
        out["flightrec"] = rr.stage_stats.get("flightrec", {})
        from ..tracing import tracer as _tracer

        out["orphan_spans"] = _tracer.orphan_spans()
        agg: dict = {}
        for tick_rec in rr.stage_stats.get("last_ticks", []):
            agg["batch_wait"] = agg.get("batch_wait", 0.0) + tick_rec.get(
                "queue_wait_ms", 0.0
            )
            for k, v in tick_rec.get("phase_breakdown_ms", {}).items():
                agg[k] = agg.get(k, 0.0) + v
        out["stage_attribution_ms"] = {
            k: round(v, 2)
            for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:6]
        }
    return out


# ---------------------------------------------------------------------------
# chaos pack: the same lockstep drive, with a deterministic seeded fault
# schedule (kube/faults.py) applied at step boundaries over the in-memory
# apiserver. Every fault has a clean twin (fault="none", same
# scenario/seed) and the gate is plan identity between the two: a faulted
# run may DELAY decisions (held ticks) and INFLATE latency, but must emit
# the byte-identical plan stream. Degradation is hold + counter, never a
# stale or divergent plan.


CHAOS_FAULTS = ("watch_flap", "watch_hang", "latency_spike", "failover", "clock_skew")

# kind-specific magnitudes for the harness runs: latency in ms per
# NodeClaim admission, skew in seconds (one hour — an egregious NTP step)
_CHAOS_MAGNITUDES = {"latency_spike": 25.0, "clock_skew": 3600.0}
# the fault kinds whose degradation is a HELD tick, and which hold
# counter proves it
_HOLDING_FAULTS = {"watch_flap": "stale", "watch_hang": "stale", "failover": "leader"}


def _chaos_config(fault: str) -> PipelineConfig:
    cfg = PipelineConfig(
        idle_seconds=0.02, max_seconds=1.0, solve_queue_cap=1, telemetry_queue_cap=1024
    )
    if fault == "watch_hang":
        # the hang fault is detected by AGE, not by an explicit flag: no
        # watch delivery for > max_staleness_s ⇒ the world is stale
        cfg.max_staleness_s = 0.25
    return cfg


def run_chaos(
    scenario_name: str,
    fault: str = "none",
    scale: int = 600,
    seed: Optional[int] = None,
    teams: Optional[int] = None,
    quiesce_timeout: float = 120.0,
    hold_timeout: float = 10.0,
    device=None,
) -> dict:
    """One chaos measurement: drive ``scenario_name`` in lockstep
    through the serving pipeline with ``fault`` windows injected from a
    seeded FaultSchedule (``fault="none"`` = the clean twin). Returns
    the plan hash plus the degradation evidence:

    - ``held_ticks`` — ticks held by the stale-world guard / leader
      gate (the bounded degradation);
    - ``stale_plans_emitted`` — plans that appeared WHILE the guard
      held (must be 0: the no-stale-plan invariant, observed, not
      assumed);
    - ``single_writer_ok`` — no NodeClaim landed while deposed
      (failover windows);
    - p99 decision latency and flight-recorder SLO burn, with the
      fault window annotated on every record taken inside it.

    ``device``: the solves' (None: the card).
    """
    import hashlib

    from ..kube.faults import FaultSchedule
    from ..tracing import flightrec
    from .latency import percentiles_ms

    if fault != "none" and fault not in CHAOS_FAULTS:
        raise ValueError(f"unknown chaos fault {fault!r} (choices: {CHAOS_FAULTS})")
    sc = build_scenario(scenario_name, scale=scale, seed=seed)
    schedule = (
        FaultSchedule.build(
            f"chaos-{fault}", sc.seed, (fault,), len(sc.steps),
            magnitudes=_CHAOS_MAGNITUDES,
        )
        if fault != "none"
        else None
    )
    harness = TrafficHarness(teams=teams or sc.teams, device=device)
    rec = _StreamRecorder(harness)
    config = _chaos_config(fault)
    pipe = ServingPipeline(
        harness.provisioner, metrics=harness.metrics, config=config, on_decision=rec
    )
    harness.on_catalog_event = pipe.observe_catalog_event
    led = {"leading": True}
    pipe.attach_leader_gate(lambda: led["leading"])
    harness.warmup()
    pipe.attach_watch()
    pipe.hold()
    pipe.start()
    held_seen = pipe.held_ticks()
    stale_plans_emitted = 0
    writes_while_deposed = 0
    fault_steps: List[int] = []
    spike_guard = None
    skewed_clock = None
    rr = RunResult(mode="pipeline", scenario=sc.name)
    t0 = time.perf_counter()
    try:
        for i, step in enumerate(sc.steps):
            ev = schedule.active(i)[0] if schedule and schedule.active(i) else None
            if ev is not None:
                fault_steps.append(i)
                flightrec.set_fault_window(f"chaos_{fault}", fault, "active")
                if fault == "clock_skew" and skewed_clock is None:
                    # skew BEFORE injection so this window's object
                    # stamps carry the jumped wall clock — the plans
                    # must not care
                    base = harness.kube.clock
                    skewed_clock = base
                    harness.kube.clock = lambda _b=base, _m=ev.magnitude: _b() + _m
            elif skewed_clock is not None:
                # window over: the NTP step back (stamps jump backwards)
                harness.kube.clock = skewed_clock
                skewed_clock = None
            harness.inject_step(step, i)
            plans_before = len(rec.stream)
            claims_before = len(harness.kube.list("NodeClaim"))
            if ev is not None:
                if fault == "watch_flap":
                    pipe.set_world_stale(True)
                elif fault == "failover":
                    led["leading"] = False
                elif fault == "latency_spike" and spike_guard is None:
                    delay_s = max(0.0, ev.magnitude) / 1000.0

                    def _slow(obj, _d=delay_s):
                        if obj.kind == "NodeClaim":
                            time.sleep(_d)

                    spike_guard = _slow
                    harness.kube.admission.append(spike_guard)
                elif fault == "watch_hang":
                    # no watch delivery past the freshness bound: the
                    # age check, not an explicit flag, must trip
                    time.sleep(config.max_staleness_s * 1.6)
            elif spike_guard is not None:
                harness.kube.admission.remove(spike_guard)
                spike_guard = None
            pipe.release()
            if ev is not None and fault in _HOLDING_FAULTS:
                counter = _HOLDING_FAULTS[fault]
                deadline = time.monotonic() + hold_timeout
                while (
                    time.monotonic() < deadline
                    and pipe.held_ticks()[counter] <= held_seen[counter]
                ):
                    time.sleep(0.002)
                held_now = pipe.held_ticks()
                if held_now[counter] <= held_seen[counter]:
                    raise TimeoutError(
                        f"tick did not hold under {fault} at step {i} of {sc.name}"
                    )
                held_seen = held_now
                # the no-stale-plan invariant, observed: nothing may
                # have been emitted while the guard held
                stale_plans_emitted += len(rec.stream) - plans_before
                writes_while_deposed += (
                    len(harness.kube.list("NodeClaim")) - claims_before
                    if fault == "failover"
                    else 0
                )
                flightrec.set_fault_window(f"chaos_{fault}", fault, "recovery")
                if fault == "watch_flap":
                    pipe.set_world_stale(False)
                elif fault == "watch_hang":
                    pipe.note_world_event()  # the liveness probe returns
                elif fault == "failover":
                    led["leading"] = True  # re-elected
            if not pipe.quiesce(timeout=quiesce_timeout):
                raise TimeoutError(f"failed to quiesce at step {i} of {sc.name}")
            pipe.hold()
            if ev is None:
                flightrec.clear_fault_window()
        latency = pipe.latency
        rr.ticks = pipe.ticks()
        rr.stage_stats = pipe.debug_state()
    finally:
        flightrec.clear_fault_window()
        pipe.stop()
    rr = _finalize_result(rr, harness, rec, latency, time.perf_counter() - t0)
    harness.close()
    dbg = rr.stage_stats
    return {
        "scenario": scenario_name,
        "fault": fault,
        "device": str(device or "cuda"),
        "schedule": schedule.to_dict() if schedule is not None else None,
        "fault_steps": fault_steps,
        "steps": len(sc.steps),
        "pods_injected": sc.total_creates,
        "ticks": rr.ticks,
        "pods_decided": rr.pods_decided,
        "pod_errors": rr.errors,
        "plans_emitted": len(rr.plan_stream),
        "plan_sha256": hashlib.sha256(rr.plan_bytes()).hexdigest(),
        "monotonic_decision_order": monotonic_decision_order(rr),
        "held_ticks": dbg.get("chaos", {}).get("held_ticks", {}),
        "stale_plans_emitted": stale_plans_emitted,
        "single_writer_ok": writes_while_deposed == 0,
        "decision_latency_ms": percentiles_ms(rr.samples_ms),
        "steady_decision_latency_ms": percentiles_ms(rr.steady_samples_ms),
        "slo_burn": dbg.get("flightrec", {}).get("burn_rate", {}),
        "wall_s": rr.wall_s,
    }


class _ServingFaults(logging.Handler):
    """Collects the serving logger's faults while attached: records at
    ERROR and above (a failed tick, a failed boot prewarm) and the debug
    records of failures the stages swallow (a failed speculative
    prewarm, a failed flight record)."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.faults: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if record.levelno >= logging.ERROR or "failed" in msg:
            self.faults.append(f"{record.levelname}: {msg}")

    def __enter__(self):
        logger = logging.getLogger("karpenter.torch.serving")
        self._level = logger.level
        logger.setLevel(logging.DEBUG)
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        logger = logging.getLogger("karpenter.torch.serving")
        logger.removeHandler(self)
        logger.setLevel(self._level)


# ---------------------------------------------------------------------------
# CLI: one measurement per process, so every (scenario, mode) pair runs
# with fresh process-wide state (memos, catalog cache, loaded kernel
# libraries): whichever mode runs second must not inherit the first's.


# -- the fleet mode: N independent scenario streams against one device ------------


def _fleet_plan_key(plan) -> tuple:
    """Content identity of one NodePlan, the engines' parity projection
    (object identities differ by design: the batched engine emits from
    canonical catalog copies)."""
    return (
        plan.nodepool_name,
        plan.instance_type.name,
        plan.zone,
        plan.capacity_type,
        round(plan.price, 9),
        tuple(plan.pod_indices),
        plan.max_pods_per_node,
    )


def run_fleet_measurement(
    n_tenants: int = 8,
    scenario: str = "rollout",
    scale: int = 200,
    engine: str = "batched",
    seed: int = 7,
    catalog_sizes: Tuple[int, ...] = (16, 48, 96),
    quantum: Optional[int] = None,
    device="cuda",
) -> dict:
    """One fleet drive: ``n_tenants`` independent ``scenario`` streams
    (per-tenant seeds and catalog archetypes) through one
    ``FleetScheduler`` on ``engine`` and ``device`` → a plain-JSON
    summary: throughput, per-tenant decision latency, the mega-dispatch
    stats, the scheduler's state and a hash of every tenant's plan stream
    (equal across engines and devices ⇔ plan identity). The catalog
    cache holds ``KARPENTER_TORCH_CATALOG_CACHE_MAX`` entries: the caller
    sets it for a large fleet (the JAX package sets 2·tenants + 16)."""
    import hashlib

    from ..fleet import FleetEngine, FleetRegistry, FleetScheduler
    from ..tracing import tracer
    from .latency import percentiles_ms

    tracer.reset_orphans()
    registry = FleetRegistry(device=device)
    fleet = FleetEngine(registry, engine=engine)
    sched = FleetScheduler(fleet, quantum=quantum)

    scenarios = []
    for t in range(n_tenants):
        tid = f"tenant-{t:03d}"
        sc = build_scenario(scenario, scale=scale, seed=seed + 17 * t)
        provider = FakeCloudProvider()
        provider.instance_types = _catalog(catalog_sizes[t % len(catalog_sizes)])
        provider.bump_catalog_generation()
        nodepool = NodePool()
        nodepool.metadata.name = "default"
        nodepool.spec.template.requirements = [
            NodeSelectorRequirement("team", "In", [f"t{k}" for k in range(sc.teams)])
        ]
        registry.add_tenant(tid, [nodepool], provider)
        scenarios.append((tid, sc, provider, nodepool))

    plan_log: List[tuple] = []
    round_dispatch = {"flushes": 0, "pack_calls": 0, "jobs": 0, "max_occupancy": 0}
    injected = 0
    rounds = 0
    t0 = time.perf_counter()
    n_steps = max(len(sc.steps) for _, sc, _, _ in scenarios)
    for si in range(n_steps):
        for tid, sc, provider, nodepool in scenarios:
            if si >= len(sc.steps):
                continue
            step = sc.steps[si]
            if step.mutate_catalog:
                its = provider.get_instance_types(nodepool)
                for it in its[:: max(1, len(its) // 16)]:
                    for o in it.offerings:
                        o.price *= 1.01
                provider.bump_catalog_generation()
            if step.creates:
                pods = [materialize_spec(s) for s in step.creates]
                injected += len(pods)
                sched.submit(tid, pods)
        while sched.queued():
            outcomes = sched.run_round()
            rounds += 1
            d = fleet.last_round.get("dispatch") or {}
            for k in ("flushes", "pack_calls", "jobs"):
                round_dispatch[k] += d.get(k, 0)
            round_dispatch["max_occupancy"] = max(round_dispatch["max_occupancy"], d.get("max_occupancy", 0))
            for tid in sorted(outcomes):
                o = outcomes[tid]
                if o.error is None:
                    plan_log.append((rounds, tid, tuple(sorted(_fleet_plan_key(p) for p in o.result.node_plans))))
                else:
                    plan_log.append((rounds, tid, ("error", o.error)))
    wall = time.perf_counter() - t0

    samples: List[float] = []
    decided = errors = 0
    per_tenant = {}
    monotonic = True
    for tid, _sc, _p, _np in scenarios:
        tracker = registry.get(tid).latency
        ms = tracker.samples_ms()
        samples.extend(ms)
        decided += tracker.decided_count()
        errors += sum(1 for s in tracker.decisions() if s[4])
        ticks = [tick for tick, _ in tracker.decision_log()]
        monotonic = monotonic and ticks == sorted(ticks)
        if len(per_tenant) < 4:
            per_tenant[tid] = percentiles_ms(ms)
    return {
        "engine": engine,
        "scenario": scenario,
        "tenants": n_tenants,
        "scale": scale,
        "device": str(registry.device),
        "rounds": rounds,
        "pods_injected": injected,
        "pods_decided": decided,
        "decision_errors": errors,
        "decisions_monotonic": monotonic,
        "orphan_spans": tracer.orphan_spans(),
        "wall_s": round(wall, 4),
        "pods_per_sec": round(decided / wall, 1) if wall else 0.0,
        "decision_latency_ms": percentiles_ms(samples),
        "per_tenant_latency_ms": per_tenant,
        "dispatch": round_dispatch,
        "plan_sha256": hashlib.sha256(repr(plan_log).encode()).hexdigest(),
        "scheduler": sched.debug_state(),
    }


def _cli(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        "python -m karpenter_core_tpu_torch.serving.trafficgen",
        description="Replay a production-shaped traffic scenario against the serving pipeline.",
    )
    ap.add_argument("--scenario", required=True, choices=sorted(SCENARIOS))
    ap.add_argument("--mode", default="pipeline", choices=("pipeline", "sequential"))
    ap.add_argument("--drive", default="free", choices=("free", "lockstep"))
    ap.add_argument("--scale", type=int, default=800)
    ap.add_argument("--pace", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--idle", type=float, default=0.02, help="batch window idle seconds")
    ap.add_argument("--max", dest="max_s", type=float, default=0.5, help="batch window max seconds")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the solves' device (default: the card)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet mode: drive N independent tenant streams of "
                         "--scenario through the fleet scheduler")
    ap.add_argument("--engine", default="batched", choices=("batched", "solo"),
                    help="fleet engine (with --fleet)")
    # kill-the-process-mid-stream: each phase is one process
    ap.add_argument("--restart-kill-at", type=int, default=0, metavar="K",
                    help="drive steps [0, K), snapshot on quiesce, dump the "
                         "handoff to --workdir, print the summary, exit "
                         "(the kill IS the process exit)")
    ap.add_argument("--restart-resume", metavar="HANDOFF", default=None,
                    help="rebuild from a kill phase's handoff, restore the "
                         "warm-state snapshot, resume the stream from the "
                         "kill step")
    ap.add_argument("--restart-reference", action="store_true",
                    help="drive the whole scenario unkilled (the identity "
                         "oracle for a kill/resume pair)")
    ap.add_argument("--cold", action="store_true",
                    help="with --restart-resume: skip the warm-state restore "
                         "(the unsnapshot cold-restart baseline)")
    ap.add_argument("--workdir", default=None,
                    help="snapshot/handoff directory (with --restart-kill-at)")
    ap.add_argument("--n-types", type=int, default=480,
                    help="catalog size for the restart phases")
    # chaos pack: one fault kind per run, "none" = clean twin
    ap.add_argument("--chaos", default=None, choices=("none",) + CHAOS_FAULTS,
                    help="chaos mode: lockstep-drive --scenario with this "
                         "fault injected from a seeded schedule ('none' = "
                         "the clean twin the faulted run's plan hash is "
                         "gated against)")
    args = ap.parse_args(argv)
    with _ServingFaults() as faults:
        if args.chaos is not None:
            out = run_chaos(
                args.scenario, fault=args.chaos, scale=args.scale, seed=args.seed, device=args.device
            )
        elif args.restart_kill_at or args.restart_resume or args.restart_reference:
            if args.restart_resume:
                out = run_restart_resume(
                    args.restart_resume, restore=not args.cold, device=args.device
                )
            elif args.restart_reference:
                out = run_restart_reference(
                    args.scenario, scale=args.scale, seed=args.seed, n_types=args.n_types,
                    device=args.device,
                )
            else:
                if not args.workdir:
                    ap.error("--restart-kill-at requires --workdir")
                out = run_restart_kill(
                    args.scenario, args.restart_kill_at, args.workdir,
                    scale=args.scale, seed=args.seed, n_types=args.n_types, device=args.device,
                )
        elif args.fleet:
            out = run_fleet_measurement(
                n_tenants=args.fleet, scenario=args.scenario, scale=args.scale, engine=args.engine,
                seed=args.seed if args.seed is not None else 7, device=args.device,
            )
        else:
            out = run_measurement(
                args.scenario,
                args.mode,
                args.drive,
                args.scale,
                args.pace,
                seed=args.seed,
                idle_s=args.idle,
                max_s=args.max_s,
                device=args.device,
            )
    out["serving_log_faults"] = faults.faults
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
