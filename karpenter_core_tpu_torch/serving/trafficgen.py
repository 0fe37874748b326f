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

The harness that replays them through the serving pipeline
(``TrafficHarness`` and the ``run_*`` drivers) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..cloudprovider.fake import new_instance_type
from ..kube.objects import Container, Pod, PodCondition, PodSpec, ResourceRequirements
from ..kube.quantity import parse_quantity

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
