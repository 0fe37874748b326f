"""The port's traffic scenarios ≡ the JAX package's.

``karpenter_core_tpu_torch/serving/trafficgen.py`` holds the scenario
half of the JAX package's traffic generator. Every ``scenario_*``
generator gives the same steps (created pod specs, evictions, deletions,
catalog mutations) as the reference at two seeds and two scales, through
``build_scenario`` too; ``_catalog`` gives the same instance types and
``materialize_spec`` the same pods.
"""

from __future__ import annotations

import pytest

from karpenter_core_tpu.serving import trafficgen as ref
from karpenter_core_tpu_torch.serving import trafficgen as port

NAMES = sorted(ref.SCENARIOS)


def steps(scenario) -> list:
    return [
        (
            [(s.name, s.cpu, s.mem, s.gpu, s.team) for s in step.creates],
            list(step.evicts), list(step.deletes), step.mutate_catalog,
        )
        for step in scenario.steps
    ]


def test_same_scenarios():
    assert sorted(port.SCENARIOS) == NAMES


@pytest.mark.parametrize("seed", [3, 9])
@pytest.mark.parametrize("name", NAMES)
def test_scenario_steps_equal_reference(name, seed):
    for scale in (40, 500):
        want = ref.SCENARIOS[name](scale=scale, seed=seed)
        got = port.SCENARIOS[name](scale=scale, seed=seed)
        assert (got.name, got.seed, got.teams, got.total_creates) == (want.name, want.seed, want.teams, want.total_creates)
        assert steps(got) == steps(want)
    assert steps(port.build_scenario(name, scale=60, seed=seed)) == steps(ref.build_scenario(name, scale=60, seed=seed))


def test_spot_storm_of_bench_config9():
    """Bench config 9's stream: 50,000 pods over 20 teams, seed 9."""
    want = ref.scenario_spot_storm(scale=50_000, teams=20, seed=9)
    got = port.scenario_spot_storm(scale=50_000, teams=20, seed=9)
    assert steps(got) == steps(want)
    # base, two trickles of scale // 50, the storm (30 % of the live pods), recovery
    assert len(got.steps) == 5 and len(got.steps[3].evicts) == int(52_000 * 0.30)


def _pod(p) -> tuple:
    c = p.spec.containers[0]
    return (
        p.metadata.name, sorted(p.metadata.labels.items()), sorted(p.spec.node_selector.items()),
        sorted(c.resources.requests.items()), [(x.type, x.status, x.reason) for x in p.status.conditions],
    )


def test_catalog_and_materialize_equal_reference():
    for n in (1, 5, 40):
        want, got = ref._catalog(n), port._catalog(n)
        assert [(i.name, sorted(i.capacity.items())) for i in got] == [
            (i.name, sorted(i.capacity.items())) for i in want
        ]
    for spec in port.scenario_rollout(scale=30, seed=4).steps[0].creates:
        assert _pod(port.materialize_spec(spec)) == _pod(ref.materialize_spec(ref.PodSpecLite(**spec.__dict__)))
