"""NodePool limits: TorchScheduler ≡ TPUScheduler on the cases of
``tests/test_solver_limits.py`` (the relaxation retry excepted, which
the port does not carry): the limit caps the node count, a single-type
catalog, spill to a lower-weight pool, types too big for the limit
filtered up front, existing nodes consuming the limit, and an unlimited
pool. Each case requires the plan stream, the existing plans,
``pod_errors`` by index, ``node_count``, ``pods_scheduled`` and
``total_price`` to be identical (``test_torch_existing.solve_both``).
"""

from __future__ import annotations

import pytest

from test_torch_existing import on_existing, solve_both


def _one_size(k, cpu="4"):
    return k.provider(catalog=[("one-size", {"cpu": cpu, "memory": "16Gi", "pods": "100"})])


def _caps_node_count(k):
    pods = [k.pod(f"p-{i}", {"cpu": "3"}) for i in range(6)]
    return [k.nodepool(limits={"cpu": "8"})], _one_size(k), pods, [], []


def _single_type(k):
    pods = [k.pod(f"p-{i}", {"cpu": "2"}) for i in range(10)]
    return [k.nodepool(limits={"cpu": "12"})], _one_size(k), pods, [], []


def _spill(k):
    pools = [
        k.nodepool("limited", limits={"cpu": "4"}, weight=10),
        k.nodepool("fallback", weight=1),
    ]
    pods = [k.pod(f"p-{i}", {"cpu": "3"}) for i in range(3)]
    return pools, _one_size(k), pods, [], []


def _big_types_filtered(k):
    provider = k.provider(
        catalog=[
            ("small", {"cpu": "2", "memory": "8Gi", "pods": "100"}),
            ("huge", {"cpu": "64", "memory": "256Gi", "pods": "100"}),
        ]
    )
    pods = [k.pod(f"p-{i}", {"cpu": "900m"}) for i in range(6)]
    return [k.nodepool(limits={"cpu": "6"})], provider, pods, [], []


def _existing_consume(k):
    sn = k.state_node("node-0", cpu="4", memory="16Gi", pods="2")
    pods = [k.pod(f"p-{i}", {"cpu": "3"}) for i in range(4)]
    return [k.nodepool(limits={"cpu": "8"})], _one_size(k), pods, [sn], []


def _unlimited(k):
    pods = [k.pod(f"p-{i}", {"cpu": "3"}) for i in range(5)]
    return [k.nodepool()], _one_size(k), pods, [], []


CASES = {
    "limit-caps-node-count": _caps_node_count,
    "single-type": _single_type,
    "spill-to-lower-weight-pool": _spill,
    "big-types-filtered": _big_types_filtered,
    "existing-nodes-consume-limit": _existing_consume,
    "unlimited-pool": _unlimited,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_limits_plan_identity(monkeypatch, case):
    res, pods, solver = solve_both(monkeypatch, CASES[case])
    if case == "limit-caps-node-count":
        assert (res.node_count, res.pods_scheduled, len(res.pod_errors)) == (2, 2, 4)
        assert all(
            e == 'all available instance types exceed limits for nodepool: "default"'
            for e in res.pod_errors.values()
        )
    elif case == "single-type":
        assert (res.node_count, res.pods_scheduled, len(res.pod_errors)) == (3, 3, 7)
    elif case == "spill-to-lower-weight-pool":
        assert sorted(p.nodepool_name for p in res.node_plans) == ["fallback", "fallback", "limited"]
        assert not res.pod_errors
    elif case == "big-types-filtered":
        assert {p.instance_type.name for p in res.node_plans} == {"small"}
        assert (res.node_count, res.pods_scheduled) == (3, 6)
    elif case == "existing-nodes-consume-limit":
        assert (on_existing(res), res.node_count, len(res.pod_errors)) == (1, 1, 2)
    elif case == "unlimited-pool":
        assert (res.node_count, res.pods_scheduled) == (5, 5)
    assert "limits_ms" in solver.last_timings
