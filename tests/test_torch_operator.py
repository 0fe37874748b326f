"""The port's operator ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/operator/`` is the port's copy of the JAX
package's composition root: ``Operator`` (every controller of the
reference's ``controllers.go`` on one device), ``Options``,
``SingletonController``, the served operational surface. Held:

- ``tests/test_operator.py`` runs from its own source on the port
  (``mirror``, its operators on the CPU: ``CpuOperator``, its kubelet
  the port's copy of ``tests/kubelet_sim.py``);
- the boundaries: ``Operator()`` with no device on a machine without a
  card raises; ``/debug/device`` answers 200 with the device plane's
  state, its keys the reference's;
  the ``MetricsDecorator`` is the one provider identity the solver's
  catalog cache and warm memos see, so a second reconcile is served warm
  and the catalog entry goes once the operator is dropped;
- the operator against the JAX package's operator: a small seeded world
  (about 60 pods of bench config 2's mix, 24 types with GPUs, two
  NodePools, a PDB) under the same start and the same stepped clock,
  driven through ``reconcile_all_once`` with a test kubelet, a seeded
  scale-down and passes until one changes nothing. After every pass the
  claims, nodes, taints, bindings, evictions, events and the metric
  samples are equal, with the native packer on and off.
"""

from __future__ import annotations

import gc
import importlib
import itertools
import re
import sys
import types
import uuid

import pytest

from test_torch_kube_client import PORT, REF, TESTS, case_id, mirror, mirror_cases, run_mirrored
from test_torch_oracle import _port_helpers, same_start


def cpu_operator_class():
    """The port's ``Operator`` on the CPU unless told otherwise."""
    from karpenter_core_tpu_torch.operator import Operator

    class CpuOperator(Operator):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("device", "cpu")
            super().__init__(*args, **kwargs)

    return CpuOperator


def port_kubelet_sim():
    """``tests/kubelet_sim.py`` over the port's classes (module
    ``_port_kubelet_sim``)."""
    mod = sys.modules.get("_port_kubelet_sim")
    if mod is None:
        src = re.sub(r"\bkarpenter_core_tpu\b", PORT, (TESTS / "kubelet_sim.py").read_text())
        mod = types.ModuleType("_port_kubelet_sim")
        mod.__file__ = str(TESTS / "kubelet_sim.py")
        sys.modules["_port_kubelet_sim"] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def operator_mirror(file: str, replace: tuple = ()):
    """``tests/<file>`` on the port, its operators ``CpuOperator`` and its
    kubelet the port's copy."""
    port_kubelet_sim()
    replace = (
        ("from kubelet_sim import", "from _port_kubelet_sim import"),
        ("from {pkg}.operator import Operator, Options\n", "from {pkg}.operator import Options\n"),
        *replace,
    )
    return mirror(file, PORT, replace=replace, inject={"Operator": cpu_operator_class()})


def operator_start(monkeypatch) -> None:
    """``same_start``, with uids whose first 16 hex digits differ too: the
    fake provider's instance ids are ``uuid4().hex[:16]``, which the plain
    counter leaves at zeros for every instance."""
    same_start(monkeypatch)
    ids = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4", lambda: (lambda n: uuid.UUID(int=(n << 64) | n))(next(ids)))


def chip_smoke_module():
    """``chip_smoke.py``, loaded once (its phase-18 world and store reader)."""
    mod = sys.modules.get("chip_smoke_phase18")
    if mod is None:
        import importlib.util

        spec = importlib.util.spec_from_file_location("chip_smoke_phase18", TESTS.parent / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke_phase18"] = mod
        spec.loader.exec_module(mod)
    return mod


def store_state(kube, recorder, metrics) -> dict:
    """``chip_smoke.store_state`` of a store, its recorder and metrics."""
    return chip_smoke_module().store_state(kube, recorder, metrics.registry.expose())


# -- tests/test_operator.py on the port ----------------------------------------

FILE = "test_operator.py"
CASES = mirror_cases(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 13


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_operator_case_holds_the_port(monkeypatch, case):
    run_mirrored(operator_mirror(FILE), *case, extra={"monkeypatch": monkeypatch})


# -- the boundaries ----------------------------------------------------------------


def test_operator_without_a_device_raises_on_a_machine_without_a_card():
    import torch

    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.operator import Operator

    if torch.cuda.is_available():
        pytest.skip("a card is present: Operator() runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        Operator(FakeCloudProvider())
    op = Operator(FakeCloudProvider(), device="cpu")
    assert op.device.type == "cpu" and op.provisioner.device == op.device
    assert op.disruption.ctx.provisioner is op.provisioner


def test_debug_device_answers_501_naming_the_device_plane():
    import urllib.error
    import urllib.request

    from karpenter_core_tpu_torch.metrics import Registry
    from karpenter_core_tpu_torch.operator.server import OperationalServer

    import json

    from karpenter_core_tpu.operator.server import _device as reference_device

    srv = OperationalServer(Registry(), ready_check=lambda: True, metrics_port=0, probe_port=0)
    srv.start()
    try:
        # the route serves the device plane now: 200, the reference's keys
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.metrics_port}/debug/device", timeout=5) as resp:
            assert resp.status == 200
            payload = json.loads(resp.read().decode())
        assert set(payload) == set(json.loads(reference_device({})[2]))
        assert payload["enabled"] is True
        # the fleet route exists only with a fleet
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.metrics_port}/debug/fleet", timeout=5)
        assert err.value.code == 404
    finally:
        srv.stop()


def _small_operator(n_types: int):
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types

    helpers = _port_helpers()
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    op = cpu_operator_class()(provider)
    op.informers.start()
    op._started = True
    op.kube_client.create(helpers.make_nodepool())
    for _ in range(4):
        op.kube_client.create(helpers.make_pod(requests={"cpu": "1"}))
    op.provisioner.reconcile()
    return op


def test_decorator_keeps_the_warm_memos_and_releases_the_catalog():
    """The operator hands every controller the ``MetricsDecorator``: the
    catalog cache's owner and the warm state's provider is the decorator,
    a second reconcile of the same batch is served warm, and once the
    operator is dropped and its warm state has left the warm-state LRU,
    its catalog entry goes at the next lookup."""
    from karpenter_core_tpu_torch.cloudprovider.metrics import MetricsDecorator
    from karpenter_core_tpu_torch.solver import incremental
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    incremental.reset()
    solver_mod._CATALOG_CACHE.clear()
    op = _small_operator(8)
    deco = op.cloud_provider
    assert isinstance(deco, MetricsDecorator)
    users = (op.provisioner, op.disruption.ctx, op.nodeclaim_lifecycle, op.nodeclaim_termination,
             op.node_termination, op.nodeclaim_gc, op.nodeclaim_disruption, op.cluster)
    assert [u.cloud_provider is deco for u in users] == [True] * len(users)
    solver = op.provisioner._tpu_solver[1]
    (key,) = [k for k, e in solver_mod._CATALOG_CACHE.items() if deco in e.owners]
    assert incremental.warm_state_for(solver).provider is deco
    # the same batch again: the claims go, the pods are pending as before
    for c in op.kube_client.list("NodeClaim"):
        op.kube_client.delete(c)
    op.provisioner.reconcile()
    assert op.provisioner._tpu_solver[1] is solver
    assert solver.last_cache_stats["hits"], solver.last_cache_stats
    op.stop()
    del op, solver, deco, users
    gc.collect()
    assert key in solver_mod._CATALOG_CACHE  # its warm state still holds the decorator
    others = [_small_operator(9 + i) for i in range(incremental._STATES_MAX)]
    gc.collect()
    others.append(_small_operator(20))
    assert key not in solver_mod._CATALOG_CACHE
    for other in others:
        other.stop()


# -- the operator against the JAX package's operator ---------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    return chip_smoke_module()


def ref_module(name: str):
    return importlib.import_module(f"{REF}.{name}")


def ref_operator(provider, kube, options, clock, validation_sleep):
    """The JAX package's ``Operator`` on the same world: its consolidation
    validation waits on the same stepped clock."""
    op = ref_module("operator").Operator(provider, kube_client=kube, options=options, clock=clock)
    op.disruption.ctx.validation_sleep = validation_sleep
    return op


def port_operator(provider, kube, options, clock, validation_sleep):
    return cpu_operator_class()(provider, kube_client=kube, options=options, clock=clock,
                                validation_sleep=validation_sleep)


OPERATOR_WORLD = dict(n_pods=60, n_types=24, seed=7)


def operator_run(chip_smoke, pkg: str, monkeypatch) -> tuple:
    """Phase 18a's sequence on ``pkg``'s operator, from the same start →
    (the store's state after every pass, the run's gated counts)."""
    from test_torch_incremental import reset_both

    reset_both()
    operator_start(monkeypatch)
    imp, make = (ref_module, ref_operator) if pkg == REF else (chip_smoke.port_module, port_operator)
    w = chip_smoke.run_operator_world("cpu", imp=imp, make_operator=make, **OPERATOR_WORLD)
    counts = chip_smoke.check_operator_world(w, pkg)
    return [(p["stage"], p["state"]) for p in w.passes], counts


@pytest.mark.parametrize("native", ["1", "0"])
def test_operator_equals_reference_after_every_pass(chip_smoke, monkeypatch, native):
    """Claims with their conditions, labels, requirements and finalizers,
    nodes and taints, pod bindings, leases, evictions and every other
    event, and the samples of ``karpenter_nodeclaims_*``, ``_nodes_*``,
    ``_pods_*`` and ``_disruption_*`` (duration histograms by count) are
    equal after every pass of provisioning, drift, the scale-down's
    consolidation and drains, GC and lease GC, with the C++ packer and
    with the device scans' plain versions."""
    from test_torch_native import reference_native
    from test_torch_pack_device import device_engine_off_native

    monkeypatch.setenv("KARPENTER_TPU_PARITY_SAMPLE", "0")
    if native == "0":
        device_engine_off_native(monkeypatch)
    else:
        monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "1")
        reference_native(monkeypatch)
    ref, ref_counts = operator_run(chip_smoke, REF, monkeypatch)
    port, port_counts = operator_run(chip_smoke, PORT, monkeypatch)
    assert [s for s, _ in port] == [s for s, _ in ref]
    for k, ((stage, a), (_, b)) in enumerate(zip(port, ref)):
        for part in a:
            assert a[part] == b[part], (k, stage, part)
    timing = ("pass_wall_ms", "controller_ms")
    assert {k: v for k, v in port_counts.items() if k not in timing} == {
        k: v for k, v in ref_counts.items() if k not in timing}
    assert port_counts["drift_commands"] and port_counts["consolidation_commands"] and port_counts["pods_evicted"]


def test_served_operator_phase_cut_down(chip_smoke):
    """Phase 18b on the CPU at scale 60: the leader serves every route
    after its first decision, ``/debug/device`` answers 200, the follower
    holds its serving ticks and writes nothing, the restarted operator
    leads, decides and reconciles again, no span is orphaned."""
    row = chip_smoke.run_operator_served("cpu", 60)
    assert row["follower_claims_created"] == 0 and row["follower_held_ticks"] >= 1
    assert row["leader_claims_created"] > 0 and row["decisions"] >= 2 and row["orphan_spans"] == 0
    assert set(row["routes_bytes"]) == set(chip_smoke.OPERATOR_ROUTES)


def test_reference_follower_pipeline_writes_claims():
    """ROADMAP C14, held: the JAX package's follower operator runs its
    serving pipeline ungated and writes NodeClaims beside the leader's;
    the port's follower holds (``test_served_operator_phase_cut_down``)."""
    import time

    tg = ref_module("serving.trafficgen")
    opm = ref_module("operator")
    sc = tg.build_scenario("rollout", scale=60)
    h = tg.TrafficHarness(teams=sc.teams)
    opts = dict(enable_leader_election=True, metrics_port=0, health_probe_port=0, use_serving_pipeline=True,
                batch_idle_duration=0.05, batch_max_duration=1.0)
    leader = opm.Operator(h.provider, kube_client=h.kube, options=opm.Options(**opts))
    follower = opm.Operator(h.provider, kube_client=h.kube, options=opm.Options(**opts))
    try:
        leader.start()
        follower.start()
        assert leader._leading() and not follower._leading()
        h.inject_step(sc.steps[0], 0)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not sum(follower.metrics.nodeclaims_created.values.values()):
            time.sleep(0.05)
        assert sum(follower.metrics.nodeclaims_created.values.values()) > 0
    finally:
        follower.stop()
        leader.stop()
        h.close()


def test_operator_phase_cut_down(chip_smoke, monkeypatch):
    """Phase 18 on the CPU, cut down (300 pods × 24 types; 18b at scale
    60): 18a's gates on its own run (no CPU twin of a CPU run), every
    wrapper of the path called, nothing launched, no kernel case."""
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE", raising=False)
    out = chip_smoke.run_operator_phase("cpu", {"world": (300, 24), "served": 60})
    assert "cuda" not in out and out["cpu"]["passes"] == out["passes_equal"]
    calls = out["captured_calls"]
    assert calls["compat_allowed"] and calls["ffd_pack"] and calls["pack_existing"]
    assert any(n for k, n in calls.items() if k.startswith("disrupt_screen"))
    assert all(n == 0 for n in out["launches"].values()) and out["cases"] == {}
    assert out["cpu"]["consolidation_commands"] and out["cpu"]["pods_evicted"]
    assert out["served"]["follower_claims_created"] == 0
    import os

    assert os.environ.get("KARPENTER_TORCH_NATIVE") is None
