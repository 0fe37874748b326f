"""The port's serving pipeline ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/serving/`` (stage queues, decision latency,
``ServingPipeline``, ``SequentialLoop``) is the port's copy of the JAX
package's. Every test of ``tests/test_serving.py`` runs here from its
own source on the port (``mirror``), the harness, its drivers and the
encode-done handshake's scheduler on ``device="cpu"``: stage-queue
backpressure, the decision-latency tracker, the batch window, the
solver's encode-done listener, lockstep plan identity with monotonic
decisions and no orphaned span, the free run's flight-recorder coverage,
the pipeline's lifecycle, hold gate, catalog prewarm and disruption
stage.

Also: the boot prewarm (``solver/prewarm.py``), the consolidated solve
stats on a port solve, the leader gate and stale-world guard seams, and
the device plumbing of the stage threads: every scheduler the pipeline
builds runs on the provisioner's device.
"""

from __future__ import annotations

import pytest

from test_torch_incremental import cpu_scheduler
from test_torch_kube_client import PORT, case_id, mirror, mirror_cases, run_mirrored

FILE = "test_serving.py"
CASES = mirror_cases(FILE)


def serving_mirror():
    replace = (
        ("from {pkg}.solver import TPUScheduler, incremental", "from {pkg}.solver import incremental"),
        ("@pytest.fixture(autouse=True)\n", ""),
        ("tg.TrafficHarness(", 'tg.TrafficHarness(device="cpu", '),
        ("tg.run_lockstep(sc, ", 'tg.run_lockstep(sc, device="cpu", '),
        ("tg.run_free(sc, ", 'tg.run_free(sc, device="cpu", '),
    )
    return mirror(FILE, PORT, replace=replace, inject={"TPUScheduler": cpu_scheduler})


def test_mirror_covers_the_file():
    assert len(CASES) == 21


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_serving_case_holds_the_port(case):
    mod = serving_mirror()
    fresh = mod._fresh_warm_state()
    next(fresh)
    try:
        run_mirrored(mod, *case)
    finally:
        for _ in fresh:
            pass


# -- the pieces the reference's tests do not reach ----------------------------------


def harness_pipeline(**config):
    from karpenter_core_tpu_torch.serving import PipelineConfig, ServingPipeline
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    harness = tg.TrafficHarness(teams=2, n_types=16, device="cpu")
    pipe = ServingPipeline(
        harness.provisioner, metrics=harness.metrics,
        config=PipelineConfig(idle_seconds=0.01, max_seconds=0.2, **config),
        on_decision=harness.bind,
    )
    return harness, pipe


def test_stage_solvers_run_on_the_provisioners_device():
    """The prewarm and warm-store schedulers take the provisioner's
    device: a card-default scheduler would raise in the prewarm thread
    here, where the stage's catch would hide it."""
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    harness, pipe = harness_pipeline()
    try:
        harness.inject_step(tg.Step(creates=[tg.PodSpecLite("dev-0", "250m", "256Mi", None, 0)]), 0)
        assert str(pipe._prewarm_scheduler().device) == "cpu"
        assert str(pipe._warmstore_solver().device) == "cpu"
    finally:
        harness.close()


def test_harness_defaults_to_the_card():
    import torch

    from karpenter_core_tpu_torch.serving import trafficgen as tg

    if torch.cuda.is_available():
        pytest.skip("a card is present: the card default resolves")
    harness = tg.TrafficHarness(teams=2, n_types=16)
    try:
        assert harness.provisioner.device is None
        with pytest.raises(RuntimeError, match="cuda"):
            harness.warmup()
    finally:
        harness.close()


def test_encode_done_listener_reaches_the_solver_through_the_provisioner():
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    harness, pipe = harness_pipeline()
    fired = []
    harness.provisioner.encode_done_listener = lambda: fired.append(True)
    try:
        harness.inject_step(tg.Step(creates=[tg.PodSpecLite(f"enc-{i}", "250m", "256Mi", None, 0) for i in range(3)]), 0)
        harness.provisioner.reconcile()
        assert fired == [True]
        assert harness.provisioner._tpu_solver[1].encode_done_listener is not None
        # the device plane's block: no library loaded on the CPU
        assert harness.provisioner._tpu_solver[1].last_device_stats["compiles"] == 0
    finally:
        harness.close()


def test_boot_prewarm_outcome_and_gate():
    """A restore arms the tick-0 gate; the prewarm thread loads what the
    provisioner's device needs (on the CPU: the C++ packer) and records
    the outcome before the first tick."""
    from karpenter_core_tpu_torch.solver import prewarm

    import types

    prewarm.reset_for_tests()
    out = prewarm.warmup_compile_only(types.SimpleNamespace(device="cpu"))
    assert out["status"] == "ok" and out["device"] == "cpu" and out["calibration"] is None
    assert out["libraries"] == ["native_pack"]
    assert prewarm.last_result() == out
    harness, pipe = harness_pipeline(prewarm=False)
    try:
        pipe._warmstore_outcome = {"restored": {}, "dropped": {}}
        pipe.start()
        assert pipe._boot_prewarm_done.wait(10.0)
        assert pipe.debug_state()["prewarm"]["boot_replay"]["status"] == "ok"
    finally:
        pipe.stop()
        harness.close()


def test_boot_prewarm_kill_switch(monkeypatch):
    from karpenter_core_tpu_torch.solver import prewarm

    monkeypatch.setattr(prewarm, "PREWARM", False)
    assert prewarm.warmup_compile_only(None)["status"] == "disabled"


def test_boot_prewarm_raises_on_a_card_it_cannot_reach():
    import torch

    from karpenter_core_tpu_torch.solver import prewarm

    if torch.cuda.is_available():
        pytest.skip("a card is present: the card default resolves")
    with pytest.raises(RuntimeError):
        prewarm.warmup_compile_only(None)


def test_solve_stats_of_a_port_solve():
    """The consolidated schema over a port solve: every top-level key,
    the port's trace id, the route split, and the bench projection."""
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.solver import stats as solver_stats

    from test_torch_oracle import _port_helpers

    helpers = _port_helpers()
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(6)
    solver = cpu_scheduler([helpers.make_nodepool()], provider)
    assert solver_stats.route_payload(lambda: solver) is None
    solver.solve([helpers.make_pod(requests={"cpu": "250m"}) for _ in range(8)])
    doc = solver_stats.route_payload(lambda: solver)
    assert doc["schema"] == solver_stats.SCHEMA == 7
    assert set(doc) == {
        "schema", "trace_id", "timings", "cache", "merge", "pack_backend", "shard", "route",
        "disruption", "warmstore", "device", "pareto",
    }
    assert doc["trace_id"] == solver.last_trace_id and doc["trace_id"]
    assert doc["route"]["tensor"] == 8 and doc["route"]["oracle_share"] == 0.0
    # the device plane's block (its keys held to the reference's in
    # test_torch_deviceplane.py): nothing loaded, no card memory on the CPU
    assert doc["device"]["compiles"] == 0 and doc["device"]["hbm"] is None and doc["shard"] is None
    assert doc["timings"]["total_ms"] > 0
    assert {"device_ms", "host_ms", "merge_ms"} <= set(solver_stats.bench_fields(doc))


def test_leader_gate_and_stale_world_hold_ticks():
    """The degradation seams: a deposed leader's tick holds (counted)
    and its NodeClaim writes raise; a stale world holds the tick until
    freshness returns; neither emits."""
    import time

    from karpenter_core_tpu_torch.serving import LostLeadership
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    harness, pipe = harness_pipeline()
    leading = [False]
    pipe.attach_leader_gate(lambda: leading[0])
    pipe.attach_watch()
    pipe.start()
    try:
        harness.inject_step(tg.Step(creates=[tg.PodSpecLite(f"ld-{i}", "250m", "256Mi", None, 0) for i in range(3)]), 0)
        time.sleep(0.3)
        assert pipe.latency.decided_count() == 0
        assert pipe.held_ticks()["leader"] == 1
        from karpenter_core_tpu_torch.apis.nodeclaim import NodeClaim

        with pytest.raises(LostLeadership):
            harness.kube.create(NodeClaim())
        leading[0] = True
        assert pipe.quiesce(timeout=30.0)
        assert pipe.latency.decided_count() == 3
        pipe.set_world_stale(True)
        assert pipe.world_is_stale() and pipe.debug_state()["chaos"]["world_stale"]
        harness.inject_step(tg.Step(creates=[tg.PodSpecLite("st-0", "250m", "256Mi", None, 1)]), 1)
        time.sleep(0.3)
        assert pipe.latency.decided_count() == 3 and pipe.held_ticks()["stale"] == 1
        pipe.set_world_stale(False)
        assert pipe.quiesce(timeout=30.0)
        assert pipe.latency.decided_count() == 4
    finally:
        pipe.stop()
        harness.close()
    assert pipe.debug_state()["chaos"]["leader_gate"] is False  # stop() detached it


def test_queue_caps_are_constants(monkeypatch):
    from karpenter_core_tpu_torch.serving import PipelineConfig, queues

    assert (queues.SOLVE_CAP, queues.TELEMETRY_CAP) == (1, 1024)
    cfg = PipelineConfig()
    assert (cfg.solve_queue_cap, cfg.telemetry_queue_cap) == (1, 1024)
    assert (cfg.idle_seconds, cfg.max_seconds, cfg.prewarm, cfg.disrupt_every) == (1.0, 10.0, True, 0)
    assert (cfg.warmstore_dir, cfg.warmstore_restore, cfg.max_staleness_s) == (None, None, 0.0)
    monkeypatch.setattr(queues, "SOLVE_CAP", 3)
    assert PipelineConfig().solve_queue_cap == 3


def test_cli_refuses_the_slices_not_ported(capsys, monkeypatch):
    """``--chaos`` and ``--fleet`` are ported and run; ``--fleet 2 --scale
    60`` plans as the JAX package's ``run_fleet_measurement(2, "rollout",
    60)`` (plan hash equal)."""
    import json

    from karpenter_core_tpu.serving import trafficgen as ref_tg
    from karpenter_core_tpu_torch.serving import trafficgen as tg
    from test_torch_native import reference_native

    assert tg._cli(["--scenario", "rollout", "--chaos", "watch_flap", "--scale", "20", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fault"] == "watch_flap" and out["held_ticks"]["stale"] >= 1 and out["serving_log_faults"] == []
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE", raising=False)
    assert tg._cli(["--scenario", "rollout", "--fleet", "2", "--scale", "60", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == "batched" and out["device"] == "cpu" and out["serving_log_faults"] == []
    assert out["pods_decided"] == out["pods_injected"] > 0 and out["decisions_monotonic"] and out["orphan_spans"] == 0
    reference_native(monkeypatch)
    # the reference's run writes both: restored after the test
    monkeypatch.setenv("KARPENTER_TPU_FLEET_ENGINE", "batched")
    monkeypatch.setenv("KARPENTER_TPU_CATALOG_CACHE_MAX", "20")
    assert ref_tg.run_fleet_measurement(2, "rollout", 60)["plan_sha256"] == out["plan_sha256"]


def _labeled_world(pkg: str, device_kw: dict):
    """A harness whose kubelet registers each joined node with the labels
    its claim pins (the pods' ``team`` selector among them), so a later
    pod of the team fits an existing node."""
    import importlib

    tg = importlib.import_module(f"{pkg}.serving.trafficgen")
    serving = importlib.import_module(f"{pkg}.serving")
    harness = tg.TrafficHarness(teams=1, n_types=16, **device_kw)
    real = harness._launch_and_bind

    def launch_and_bind(claim_name, it, zone, ct, pods):
        real(claim_name, it, zone, ct, pods)
        node = harness.kube.get("Node", f"node-{claim_name}")
        node.metadata.labels["team"] = "t0"
        harness.kube.apply(node)

    harness._launch_and_bind = launch_and_bind
    loop = serving.SequentialLoop(harness.provisioner, on_decision=harness.bind)
    loop.attach_watch()
    return tg, harness, loop


def _existing_placement(pkg: str, device_kw: dict):
    tg, harness, loop = _labeled_world(pkg, device_kw)
    try:
        harness.inject_step(tg.Step(creates=[tg.PodSpecLite(f"big-{i}", "2", "1Gi", None, 0) for i in range(2)]), 0)
        loop.step_once()
        nodes = [n.metadata.name for n in harness.kube.list("Node")]
        harness.inject_step(tg.Step(evicts=["big-0", "big-1"],
                                    creates=[tg.PodSpecLite(f"small-{i}", "100m", "128Mi", None, 0) for i in range(2)]), 1)
        rec = loop.step_once()
        bound = sorted(p.spec.node_name for p in harness.kube.list("Pod") if p.metadata.name.startswith("small"))
        return nodes, rec, loop.latency.pending_count(), bound
    finally:
        loop.stop()
        harness.close()


def test_pods_placed_on_existing_nodes_are_decided_and_bound():
    """A tensor-path placement onto an existing node is a decision: the
    port's provisioner hands its plans to the decision step
    (``results.existing_plans``), so the pods are settled and bound. The
    JAX package's provisioner never sets the attribute its decision step
    reads, so there the same pods stay pending: a fault of the reference
    the port does not copy."""
    nodes, rec, pending, bound = _existing_placement(PORT, {"device": "cpu"})
    assert len(nodes) == 1 and rec["decided"] == 2 and rec["created"] == 0
    assert pending == 0 and bound == [nodes[0]] * 2
    nodes, rec, pending, bound = _existing_placement("karpenter_core_tpu", {})
    assert len(nodes) == 1 and rec["decided"] == 0 and pending == 2 and bound == ["", ""]
