"""The port's flight recorder ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/tracing/flightrec.py`` is the port's copy of
the JAX package's per-decision flight recorder. The tests of
``TestRecordAssembly``, ``TestSloAccounting`` and ``TestExemplars`` of
``tests/test_flightrec.py`` run here from their own source on the port:
timeline reconstruction, the concurrent-lane split, the bounded ring,
coverage by kind, the SLO burn windows and their gauge (the SLO target
is the port's constant ``SLO_TARGET_MS``, set as a constant), and the
latency histogram's trace exemplar, and the two breach-dump tests (a
dump of the record with its trace events over the threshold, none
below it: the threshold is the constant ``SLO_BREACH_DUMP_MS``, the
directory the capture's ``DIR``, both set as constants).
``TestDebugRoutes`` runs on the port's ``OperationalServer``:
``/debug/decisions[/last]`` over the recorder's ring and
``/debug/solve/stats`` over ``stats.route_payload`` after a solve of the
port's ``TorchScheduler`` on the CPU (whose trace id is
``last_trace_id``: the port keeps ``last_timings`` numeric).

Beyond the mirror: a record assembled from the same decision by both
packages' recorders has the same shape and numbers, and the fault-window
stamps and ``debug_state`` keep the reference's keys.
"""

from __future__ import annotations

import pytest

from test_torch_kube_client import PORT, case_id, mirror, mirror_cases, run_mirrored

FILE = "test_flightrec.py"
CLASSES = ("TestRecordAssembly", "TestSloAccounting", "TestExemplars")
CASES = mirror_cases(FILE, classes=CLASSES)


def flightrec_mirror():
    from karpenter_core_tpu_torch.tracing import capture

    replace = (
        ("from {pkg}.operator.server import OperationalServer\n", ""),
        ('monkeypatch.setenv("KARPENTER_TPU_SLO_TARGET_MS", "10")',
         'monkeypatch.setattr(flightrec, "SLO_TARGET_MS", 10.0)'),
        ('monkeypatch.setenv("KARPENTER_TPU_SLO_BREACH_DUMP_MS", "1")',
         'monkeypatch.setattr(flightrec, "SLO_BREACH_DUMP_MS", 1.0)'),
        ('monkeypatch.setenv("KARPENTER_TPU_SLO_BREACH_DUMP_MS", "10000")',
         'monkeypatch.setattr(flightrec, "SLO_BREACH_DUMP_MS", 10000.0)'),
        ('monkeypatch.setenv("KARPENTER_TPU_TRACE_DIR", str(tmp_path))',
         'monkeypatch.setattr(capture, "DIR", str(tmp_path))'),
    )
    return mirror(FILE, PORT, replace=replace, inject={"capture": capture})


def test_mirror_covers_the_classes():
    assert len(CASES) == 9
    assert {c[0] for c in CASES} == set(CLASSES)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_flightrec_case_holds_the_port(monkeypatch, tmp_path, case):
    run_mirrored(flightrec_mirror(), *case, extra={"monkeypatch": monkeypatch, "tmp_path": tmp_path})


ROUTE_CASES = mirror_cases(FILE, classes=("TestDebugRoutes",))


def debug_routes_mirror():
    from test_torch_disruption import cpu_scheduler

    replace = (
        ("        from {pkg}.solver import TPUScheduler\n", ""),
        # the port keeps last_timings numeric: the trace id is last_trace_id
        ('solver.last_timings["trace_id"]', "solver.last_trace_id"),
    )
    return mirror(FILE, PORT, replace=replace, inject={"TPUScheduler": cpu_scheduler})


def test_debug_routes_mirror_covers_the_class():
    assert len(ROUTE_CASES) == 4


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[case_id(c) for c in ROUTE_CASES])
def test_debug_routes_case_holds_the_port(monkeypatch, case):
    run_mirrored(debug_routes_mirror(), *case, extra={"monkeypatch": monkeypatch})


def _record(pkg: str):
    import importlib

    flightrec = importlib.import_module(f"{pkg}.tracing.flightrec")
    tracer = importlib.import_module(f"{pkg}.tracing.tracer")
    with tracer.trace_root("decision") as tr:
        with tracer.span("solve"):
            pass
    rec = flightrec.FlightRecorder(capacity=4, clock=lambda: 100.0).record(
        "pipeline", 2, trace=tr, latency_ms=[3.0, 9.0], queue_wait_ms=0.5, pods_decided=2, errors=1,
        solve={"schema": 7}, cost={},
    )
    return flightrec, rec


def test_record_shape_equals_reference():
    _, want = _record("karpenter_core_tpu")
    _, got = _record(PORT)
    assert set(got) == set(want)
    for key in ("kind", "tick", "pods_decided", "errors", "latency_ms", "solve", "links", "slo_ms", "slo_over", "cost"):
        assert got[key] == want[key], key
    assert set(got["timeline"]) == set(want["timeline"])
    assert got["timeline"]["queue_wait_ms"] == 0.5 and got.reconstructed


def test_fault_window_and_debug_state_keys():
    import karpenter_core_tpu.tracing.flightrec as ref

    from karpenter_core_tpu_torch.tracing import flightrec

    assert flightrec.SLO_TARGET_MS == ref.DEFAULT_TARGET_MS == 500.0
    assert flightrec.FLIGHTREC_KEEP == ref.DEFAULT_KEEP and flightrec.SLO_BREACH_DUMP_MS is None
    assert flightrec.BURN_WINDOWS == ref.BURN_WINDOWS
    r = flightrec.FlightRecorder(capacity=2)
    flightrec.set_fault_window("chaos_relist_storm", "watch_flap", "inject")
    try:
        rec = r.record("pipeline", 1)
        assert rec["fault_window"] == {"scenario": "chaos_relist_storm", "fault": "watch_flap", "phase": "inject"}
        assert r.debug_state()["fault_window"]["fault"] == "watch_flap"
    finally:
        flightrec.clear_fault_window()
    assert flightrec.active_fault_window() is None
    assert "fault_window" not in r.record("pipeline", 2)
    state = r.debug_state(tail=1)
    want = ref.FlightRecorder(capacity=2).debug_state()
    assert set(state) == set(want)
    assert state["retained"] == 2 and state["capacity"] == 2 and len(state["decisions"]) == 1
