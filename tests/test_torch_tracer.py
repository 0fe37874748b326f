"""The port's span tracer ≡ the JAX package's, on what the provisioner
and the solve use.

Each scenario runs once on each package's ``tracing.tracer`` and gives
a shape: every finished trace's spans in completion order as (name,
depth, parent's name, lane: root or adopted), ``contains_solve``, the
links, which traces the ring kept, the phase-histogram labels the
metrics sink observed, and the orphan count. The shapes must be equal,
exactly (times are never compared). Scenarios: nested spans, a
``trace_root`` joining an open trace (the solve inside the
provisioner's reconcile), each ``buffer_if``, recording turned off (the
reference's ``KARPENTER_TPU_TRACE=0``, the port's ``TRACE = False``),
orphans, adopted lanes on worker threads, foreign-trace links, and a
small ring (``TRACE_BUFFER``). Then a ``Provisioner.reconcile`` of each
package on the batched path: the same provisioner-level spans
(``provisioner.reconcile`` → ``snapshot_nodes``, ``pending_pods``,
``solve``, ``create_node_claims``) in the buffered trace.

``TestChromeExport`` and ``TestDebugTracesRoutes`` of
``tests/test_tracing.py`` run from their own source on the port
(``mirror``): the Chrome trace-event export (``tracing/export.py``) and
``/debug/traces[/last]`` served by the port's ``OperationalServer`` after
solves of its ``TorchScheduler`` on the CPU, and the single-flight guard
of ``/debug/pprof/profile``. The same trace exports to the same events in
both packages, but for the clock's numbers.
"""

from __future__ import annotations

import importlib
import os
import threading

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored


def tracer_of(pkg: str):
    return importlib.import_module(f"{pkg}.tracing.tracer")


def shape(tr) -> dict:
    if tr is None:
        return None
    return dict(
        name=tr.name,
        spans=[
            (s.name, s.depth, s.parent.name if s.parent is not None else None,
             "root" if s.tid == tr.root_tid else "lane")
            for s in tr.spans
        ],
        contains_solve=tr.contains_solve,
        links=[dict(link, trace_id="") for link in tr.links],
        breakdown=sorted(tr.phase_breakdown_ms()),
        lanes=len(tr.lane_breakdown_ms()),
        self_time_partitions=not tr.spans
        or sum(s.self_ns for s in tr.spans if s.tid == tr.root_tid)
        == next(s.dur_ns for s in tr.spans if s.depth == 0 and s.tid == tr.root_tid),
    )


class Sink:
    """A histogram stand-in recording the phase labels it observed."""

    def __init__(self):
        self.phases = []

    def observe(self, value, **labels):
        assert value >= 0
        self.phases.append(labels["phase"])


def nested(t, sink):
    with t.trace_root("root", metrics_sink=sink) as tr:
        with t.span("a"):
            with t.span("a.inner1"):
                pass
            with t.span("a.inner2"):
                pass
        with t.span("b"):
            pass
    return [tr]


def joined(t, sink):
    with t.trace_root("provisioner.reconcile", buffer_if="solve") as outer:
        with t.span("snapshot_nodes"):
            pass
        with t.trace_root("solve", metrics_sink=sink, buffer_if="solve", is_solve=True, pods=3) as inner:
            assert inner is outer or outer is None  # recording off: the sink opens its own
            with t.span("encode"):
                pass
        with t.span("create_node_claims"):
            pass
    return [outer]


def buffering(t, sink):
    out = []
    for mode, solve in (("always", False), ("solve", False), ("solve", True), ("never", True)):
        with t.trace_root(f"{mode}-{solve}", buffer_if=mode, is_solve=solve) as tr:
            with t.span("x"):
                pass
        out.append(tr)
    return out


def orphans(t, sink):
    with t.span("floating"):
        with t.span("floating.child"):
            pass
    with t.trace_root("root") as tr:
        with t.span("kept"):
            pass
    return [tr]


def adopted(t, sink):
    with t.trace_root("decision", metrics_sink=sink) as tr:
        with t.span("enqueue"):
            ctx = t.capture()
        errs = []

        def worker():
            try:
                with t.adopt(ctx, "consume", item=1):
                    with t.span("consume.work"):
                        pass
                    with t.trace_root("solve", is_solve=True) as inner:
                        assert inner is tr
            except Exception as e:  # noqa: BLE001 — surfaced via errs
                errs.append(e)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
        assert not errs
        with t.adopt(ctx, "again"):
            pass
    assert t.capture() is None
    with t.adopt(None, "x") as s:
        assert s is None
    return [tr]


def foreign(t, sink):
    with t.trace_root("a") as tr_a:
        ctx_a = t.capture()
    with t.trace_root("b") as tr_b:
        with t.adopt(ctx_a, "crossover"):
            pass
    return [tr_a, tr_b]


SCENARIOS = {f.__name__: f for f in (nested, joined, buffering, orphans, adopted, foreign)}


def run(pkg: str, scenario, monkeypatch, record: bool = True, ring: int = 32) -> dict:
    t = tracer_of(pkg)
    if pkg == REF:
        monkeypatch.setenv("KARPENTER_TPU_TRACE", "1" if record else "0")
    else:
        monkeypatch.setattr(t, "TRACE", record)
    t.RING.clear()
    monkeypatch.setattr(t, "RING", t.TraceRing(ring))
    t.reset_orphans()
    sink = Sink()
    traces = scenario(t, sink)
    out = dict(
        traces=[shape(tr) for tr in traces],
        ring=[tr.name for tr in t.RING.all()],
        sink=sink.phases,
        orphans=t.orphan_spans(),
        orphan_recent=t.orphan_recent(),
        current=t.current_trace(),
    )
    t.reset_orphans()
    return out


@pytest.mark.parametrize("record", [True, False], ids=["recording", "recording-off"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_shape_matches_reference(monkeypatch, name, record):
    ref = run(REF, SCENARIOS[name], monkeypatch, record)
    port = run(PORT, SCENARIOS[name], monkeypatch, record)
    assert port == ref
    if record and name != "orphans":
        assert all(tr is not None and tr["spans"] for tr in ref["traces"])


def test_small_ring_keeps_newest(monkeypatch):
    def many(t, sink):
        out = []
        for i in range(5):
            with t.trace_root(f"t{i}") as tr:
                pass
            out.append(tr)
        return out

    ref = run(REF, many, monkeypatch, ring=2)
    port = run(PORT, many, monkeypatch, ring=2)
    assert ref["ring"] == ["t3", "t4"]
    assert port == ref


def test_buffer_constant_matches_reference_default():
    assert tracer_of(PORT).TRACE_BUFFER == tracer_of(REF).RING.capacity == 32
    assert tracer_of(PORT).RING.capacity == 32


def test_provisioner_trace_matches_reference(monkeypatch):
    """One reconcile on the batched path in each package: the buffered
    trace's provisioner-level spans agree (the solve's inner phases are
    each package's own)."""
    from test_torch_provisioner import World, reference_setup

    reference_setup(monkeypatch)
    out = {}
    for pkg in (REF, PORT):
        t = tracer_of(pkg)
        t.RING.clear()
        t.reset_orphans()
        w = World(pkg, monkeypatch, use_tpu_solver=True, metrics=True)
        w.basic_pods(6)
        names, reason = w.provisioner.reconcile()
        assert reason is None and names
        tr = t.RING.last()
        assert tr is not None and tr.name == "provisioner.reconcile" and tr.contains_solve
        out[pkg] = dict(
            top=[(s.name, s.depth) for s in tr.spans if s.depth <= 1 and s.tid == tr.root_tid],
            orphans=t.orphan_spans(),
            observed_solve=w.metrics.solver_phase_duration.totals.get((("phase", "solve"),)),
        )
        w.stop()
    assert out[REF]["top"] == [
        ("snapshot_nodes", 1), ("pending_pods", 1), ("solve", 1), ("create_node_claims", 1),
        ("provisioner.reconcile", 0),
    ]
    assert out[PORT] == out[REF]


# -- the Chrome export and the /debug/traces routes, on the port --------------------

ROUTE_FILE = "test_tracing.py"
ROUTE_CLASSES = ("TestChromeExport", "TestDebugTracesRoutes")
ROUTE_CASES = mirror_cases(ROUTE_FILE, classes=ROUTE_CLASSES)


def tracing_mirror():
    from test_torch_disruption import cpu_scheduler

    return mirror(ROUTE_FILE, PORT, replace=(("from {pkg}.solver import TPUScheduler\n", ""),),
                  inject={"TPUScheduler": cpu_scheduler})


def test_routes_mirror_covers_the_classes():
    assert {c[0] for c in ROUTE_CASES} == set(ROUTE_CLASSES)
    assert len([c for c in ROUTE_CASES if c[0] == "TestDebugTracesRoutes"]) == 4


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[case_id(c) for c in ROUTE_CASES])
def test_trace_routes_case_holds_the_port(case):
    run_mirrored(tracing_mirror(), *case)


# the slow-solve capture (tracing/capture.py): its knobs are constants
CAPTURE_CASES = [c for c in mirror_cases(ROUTE_FILE, classes=("TestSolveTracing",))
                 if c[1] == "test_slow_solve_capture_writes_file"]


def capture_mirror():
    from test_torch_disruption import cpu_scheduler

    from karpenter_core_tpu_torch.tracing import capture

    replace = (
        ("from {pkg}.solver import TPUScheduler\n", ""),
        ('monkeypatch.setenv("KARPENTER_TPU_TRACE_SLOW_MS", "0")', 'monkeypatch.setattr(capture, "SLOW_MS", 0.0)'),
        ('monkeypatch.setenv("KARPENTER_TPU_TRACE_DIR", str(tmp_path))',
         'monkeypatch.setattr(capture, "DIR", str(tmp_path))'),
    )
    return mirror(ROUTE_FILE, PORT, replace=replace, inject={"TPUScheduler": cpu_scheduler, "capture": capture})


@pytest.mark.parametrize("case", CAPTURE_CASES, ids=[case_id(c) for c in CAPTURE_CASES])
def test_capture_case_holds_the_port(monkeypatch, tmp_path, case):
    run_mirrored(capture_mirror(), *case, extra={"monkeypatch": monkeypatch, "tmp_path": tmp_path})


def test_capture_is_off_by_default_and_keeps_its_own_directory(monkeypatch, tmp_path):
    """``SLOW_MS`` None writes nothing; the default directory is not the
    reference's, whose pruning would delete the other package's files;
    ``KEEP`` prunes the oldest captures."""
    from karpenter_core_tpu.tracing import capture as ref_capture
    from karpenter_core_tpu_torch.tracing import capture

    assert capture.SLOW_MS is None and capture.KEEP == ref_capture.DEFAULT_KEEP
    assert os.path.abspath(capture.DIR) != os.path.abspath(ref_capture.DEFAULT_DIR)
    monkeypatch.setattr(capture, "DIR", str(tmp_path))
    t = tracer_of(PORT)
    with t.trace_root("solve", buffer_if="always", is_solve=True):
        pass
    assert not list(tmp_path.iterdir())
    monkeypatch.setattr(capture, "SLOW_MS", 0.0)
    monkeypatch.setattr(capture, "KEEP", 2)
    for _ in range(3):
        with t.trace_root("solve", buffer_if="always", is_solve=True):
            pass
    assert len(list(tmp_path.glob("*.trace.json"))) == 2


def _export_shape(pkg: str) -> list:
    t = tracer_of(pkg)
    export = importlib.import_module(f"{pkg}.tracing.export")
    with t.trace_root("root") as tr:
        with t.span("encode"):
            pass
        with t.span("pack", jobs=2):
            pass
    events = export.to_chrome_events(tr)
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")} for e in events]


def test_chrome_export_equals_reference():
    port, ref = _export_shape(PORT), _export_shape(REF)
    for e in port + ref:
        e.get("args", {}).pop("trace_id", None)
        if e["name"] == "process_name":
            e["args"].pop("name")
        if e["name"] == "thread_name" and "host thread" in e["args"]["name"]:
            e["args"].pop("name")
    assert port == ref
