"""The port's device plane ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/tracing/deviceplane.py`` and
``solver/devicetime.py`` are the port's copies of the JAX package's
device plane. The reference's compile is XLA's, once per abstract call
signature; the port's is a kernel library's load (built first where
``_build/`` lacks it), once per library and process. Held, class by
class as ``tests/test_deviceplane.py`` holds the reference:

- the signature registry: signatures, counts, first-call ms, the 512
  cap with its eviction count, the off switch (the constant
  ``DEVICEPLANE``) a passthrough, and no compile event from a new launch
  shape or static argument, which compile nothing here;
- library loads: one load per library and process is one compile event,
  shared by the kernels of one source, attributed to the solve it ran
  in, or ``prewarm_replay`` inside ``prewarm_scope`` (a g++ build of a
  ``csrc`` source into a temporary ``BUILD_DIR``, never ``_build/``);
- steady ticks raise no compile event, seeded;
- the ``jitsig`` plane: export and import of the signature inventory,
  witness failures dropped, a round trip through the warm store;
- the metric surface: the families pass ``check_exposition``, a solve
  feeds its compile events, transfers and block to the metrics and the
  stats, ``/debug/device`` answers with the reference's keys;
- against the JAX package, the same seeded world under the native
  packer, the device scans and the LP backend: the stats ``device``
  block's keys and ``SCHEMA``, the set of boundaries with transfers, and
  the steady solve's compile count (0 in both);
- device time: no event pair and no memory poll off the card, nested
  scopes, ``device_wait`` spans labelled by boundary;
- the overhead guard at the reference's own bound (on ≤ off × 1.25 +
  2 ms).
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import json
import time

import numpy as np
import pytest
import torch

from test_torch_incremental import reset_both
from test_torch_kube_client import PORT, REF
from test_torch_oracle import _port_helpers

from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch.metrics import Metrics, check_exposition
from karpenter_core_tpu_torch.solver import devicetime, incremental, warmstore
from karpenter_core_tpu_torch.tracing import deviceplane

TEAMS = 4

# the reference's observe_jit names each of the port's kernels registers under
KERNEL_NAMES = {
    "kernels.allowed_kernel", "pack.ffd_pack_batched", "pack.pack_existing", "lp.dual_ascent",
    "disrupt.prefix_screen", "disrupt.subset_screen", "disrupt.single_screen",
}


@pytest.fixture(autouse=True)
def _fresh_device_plane(monkeypatch):
    from karpenter_core_tpu_torch.solver import backend

    monkeypatch.setattr(backend, "_RESTORED", None)  # a restore's kept manifest rows
    deviceplane.reset()
    incremental.reset()
    yield
    deviceplane.reset()
    incremental.reset()


def _helpers(pkg: str):
    return importlib.import_module("helpers") if pkg == REF else _port_helpers()


def world(pkg: str, seed: int, n: int = 96):
    """tests/test_deviceplane.py's world in ``pkg``: 16 types, one pool
    over four teams, ``n`` seeded pods."""
    h = _helpers(pkg)
    fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
    objects = importlib.import_module(f"{pkg}.kube.objects")
    provider = fake.FakeCloudProvider()
    provider.instance_types = [
        fake.new_instance_type(
            f"dp-{i}", {"cpu": str((i % 8) + 1), "memory": f"{2 * ((i % 8) + 1)}Gi", "pods": "110"}
        )
        for i in range(16)
    ]
    pool = h.make_nodepool(
        requirements=[objects.NodeSelectorRequirement("team", "In", [f"t{t}" for t in range(TEAMS)])]
    )
    rng = np.random.RandomState(seed)
    cpus, mems = ["100m", "250m", "500m", "1"], ["128Mi", "512Mi", "1Gi"]
    pods = [
        h.make_pod(
            name=f"dp-p{i}",
            requests={"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]},
            node_selector={"team": f"t{i % TEAMS}"},
            labels={"team": f"t{i % TEAMS}"},
        )
        for i in range(n)
    ]
    return provider, pool, pods


def scheduler(pkg: str, pool, provider, **kw):
    if pkg == REF:
        return importlib.import_module(f"{REF}.solver").TPUScheduler([pool], provider, **kw)
    return importlib.import_module(f"{PORT}.solver").TorchScheduler([pool], provider, device="cpu", **kw)


# ---------------------------------------------------------------------------


class TestSignatureRegistry:
    def test_launch_shapes_raise_no_compile_events(self):
        """The reference's ``first``/``new_shape``/``new_config`` causes
        come from XLA's per-signature compiles; a kernel here takes any
        shape, so the same calls raise none (and the names stay)."""
        calls = []
        f = deviceplane.wrap("t.f", lambda x, n=1: calls.append(1) or x, static_names=("n",))
        f(np.zeros(4), n=1)
        f(np.zeros(4), n=1)
        f(np.zeros(8), n=1)
        f(np.zeros(8), n=2)
        assert deviceplane.compile_count() == 0 and deviceplane.recent_compiles() == []
        rec = next(r for r in deviceplane.registry_state() if r["fn"] == "t.f")
        assert rec["calls"] == 4 and rec["compiles"] == 0 and len(rec["signatures"]) == 3
        assert len(calls) == 4
        assert (deviceplane.CAUSE_NEW_SHAPE, deviceplane.CAUSE_NEW_CONFIG) == ("new_shape", "new_config")

    def test_registry_state_inventory(self):
        f = deviceplane.wrap("t.inv", lambda x: x)
        f(torch.zeros((2, 3), dtype=torch.float32))
        f(torch.zeros((2, 3), dtype=torch.float32))
        rec = next(r for r in deviceplane.registry_state() if r["fn"] == "t.inv")
        assert rec["calls"] == 2 and rec["compiles"] == 0
        (sig,) = rec["signatures"]
        assert sig["count"] == 2 and sig["first_ms"] is not None
        assert [0, ["a", [2, 3], "torch.float32"]] in sig["shapes"]

    def test_consume_solve_block_shape(self, monkeypatch):
        from karpenter_core_tpu_torch.solver import compat_kernels

        monkeypatch.setattr(compat_kernels, "COMPAT_TILE_BYTES", 1024 * 1024)
        deviceplane.reset_solve()
        deviceplane.record_library("t.blk", "/nowhere/libt-000000000000.so", 2.0, True)
        deviceplane.record_transfer("h2d", 1000, phase="pack")
        deviceplane.record_transfer("h2d", 500, phase="lp")
        deviceplane.record_transfer("d2h", 200, phase="pack")
        deviceplane.record_footprint(512 * 1024)
        block = deviceplane.consume_solve(memory={"bytes_in_use": 7})
        assert set(block) == {
            "compiles", "compile_events", "transfer_bytes", "transfer_by_phase", "footprint_bytes",
            "tile_budget_mb", "tile_headroom_frac", "hbm",
        }
        assert block["compiles"] == 1
        event = block["compile_events"][0]
        assert (event["fn"], event["cause"], event["library"], event["built"]) == (
            "t.blk", "first", "libt-000000000000.so", True)
        assert block["transfer_bytes"] == {"h2d": 1500, "d2h": 200}
        assert block["transfer_by_phase"]["pack"] == {"h2d": 1000, "d2h": 200}
        assert block["footprint_bytes"] == 512 * 1024
        assert block["tile_budget_mb"] == 1.0
        assert block["tile_headroom_frac"] == pytest.approx(0.5)
        assert block["hbm"] == {"bytes_in_use": 7}
        assert deviceplane.consume_solve() is None  # the drain is one-shot
        json.dumps(block)

    def test_disabled_plane_is_a_passthrough(self, monkeypatch):
        monkeypatch.setattr(deviceplane, "DEVICEPLANE", False)
        f = deviceplane.wrap("t.off", lambda x: x * 2)
        assert f(3) == 6
        rec = next(r for r in deviceplane.registry_state() if r["fn"] == "t.off")
        assert rec["signatures"] == [] and rec["calls"] == 0
        deviceplane.reset_solve()
        deviceplane.record_transfer("h2d", 10**6, phase="pack")
        deviceplane.record_footprint(10**6)
        assert deviceplane.record_library("t.off", "/nowhere/libt.so", 1.0, False) is None
        assert deviceplane.consume_solve() is None
        assert deviceplane.totals()["transfer_bytes"] == {} and deviceplane.compile_count() == 0

    def test_signature_roster_bounded_with_eviction_counter(self):
        f = deviceplane.wrap("t.bound", lambda x: x)
        for n in range(deviceplane._SIGS_PER_FN + 10):
            f(np.zeros(n + 1))
        rec = next(r for r in deviceplane.registry_state() if r["fn"] == "t.bound")
        assert len(rec["signatures"]) == deviceplane._SIGS_PER_FN
        assert rec["evicted"] == 10

    def test_kernels_register_under_the_reference_names(self):
        import karpenter_core_tpu.disruption.tpu_repack  # noqa: F401 — registers the reference's screens
        import karpenter_core_tpu.solver.backends.lp  # noqa: F401
        import karpenter_core_tpu.solver.solver  # noqa: F401
        from karpenter_core_tpu.tracing import deviceplane as ref_deviceplane

        import karpenter_core_tpu_torch.disruption.screen_kernels  # noqa: F401
        import karpenter_core_tpu_torch.solver.backends.lp  # noqa: F401
        import karpenter_core_tpu_torch.solver.solver  # noqa: F401

        kernels = {name: k for name, k in buildlib.KERNELS.items() if name in KERNEL_NAMES}
        assert set(kernels) == KERNEL_NAMES
        by_name = {r["fn"]: r for r in deviceplane.registry_state()}
        for name, kernel in kernels.items():
            assert kernel.name == name and by_name[name]["source"] == kernel.src.rsplit("/", 1)[1]
            # the host entry point of the same name is registered through wrap()
            assert by_name[name]["call_site"].split(":")[0].endswith(".py")
        assert KERNEL_NAMES | {"kernels.compat_kernel"} <= set(ref_deviceplane._REGISTRY)


class _HostKernel(buildlib.CudaKernel):
    """A CudaKernel whose library is the source's g++ host build: the
    load path, its sharing and its compile event without nvcc."""

    def library(self) -> str:
        return buildlib.library_path(self.src, buildlib.HOST_CXX)

    def build(self):
        return buildlib.build_shared(self.src, buildlib.HOST_CXX, timeout=300.0)


class TestLibraryLoads:
    def test_one_load_per_library_is_one_compile_event(self, monkeypatch, tmp_path):
        monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(buildlib, "KERNELS", dict(buildlib.KERNELS))
        monkeypatch.setattr(buildlib, "_LIBS", {})
        monkeypatch.setattr(buildlib, "_LOADED", {})
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        prefix = _HostKernel("disrupt_screen.cu", "disrupt_prefix_host", args, name="t.host_prefix")
        singles = _HostKernel("disrupt_screen.cu", "disrupt_singles_host", args, name="t.host_singles")
        deviceplane.reset_solve()
        prefix.lib()
        singles.lib()
        block = deviceplane.consume_solve()
        assert block["compiles"] == 1 and deviceplane.compile_count() == 1
        (event,) = block["compile_events"]
        assert event["fn"] == "t.host_prefix" and event["cause"] == "first" and event["built"] is True
        (row,) = buildlib.loaded_libraries()
        assert row["source"] == "disrupt_screen.cu" and row["kernels"] == ["t.host_prefix", "t.host_singles"]
        assert row["library"] == event["library"] and row["compile_event"] and row["built"]

        # the plane's launches are the kernel's own counter, plane on or off
        buf = [np.zeros(16, dtype=np.int32) for _ in range(4)]
        out = np.zeros(16, dtype=np.uint8)
        call = [b.ctypes.data for b in buf] + [1, 1, out.ctypes.data]
        prefix.launch(*call)
        monkeypatch.setattr(deviceplane, "DEVICEPLANE", False)
        prefix.launch(*call)
        monkeypatch.setattr(deviceplane, "DEVICEPLANE", True)
        assert prefix.total_launches == 2 and deviceplane.launch_counts()["t.host_prefix"] == 2
        assert "t.host_singles" not in deviceplane.launch_counts()
        by_name = {r["fn"]: r for r in deviceplane.registry_state()}
        assert by_name["t.host_prefix"]["launches"] == 2 and by_name["t.host_singles"]["launches"] == 0

        # a fresh process (a fresh library table) loading the built file
        # inside the prewarm: a prewarm_replay, outside any solve's count
        monkeypatch.setattr(buildlib, "_LIBS", {})
        monkeypatch.setattr(buildlib, "_LOADED", {})
        again = _HostKernel("disrupt_screen.cu", "disrupt_prefix_host", args, name="t.host_prefix")
        deviceplane.reset_solve()
        with deviceplane.prewarm_scope() as events:
            again.lib()
        assert deviceplane.consume_solve()["compiles"] == 0
        assert [(e["cause"], e["built"]) for e in events] == [("prewarm_replay", False)]
        assert deviceplane.prewarm_compile_count() == 1 and deviceplane.compile_count() == 1


# ---------------------------------------------------------------------------


class TestSteadyTickZeroRecompile:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_steady_ticks_raise_no_compiles(self, seed):
        provider, pool, pods = world(PORT, seed)
        solver = scheduler(PORT, pool, provider)
        solver.solve(pods)
        base = deviceplane.compile_count()
        for tick in range(4):
            if tick % 2:
                p = pods[tick]
                p.metadata.resource_version = str(int(p.metadata.resource_version or 0) + 1)
            solver.solve(pods)
            assert solver.last_device_stats is not None
            assert solver.last_device_stats["compiles"] == 0, solver.last_device_stats["compile_events"]
        assert deviceplane.compile_count() == base


class TestJitsigSnapshotRoundTrip:
    def test_export_import_round_trip(self):
        f = deviceplane.wrap("t.rt", lambda x, n=1: x, static_names=("n",))
        f(np.zeros(4), n=1)
        f(np.zeros(8), n=1)
        rows = deviceplane.export_signatures()
        deviceplane.reset()
        restored, dropped = deviceplane.import_signatures(rows)
        assert restored >= 2 and dropped == 0
        (target,) = [t for t in deviceplane.replay_targets() if t["fn"] == "t.rt"]
        assert len(target["keys"]) == 2 and target["wrapper"] is f
        f(np.zeros(4), n=1)
        f(np.zeros(8), n=1)
        rec = next(r for r in deviceplane.registry_state() if r["fn"] == "t.rt")
        assert [s["restored"] for s in rec["signatures"]] == [False, False]
        assert [s["count"] for s in rec["signatures"]] == [1, 1]
        assert deviceplane.compile_count() == 0
        assert not [t for t in deviceplane.replay_targets() if t["fn"] == "t.rt"]

    def test_witness_failures_drop_rows(self):
        f = deviceplane.wrap("t.wit", lambda x, n=1: x, static_names=("n",))
        f(np.zeros(4), n=1)
        good = next(r for r in deviceplane.export_signatures() if r[0] == "t.wit")
        deviceplane.reset()
        restored, dropped = deviceplane.import_signatures(
            [
                ("t.renamed", good[1], good[2]),  # a function this process never registered
                ("t.wit", ("other_static",), good[2]),  # its static-argument names changed
                ("malformed",),
                good,
            ]
        )
        assert restored == 1 and dropped == 3

    def test_snapshot_restore_through_warmstore(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")  # the device scan's entry point
        warmstore.simulate_process_death()
        provider, pool, pods = world(PORT, 5)
        solver = scheduler(PORT, pool, provider)
        solver.solve(pods)
        solver.solve(pods)
        assert any(r["signatures"] for r in deviceplane.registry_state() if r["fn"] == "pack.ffd_pack_batched")
        path = solver.snapshot(directory=str(tmp_path))
        assert path is not None
        warmstore.simulate_process_death()
        assert not any(r["signatures"] for r in deviceplane.registry_state())
        provider2, pool2, _ = world(PORT, 5)
        solver2 = scheduler(PORT, pool2, provider2)
        outcome = solver2.restore(path)
        assert outcome["restored"].get("jitsig", 0) > 0 and "jitsig" not in outcome["dropped"], outcome
        _, _, pods2 = world(PORT, 5)
        solver2.solve(pods2)
        assert solver2.last_device_stats["compiles"] == 0


class TestMetricSurface:
    def test_new_families_pass_exposition_lint(self):
        m = Metrics()
        m.xla_compiles.inc(1, fn="pack.ffd_pack_batched", cause="first")
        m.xla_compiles.inc(1, fn="pack.ffd_pack_batched", cause="prewarm_replay")
        m.transfer_bytes.inc(4096, direction="h2d", phase="pack")
        m.transfer_bytes.inc(128, direction="d2h", phase="lp")
        m.hbm_high_water.set(2.5e9)
        text = m.registry.expose()
        assert check_exposition(text) == [], check_exposition(text)
        for family in ("karpenter_tpu_xla_compiles_total", "karpenter_tpu_solver_transfer_bytes_total",
                       "karpenter_tpu_hbm_high_water_bytes"):
            assert family in text

    def test_solver_pushes_compile_events_and_stats_block(self, monkeypatch):
        """A library load inside a solve (the compat entry point's, made
        to load one here) lands in the block, the stats and the metrics."""
        from karpenter_core_tpu_torch.solver import solver as solver_mod
        from karpenter_core_tpu_torch.solver import stats as solver_stats

        real = solver_mod.allowed_via_kernel
        loads = []

        def loading(*args, **kw):
            if not loads:
                loads.append(deviceplane.record_library("kernels.allowed_kernel", "/x/libcompat-0.so", 1.5, False))
            return real(*args, **kw)

        monkeypatch.setattr(solver_mod, "allowed_via_kernel", loading)
        monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
        provider, pool, pods = world(PORT, 1)
        metrics = Metrics()
        solver = scheduler(PORT, pool, provider, metrics=metrics)
        solver.solve(pods)
        doc = solver_stats.solve_stats(solver)
        dev = doc["device"]
        assert dev is not None and dev["compiles"] == 1 == deviceplane.compile_count()
        ev = dev["compile_events"][0]
        assert metrics.xla_compiles.get(fn=ev["fn"], cause=ev["cause"]) == 1
        for phase, dirs in dev["transfer_by_phase"].items():
            for direction, n in dirs.items():
                assert metrics.transfer_bytes.get(direction=direction, phase=phase) == n > 0
        assert dev["hbm"] is None  # off the card: no number for it
        assert solver_stats.bench_fields(doc)["device"]["compiles"] == 1
        assert check_exposition(metrics.registry.expose()) == []

    def test_debug_device_route_payload(self):
        from karpenter_core_tpu.operator.server import _device as ref_device
        from karpenter_core_tpu_torch.operator.server import _device

        f = deviceplane.wrap("t.route", lambda x: x)
        f(np.zeros(3))
        status, ctype, body = _device({})
        assert status == 200 and ctype == "application/json"
        payload = json.loads(body)
        assert set(payload) == set(json.loads(ref_device({})[2]))
        assert set(payload["totals"]) == set(json.loads(ref_device({})[2])["totals"])
        assert payload["enabled"] is True
        assert next(r for r in payload["registry"] if r["fn"] == "t.route")["calls"] == 1
        assert _device({"tail": ["nope"]})[0] == 400


# ---------------------------------------------------------------------------
# against the JAX package


def _engine(monkeypatch, engine: str) -> None:
    from test_torch_native import reference_native
    from test_torch_pack_device import device_engine_off_native

    if engine == "native":
        reference_native(monkeypatch)
    else:
        device_engine_off_native(monkeypatch)
    if engine == "lp":
        monkeypatch.setenv("KARPENTER_TPU_PACK_BACKEND", "lp")
        monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", "lp")


def _device_run(pkg: str, seed: int) -> dict:
    stats = importlib.import_module(f"{pkg}.solver.stats")
    provider, pool, pods = world(pkg, seed)
    solver = scheduler(pkg, pool, provider)
    labels = set()
    blocks = []
    for _ in range(2):  # the warm-up solve, then a steady one
        solver.solve(pods)
        block = stats.solve_stats(solver)["device"]
        blocks.append(block)
        labels |= set(block["transfer_by_phase"])
    return {"keys": set(blocks[-1]), "schema": stats.SCHEMA, "labels": labels,
            "steady_compiles": blocks[-1]["compiles"]}


@pytest.mark.parametrize("engine", ["native", "device", "lp"])
@pytest.mark.parametrize("seed", [3, 4])
def test_device_block_matches_reference(monkeypatch, engine, seed):
    _engine(monkeypatch, engine)
    reset_both()
    ref = _device_run(REF, seed)
    reset_both()
    port = _device_run(PORT, seed)
    assert port["keys"] == ref["keys"] and port["schema"] == ref["schema"]
    assert port["labels"] == ref["labels"]
    assert port["steady_compiles"] == ref["steady_compiles"] == 0
    if engine != "native":
        assert "pack" in port["labels"]


# ---------------------------------------------------------------------------


class _FakeEvent:
    def __init__(self, t: float):
        self.t = t

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end) -> float:
        return end.t - self.t


class TestDeviceTime:
    def test_no_pairs_and_no_memory_poll_off_the_card(self, monkeypatch):
        def touched(*a, **kw):
            raise AssertionError("torch.cuda touched off the card")

        monkeypatch.setattr(torch.cuda, "mem_get_info", touched)
        monkeypatch.setattr(torch.cuda, "Event", touched)
        with devicetime.scope("cpu") as clock:
            with devicetime.track(phase="pack"):
                pass
            assert devicetime.seconds() == 0.0
        assert clock.pairs == [] and clock.ms() == 0.0
        assert devicetime.device_memory_stats("cpu") is None
        assert devicetime.device_memory_stats(None) is None

    def test_nested_scope_adds_its_pairs_to_the_outer(self):
        with devicetime.scope("cpu") as outer:
            outer.pairs.append(("screen", [("cuda:0", _FakeEvent(0.0), _FakeEvent(2.0))]))
            with devicetime.scope("cpu") as inner:
                inner.pairs.append(("pack", [("cuda:0", _FakeEvent(1.0), _FakeEvent(1.5))]))
            assert inner.phase_ms() == {"pack": 0.5}
        assert outer.phase_ms() == {"screen": 2.0, "pack": 0.5} and outer.ms() == 2.5

    def test_track_is_a_device_wait_span_labelled_by_boundary(self):
        from karpenter_core_tpu_torch.tracing import tracer

        with tracer.trace_root("t", buffer_if="never") as tr:
            with devicetime.track(phase="existing"):
                pass
        (span,) = [s for s in tr.spans if s.name == "device_wait"]
        assert span.args == {"phase": "existing"}

    def test_transfer_accounts_tensor_bytes(self):
        deviceplane.reset_solve()
        devicetime.transfer("h2d", torch.zeros((4, 3), dtype=torch.int32), np.zeros(5, np.uint8), phase="pack")
        devicetime.transfer("d2h", nbytes=9, phase="pack")
        assert deviceplane.consume_solve()["transfer_by_phase"] == {"pack": {"h2d": 53, "d2h": 9}}


class TestOverheadGuard:
    def test_observation_overhead_within_budget(self, monkeypatch):
        """The reference's bound: warm-solve medians with the plane on
        within 25 % (plus 2 ms) of those with it off."""
        provider, pool, pods = world(PORT, 9)
        solver = scheduler(PORT, pool, provider)

        def median_warm_ms(runs=5):
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                solver.solve(pods)
                times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times)[len(times) // 2]

        solver.solve(pods)
        on = median_warm_ms()
        monkeypatch.setattr(deviceplane, "DEVICEPLANE", False)
        off = median_warm_ms()
        assert on <= off * 1.25 + 2.0, f"deviceplane on {on:.2f}ms vs off {off:.2f}ms"


def test_deviceplane_phase_cut_down(tmp_path):
    """``chip_smoke.py``'s phase 20 on the CPU, cut down: phase 5's
    cluster at 3,000 pods, config 10 under lp whole, config 4 at 300
    nodes, the restart in a fresh process (its first solve, then its
    first decision), the capture and the breach
    dump, three turns of on against off (medians of six solves each side:
    a loaded CPU's single solves vary past the bound). Off the card no launch, load or
    device time is counted, and the checks that need the card are not
    run."""
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phase20", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    out = chip_smoke.run_deviceplane_phase("cpu", n_pods=3000, n_types=200, n_nodes=60, config4_nodes=300, turns=3,
                                           workdir=str(tmp_path))
    assert set(out["launches"]) == set(chip_smoke.PLANE_KERNELS) and not any(out["launches"].values())
    assert out["compile_events"] == 0 and out["libraries_loaded"] == [] and out["hbm_high_water"] is None
    assert out["restart"]["compiles"] == 0 and out["restart"]["restored"].get("jitsig", 0) > 0
    assert out["restart"]["decision_action"] != "no-op" and out["restart"]["decision_compiles"] == 0
    assert out["restart"]["decision_screens"] == 0 and out["traced_launches"] == {}
    assert out["capture_files"] == 1 and out["breach_files"] == 1
    assert {k.split(".")[1] for k in out["transfers"]} == {"pack", "existing", "lp", "screen"}
    assert out["decision"]["action"] != "no-op" and out["cold"]["device_ms"] == 0
    assert len(out["compat_wrapper_ms"]["on"]) == len(out["compat_wrapper_ms"]["off"]) == 6
