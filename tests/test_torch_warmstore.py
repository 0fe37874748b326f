"""The port's warm-state persistence ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/solver/warmstore.py`` is the port's copy of
the JAX package's warm store over the planes the port keeps. Held to it:

- the tests of ``TestSnapshotRoundTrip``, ``TestInvalidationMatrix``,
  ``TestCorruptSnapshots``, ``TestServingPipelineHooks`` and
  ``TestWarmstoreDisabled`` of ``tests/test_warmstore.py`` run from their
  own source on the port (``TorchScheduler(device="cpu")``, the serving
  harness on ``device="cpu"``, ``KARPENTER_TORCH_INCREMENTAL``, the
  port's magic, and the directory and size cap the port keeps as
  constants set as constants), the consolidated stats schema
  (``solver/stats.py``) included, but ``test_restore_is_faster_than_cold``,
  a wall-clock comparison that says nothing of the port on the CPU;
- the tests of ``TestTenantMigration`` (a fleet tenant's snapshot
  restored into a second registry plans as the first did, warm on its
  first round; eviction and re-admission; the canonical-catalog plane's
  round trip) run on the port with ``FleetRegistry(device="cpu")``, and
  the registry's two cases without a store: no directory (eviction takes
  no snapshot) and the warm state's kill switch off (the restore at
  admission is dropped whole, the first round still plans the same);
- a port snapshot restored into a fresh port scheduler after a simulated
  process death plans as the JAX package's un-killed warm solver does;
- a snapshot the JAX package wrote is dropped whole by the port, and
  counted; a port snapshot restored on another device keeps its host
  planes and drops its device-computed ones, counted.
"""

from __future__ import annotations

import importlib

import pytest
import torch

from test_torch_incremental import cpu_scheduler, reset_both
from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_native import reference_native
from test_torch_oracle import same_start

FILE = "test_warmstore.py"
CLASSES = ("TestSnapshotRoundTrip", "TestInvalidationMatrix", "TestCorruptSnapshots", "TestServingPipelineHooks",
           "TestWarmstoreDisabled")
LEFT_OUT = ("test_restore_is_faster_than_cold",)
CASES = [c for c in mirror_cases(FILE, classes=CLASSES) if c[1] not in LEFT_OUT]
MIGRATION_CASES = mirror_cases(FILE, classes=("TestTenantMigration",))


def warmstore_mirror():
    replace = (
        ("from {pkg}.solver import TPUScheduler, incremental, warmstore",
         "from {pkg}.solver import incremental, warmstore"),
        ("@pytest.fixture(autouse=True)\n", ""),
        ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"),
        ('b"KTPU-WARMSTORE\\n"', 'b"KTORCH-WARMSTORE\\n"'),
        ('monkeypatch.setenv("KARPENTER_TPU_WARMSTORE_MAX_MB", "0.02")', 'monkeypatch.setattr(warmstore, "MAX_MB", 0.02)'),
        ('monkeypatch.delenv("KARPENTER_TPU_WARMSTORE_DIR", raising=False)',
         'monkeypatch.setattr(warmstore, "WARMSTORE_DIR", None)'),
        ("tg.TrafficHarness(", 'tg.TrafficHarness(device="cpu", '),
        ("FleetRegistry(warmstore_dir=str(tmp_path))", 'FleetRegistry(warmstore_dir=str(tmp_path), device="cpu")'),
    )
    return mirror(FILE, PORT, replace=replace, inject={"TPUScheduler": cpu_scheduler})


def test_mirror_covers_the_classes():
    assert len(CASES) == 24
    assert {c[0] for c in CASES} == set(CLASSES)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_warmstore_case_holds_the_port(monkeypatch, tmp_path, case):
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    mod = warmstore_mirror()
    fresh = mod._fresh_state()
    next(fresh)
    try:
        run_mirrored(mod, *case, extra={"monkeypatch": monkeypatch, "tmp_path": tmp_path})
    finally:
        for _ in fresh:
            pass


def test_migration_mirror_covers_the_class():
    assert len(MIGRATION_CASES) == 3


@pytest.mark.parametrize("case", MIGRATION_CASES, ids=[case_id(c) for c in MIGRATION_CASES])
def test_tenant_migration_case_holds_the_port(monkeypatch, tmp_path, case):
    for env in ("KARPENTER_TORCH_INCREMENTAL", "KARPENTER_TORCH_FLEET_ENGINE"):
        monkeypatch.delenv(env, raising=False)
    test_warmstore_case_holds_the_port(monkeypatch, tmp_path, case)


def _fleet_tenant(mod, registry, tid: str, seed: int):
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider

    provider = FakeCloudProvider()
    provider.instance_types = mod._catalog()
    provider.bump_catalog_generation()
    pool = NodePool()
    pool.metadata.name = "default"
    registry.add_tenant(tid, [pool], provider)
    return mod.TestTenantMigration()._tenant_pods(seed=seed)


def test_registry_without_a_directory_evicts_without_a_snapshot(monkeypatch):
    from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry

    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    mod = warmstore_mirror()
    registry = FleetRegistry(device="cpu")
    engine = FleetEngine(registry)
    assert registry.warmstore_dir is None
    pods = _fleet_tenant(mod, registry, "tenant-c", 19)
    assert engine.solve_round({"tenant-c": pods})["tenant-c"].error is None
    assert registry.snapshot_tenant("tenant-c") is None and registry.snapshot_plane() is None
    assert registry.remove_tenant("tenant-c") and registry.evicted_snapshots == {}
    _fleet_tenant(mod, registry, "tenant-c", 19)
    assert registry.get("tenant-c").prewarm_replay is None  # admitted cold


def test_registry_restore_with_the_kill_switch_off(monkeypatch, tmp_path):
    """A snapshot restored at admission while ``KARPENTER_TORCH_INCREMENTAL=0``
    is dropped whole; the tenant's first round plans as the writer's did."""
    from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry

    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    mod = warmstore_mirror()
    migration = mod.TestTenantMigration()
    registry = FleetRegistry(warmstore_dir=str(tmp_path), device="cpu")
    engine = FleetEngine(registry)
    ref = engine.solve_round({"tenant-d": _fleet_tenant(mod, registry, "tenant-d", 23)})["tenant-d"]
    path = registry.snapshot_tenant("tenant-d")
    assert path is not None
    importlib.import_module(f"{PORT}.solver.warmstore").simulate_process_death()
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    registry2 = FleetRegistry(warmstore_dir=str(tmp_path), device="cpu")
    engine2 = FleetEngine(registry2)
    provider = importlib.import_module(f"{PORT}.cloudprovider.fake").FakeCloudProvider()
    provider.instance_types = mod._catalog()
    provider.bump_catalog_generation()
    pool = importlib.import_module(f"{PORT}.apis.nodepool").NodePool()
    pool.metadata.name = "default"
    handle = registry2.add_tenant("tenant-d", [pool], provider, restore_from=path)
    outcome = handle.solver.last_warmstore_stats
    assert outcome["reason"] == "incremental path disabled" and not outcome["restored"]
    assert handle.prewarm_replay["status"] == "ok" and handle.prewarm_replay["device"] == "cpu"
    out = engine2.solve_round({"tenant-d": migration._tenant_pods(seed=23)})["tenant-d"]
    assert migration._plan_keys(out) == migration._plan_keys(ref)


# -- across packages ---------------------------------------------------------------


def mirrored_module(pkg: str):
    """test_warmstore.py's world-making functions for ``pkg``."""
    if pkg == PORT:
        return warmstore_mirror()
    return mirror(FILE, REF, replace=(("@pytest.fixture(autouse=True)\n", ""),))


def test_port_snapshot_restored_plans_as_reference_unkilled(monkeypatch, tmp_path):
    reference_native(monkeypatch)
    reset_both()
    for env in ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    port, ref = mirrored_module(PORT), mirrored_module(REF)
    specs = ref._specs(7, n=120)
    same_start(monkeypatch)
    ref_provider, ref_pool, ref_pods = ref._world(specs)
    ref_solver = importlib.import_module(f"{REF}.solver").TPUScheduler([ref_pool], ref_provider)
    for _ in range(2):
        ref_res = ref_solver.solve(ref_pods)

    port_warmstore = importlib.import_module(f"{PORT}.solver.warmstore")
    same_start(monkeypatch)
    path, unkilled = port._snapshot_world(specs, tmp_path)
    port_warmstore.simulate_process_death()
    same_start(monkeypatch)
    provider, pool, pods = port._world(specs)
    solver = cpu_scheduler([pool], provider)
    outcome = solver.restore(path)
    assert outcome["restored"].get("catalog") == 1 and not outcome["dropped"]
    res = solver.solve(pods)
    assert port._canon(res) == unkilled == ref._canon(ref_res)
    hits = solver.last_cache_stats["hits"]
    assert hits.get("compat", 0) >= 1 and hits.get("job", 0) >= 1


def test_restore_outcome_surfaced_in_solver_and_metrics(monkeypatch, tmp_path):
    """What a restore installed is never silent: the outcome stands in
    ``last_warmstore_stats`` after the first solve and in the
    ``warmstore_restored`` counters, plane by plane."""
    reset_both()
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    port = mirrored_module(PORT)
    warmstore = importlib.import_module(f"{PORT}.solver.warmstore")
    specs = port._specs(2, n=60)
    path, _ = port._snapshot_world(specs, tmp_path)
    warmstore.simulate_process_death()
    provider, pool, pods = port._world(specs)
    metrics = importlib.import_module(f"{PORT}.metrics").Metrics()
    solver = cpu_scheduler([pool], provider, metrics=metrics)
    outcome = solver.restore(path)
    solver.solve(pods)
    assert solver.last_warmstore_stats["restored"] == outcome["restored"]
    assert outcome["restored"]["catalog"] == 1
    assert metrics.warmstore_restored.get(plane="catalog") == 1
    assert metrics.warmstore_restored.get(plane="job") >= 1


def test_reference_snapshot_is_dropped_whole_and_counted(monkeypatch, tmp_path):
    reference_native(monkeypatch)
    reset_both()
    for env in ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    ref = mirrored_module(REF)
    specs = ref._specs(8, n=60)
    ref_path, _ = ref._snapshot_world(specs, tmp_path)
    port = mirrored_module(PORT)
    metrics = importlib.import_module(f"{PORT}.metrics").Metrics()
    provider, pool, pods = port._world(specs)
    solver = cpu_scheduler([pool], provider, metrics=metrics)
    outcome = solver.restore(ref_path)
    assert outcome["restored"] == {} and outcome["reason"] == "bad magic"
    assert outcome["dropped"] == {"snapshot": 1}
    assert metrics.warmstore_dropped.get(plane="snapshot") == 1
    assert solver.solve(pods).node_plans


def test_snapshot_on_another_device_keeps_host_planes_only(monkeypatch, tmp_path):
    """The device-computed planes of a CPU snapshot never reach a solver
    on the card; the host planes (catalog, route, intersects) do. The
    solver only names the card: the restore launches nothing."""
    reset_both()
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    port = mirrored_module(PORT)
    warmstore = importlib.import_module(f"{PORT}.solver.warmstore")
    incremental = importlib.import_module(f"{PORT}.solver.incremental")
    specs = port._specs(9, n=80)
    path, _ = port._snapshot_world(specs, tmp_path)
    warmstore.simulate_process_death()
    provider, pool, pods = port._world(specs)
    solver = cpu_scheduler([pool], provider)
    solver.device = torch.device("cuda")
    outcome = solver.restore(path)
    assert outcome["restored"].get("catalog") == 1 and outcome["restored"].get("route", 0) >= 1
    assert outcome["dropped"].get("job", 0) >= 1 and outcome["dropped"].get("compat", 0) >= 1
    for plane in ("compat", "job", "merge", "emit", "mergerow"):
        assert plane not in outcome["restored"]
    assert len(incremental.warm_state_for(solver).jobs) == 0


# -- the kernel planes: the signature inventory and the library manifest ----------

# one world's source, run in this process and in a fresh one: a seeded
# batch over sixteen types, every object built anew
WORLD = '''
import numpy as np
from chip_smoke import pending_pod
from karpenter_core_tpu_torch.apis.nodepool import NodePool
from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types


def fresh_world(seed, n=120):
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(16)
    pool = NodePool()
    pool.metadata.name = "default"
    rng = np.random.RandomState(seed)
    pods = [pending_pod(f"ws-{i}", ["100m", "500m", "1"][rng.randint(3)], ["256Mi", "1Gi"][rng.randint(2)])
            for i in range(n)]
    return provider, pool, pods


def canon(res):
    return sorted([p.instance_type.name, p.zone, p.capacity_type, round(p.price, 9), sorted(p.pod_indices)]
                  for p in res.node_plans)
'''


def _world_module():
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    ns: dict = {}
    exec(WORLD, ns)
    return ns


def _live_row(source: str, kernels: list) -> dict:
    import os

    from karpenter_core_tpu_torch import buildlib

    return {"source": source, "library": os.path.basename(buildlib.kernel_library_path(source)), "kernels": kernels}


def test_library_manifest_drops_what_the_live_tree_builds_differently(monkeypatch):
    """A manifest row whose library the live tree would build to another
    file (another source or command hash), names a missing source or a
    kernel this process does not bind, is dropped and counted; the kept
    rows are what the boot prewarm loads, until a process death."""
    import karpenter_core_tpu_torch.disruption.screen_kernels  # noqa: F401 — binds the screens
    from karpenter_core_tpu_torch.solver import backend, prewarm

    monkeypatch.setattr(backend, "_RESTORED", None)
    monkeypatch.setattr(prewarm, "_LAST", None)
    screens = _live_row("disrupt_screen.cu", ["disrupt.prefix_screen", "disrupt.subset_screen"])
    stale = dict(_live_row("ffd_pack.cu", ["pack.ffd_pack_batched"]), library="libffd_pack-000000000000.so")
    kept, dropped = backend.restore_library_manifest([
        screens, stale,
        {"source": "gone.cu", "library": "libgone-000000000000.so", "kernels": []},
        dict(screens, kernels=["t.unbound"]),
        {"source": "ffd_pack.cu"},
    ])
    assert kept == [screens] and dropped == 4
    assert backend.compile_cache_status()["status"] == "restored"
    # on the CPU the prewarm loads nothing of the card, whatever the manifest names
    out = prewarm.warmup_compile_only(cpu_scheduler([], None))
    assert out["compile_events"] == 0 and all(name == "native_pack" for name in out["libraries"])
    importlib.import_module(f"{PORT}.solver.warmstore").simulate_process_death()
    assert backend.restored_manifest() == [] and backend.compile_cache_status()["status"] == "live"


def test_restore_in_a_fresh_process_first_solve_loads_nothing(monkeypatch, tmp_path):
    """Snapshot a warm solver here; in a fresh interpreter restore it,
    run the boot prewarm, then the first solve: its device block counts 0
    compile events, its plan is the unkilled one's, its compat rows and
    jobs come from the snapshot, and both kernel planes restored (the
    manifest's stale row dropped and counted). A crash of the child fails
    this test only."""
    import json
    import os
    import subprocess
    import sys

    from karpenter_core_tpu_torch import buildlib

    reset_both()
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    rows = [
        _live_row("disrupt_screen.cu", ["disrupt.single_screen"]),
        dict(_live_row("ffd_pack.cu", ["pack.ffd_pack_batched"]), library="libffd_pack-000000000000.so"),
    ]
    monkeypatch.setattr(buildlib, "loaded_libraries", lambda: [dict(r) for r in rows])
    w = _world_module()
    provider, pool, pods = w["fresh_world"](11)
    solver = cpu_scheduler([pool], provider)
    for _ in range(2):
        res = solver.solve(pods)
    unkilled = w["canon"](res)
    path = solver.snapshot(directory=str(tmp_path))
    assert path is not None
    child = WORLD + f'''
import json
import karpenter_core_tpu_torch.disruption.screen_kernels
from karpenter_core_tpu_torch.solver import TorchScheduler, prewarm

provider, pool, pods = fresh_world(11)
solver = TorchScheduler([pool], provider, device="cpu")
outcome = solver.restore({path!r})
boot = prewarm.warmup_compile_only(solver)
res = solver.solve(pods)
print(json.dumps({{"outcome": outcome, "boot": boot, "compiles": solver.last_device_stats["compiles"],
                  "hits": solver.last_cache_stats["hits"], "canon": canon(res)}}))
'''
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "KARPENTER_TORCH_INCREMENTAL"}
    proc = subprocess.run([sys.executable, "-c", child], cwd=repo, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    outcome = got["outcome"]
    assert outcome["restored"].get("jitsig", 0) > 0 and outcome["restored"].get("compilecache") == 1, outcome
    assert outcome["dropped"] == {"compilecache": 1}, outcome
    assert got["boot"]["status"] == "ok" and got["boot"]["compile_events"] == 0
    assert got["compiles"] == 0
    assert got["canon"] == json.loads(json.dumps(unkilled))
    assert got["hits"].get("compat", 0) >= 1 and got["hits"].get("job", 0) >= 1
