"""The port's fleet ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/fleet/`` is the port's copy of the JAX
package's fleet (registry, mega-solve engine, scheduler). Held to it:

- every test of ``tests/test_fleet.py`` runs from its own source on the
  port (``FleetRegistry(device="cpu")``, ``KARPENTER_TORCH_*`` for the
  engine switch and the catalog cap, the reference's other fleet knobs
  set as the port's constants);
- the same seeded tenants (mixed catalog archetypes, a catalog mutation
  between rounds) through both packages' ``FleetEngine``, batched and
  solo, and with the C++ packer off (the FFD scan's plain version, whose
  batched calls mix tenants): every tenant's plans in every round equal
  the JAX package's;
- ``chip_smoke.py``'s ``fleet_run`` at 8 × 40 over 3 rounds against
  ``bench.py``'s ``fleet_run``, plan for plan;
- the content plane serving a canonical catalog and a job skeleton to a
  second tenant, the catalog entries' owners under tenant churn, and the
  kernels' launch counter under eight launching threads.

Tolerance: exact equality throughout (plans are integers, names and
prices from the same catalogs).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import os
import threading

import numpy as np
import pytest

from test_torch_incremental import cpu_scheduler
from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_native import reference_native
from test_torch_oracle import same_start
from test_torch_pack_device import device_engine_off_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE = "test_fleet.py"
CASES = mirror_cases(FILE)


def fleet_mirror():
    """test_fleet.py on the port: the registry on the CPU, the engine
    switch and catalog cap the port's knobs, the other fleet knobs its
    constants."""
    mega = f"importlib.import_module('{PORT}.fleet.megasolve')"
    sched = f"importlib.import_module('{PORT}.fleet.scheduler')"
    replace = (
        ("@pytest.fixture(autouse=True)\n", ""),
        ("KARPENTER_TPU_FLEET_ENGINE", "KARPENTER_TORCH_FLEET_ENGINE"),
        ("KARPENTER_TPU_CATALOG_CACHE_MAX", "KARPENTER_TORCH_CATALOG_CACHE_MAX"),
        ('monkeypatch.setenv("KARPENTER_TPU_FLEET_ADMIT_CAP", "50")',
         f'monkeypatch.setattr({sched}, "FLEET_ADMIT_CAP", 50)'),
        ('monkeypatch.setenv("KARPENTER_TPU_FLEET_WORKERS", "4")', f'monkeypatch.setattr({mega}, "FLEET_WORKERS", 4)'),
        ('monkeypatch.setenv("KARPENTER_TPU_FLEET_WORKERS", "1")', f'monkeypatch.setattr({mega}, "FLEET_WORKERS", 1)'),
        ('monkeypatch.setenv("KARPENTER_TPU_FLEET_TENANT_LABELS", "3")',
         f'monkeypatch.setattr({mega}, "FLEET_TENANT_LABELS", 3)'),
        ("FleetRegistry()", 'FleetRegistry(device="cpu")'),
        # the port's scheduler class, on the CPU (injected)
        ("from {pkg}.solver import TPUScheduler", "pass"),
    )
    return mirror(FILE, PORT, replace=replace, inject={"TPUScheduler": cpu_scheduler, "importlib": importlib})


def test_mirror_covers_the_file():
    assert len(CASES) == 15 and len({c[1] for c in CASES}) == 13


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_fleet_case_holds_the_port(monkeypatch, case):
    for env in ("KARPENTER_TORCH_FLEET_ENGINE", "KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    mod = fleet_mirror()
    fresh = mod._fresh_state(monkeypatch)
    next(fresh)
    try:
        run_mirrored(mod, *case, extra={"monkeypatch": monkeypatch})
    finally:
        for _ in fresh:
            pass


# -- across packages ---------------------------------------------------------------

KINDS = ("plain", "gpu", "narrow", "plain", "gpu")
SIZES = (12, 30, 2, 30, 18)


def _fleet_rounds(pkg: str, engine: str, seed: int, monkeypatch) -> list:
    """Five tenants of mixed archetypes through ``pkg``'s FleetEngine on
    ``engine``: a burst, t1's catalog replaced, a second round. → per
    round, {tenant: sorted plan keys}."""
    mod = fleet_mirror() if pkg == PORT else mirror(FILE, REF, replace=(("@pytest.fixture(autouse=True)\n", ""),))
    fleet = importlib.import_module(f"{pkg}.fleet")
    monkeypatch.setenv("KARPENTER_TPU_FLEET_ENGINE" if pkg == REF else "KARPENTER_TORCH_FLEET_ENGINE", engine)
    same_start(monkeypatch)
    reg = fleet.FleetRegistry(device="cpu") if pkg == PORT else fleet.FleetRegistry()
    eng = fleet.FleetEngine(reg)
    rng = np.random.RandomState(seed)
    work = {}
    for t, (kind, size) in enumerate(zip(KINDS, SIZES)):
        tid = f"t{t}"
        work[tid] = mod._add_tenant(reg, tid, mod._catalog(kind, size), pods_seed=seed * 100 + rng.randint(50),
                                    n_pods=30 + 10 * t, gpu_frac=0.2 if kind == "gpu" else 0.0)
    rounds = [{t: mod._plan_keys(o) for t, o in eng.solve_round(work).items()}]
    reg.get("t1").provider.set_instance_types(mod._catalog("plain", 8))
    work2 = {tid: mod._pods(tid + "r2", 25, seed * 100 + 7 + i) for i, tid in enumerate(sorted(work))}
    rounds.append({t: mod._plan_keys(o) for t, o in eng.solve_round(work2).items()})
    return rounds


def _reset_both() -> None:
    for pkg in (REF, PORT):
        importlib.import_module(f"{pkg}.solver.incremental").reset()
        importlib.import_module(f"{pkg}.solver.solver")._CATALOG_CACHE.clear()
        importlib.import_module(f"{pkg}.solver.backends").reset_for_tests()


@pytest.mark.parametrize("native", ["on", "off"])
@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_plans_equal_the_reference(monkeypatch, seed, native):
    """Batched and solo on both packages, every tenant every round: the
    port's plans equal the JAX package's. With the C++ packer off the
    port's batched flushes pad every tenant's jobs of a class to the
    flush's largest frontier in one scan call."""
    reference_native(monkeypatch)
    if native == "off":
        device_engine_off_native(monkeypatch)
    for env in ("KARPENTER_TPU_CATALOG_CACHE_MAX", "KARPENTER_TORCH_CATALOG_CACHE_MAX"):
        monkeypatch.setenv(env, "64")
    out = {}
    for pkg in (REF, PORT):
        for engine in ("solo", "batched"):
            _reset_both()
            out[(pkg, engine)] = _fleet_rounds(pkg, engine, seed, monkeypatch)
    ref = out[(REF, "solo")]
    assert out[(REF, "batched")] == ref
    assert out[(PORT, "solo")] == ref
    assert out[(PORT, "batched")] == ref


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_fleet", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_run_equals_bench(monkeypatch, chip_smoke):
    """``chip_smoke.fleet_run`` (bench config 11's world on the port) at 8
    tenants × 40 pods over 3 rounds, both engines, against
    ``bench.py::fleet_run``'s plans, cell by cell."""
    reference_native(monkeypatch)
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE", raising=False)
    # bench.fleet_run writes these two: restored after the test
    monkeypatch.setenv("KARPENTER_TPU_FLEET_ENGINE", "batched")
    monkeypatch.setenv("KARPENTER_TPU_CATALOG_CACHE_MAX", "32")
    spec = importlib.util.spec_from_file_location("bench_fleet", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    _reset_both()
    ref = bench.fleet_run(8, 40, "solo", rounds=3, collect_plans=True)["plans"]
    assert len(ref) == 24
    for engine in ("solo", "batched"):
        _reset_both()
        run = chip_smoke.fleet_run(8, 40, engine, "cpu", rounds=3, collect_plans=True)
        assert run["plans"] == ref, engine
        assert run["steady_round_builds"] == 0 and run["pods_decided"] == 8 * (40 + 4 + 4)
    assert run["dispatch"]["flushes"] < run["dispatch"]["pack_calls"]


# -- the content plane and the catalog entries' owners ------------------------------


def _port_world(reg, tid: str, catalog, n_pods: int = 40, seed: int = 7):
    mod = fleet_mirror()
    pods = mod._add_tenant(reg, tid, catalog, pods_seed=seed, n_pods=n_pods)
    return pods


def test_content_plane_serves_a_second_tenant(monkeypatch):
    """One batched round, one worker: the second content twin reads the
    first's canonical catalog (one encoded entry, its compat rows) and is
    served a job skeleton the first published."""
    from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry, megasolve
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    _reset_both()
    monkeypatch.setenv("KARPENTER_TORCH_FLEET_ENGINE", "batched")
    monkeypatch.setattr(megasolve, "FLEET_WORKERS", 1)
    reg = FleetRegistry(device="cpu")
    eng = FleetEngine(reg)
    cat = fleet_mirror()._catalog("plain", 14)
    work = {tid: _port_world(reg, tid, list(cat)) for tid in ("a", "b")}
    out = eng.solve_round(work)
    assert all(o.error is None for o in out.values())
    a, b = reg.get("a"), reg.get("b")
    assert a.view.get_instance_types(None) is b.view.get_instance_types(None)
    assert reg.plane.stats.to_dict()["hits"].get("fleetcanon", 0) >= 1
    assert b.solver.last_cache_stats["hits"].get("fleetjob", 0) >= 1
    assert b.solver.last_cache_stats["hits"].get("compat", 0) >= 1  # a's rows on the shared entry
    entries = [e for e in solver_mod._CATALOG_CACHE.values() if any(o is a.view for o in e.owners)]
    assert len(entries) == 1 and b.view in entries[0].owners
    # the plane's keys are the job keys less the tenant scope: the device stays
    keys = [k for k, _ in eng.skeletons._skeletons.items()]
    assert keys and all(k[-1] == "cpu" for k in keys)


def test_twins_launch_compat_once_and_entries_follow_their_owners(monkeypatch):
    """Batched, content twins (each its own catalog objects) share one
    entry: with one worker the compat wrapper is called once for them,
    against once a tenant solo. Removing one twin keeps the entry its
    twins hold; removing the tenant that alone held an entry releases it
    at the next lookup."""
    from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry, megasolve
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    monkeypatch.setenv("KARPENTER_TORCH_CATALOG_CACHE_MAX", "64")
    monkeypatch.setattr(megasolve, "FLEET_WORKERS", 1)
    calls = {}
    real = solver_mod.allowed_via_kernel
    for engine in ("solo", "batched"):
        _reset_both()
        n = [0]

        def spy(*args, _n=n, **kw):
            _n[0] += 1
            return real(*args, **kw)

        monkeypatch.setattr(solver_mod, "allowed_via_kernel", spy)
        reg = FleetRegistry(device="cpu")
        eng = FleetEngine(reg, engine=engine)
        mod = fleet_mirror()
        work = {tid: _port_world(reg, tid, mod._catalog("plain", 14)) for tid in ("a", "b", "c")}
        work["lone"] = _port_world(reg, "lone", mod._catalog("gpu", 20))
        assert all(o.error is None for o in eng.solve_round(work).values())
        calls[engine] = n[0]
    assert calls == {"solo": 4, "batched": 2}, calls

    def owned_by(view):
        return [e for e in solver_mod._CATALOG_CACHE.values() if any(o is view for o in e.owners)]

    shared = owned_by(reg.get("b").view)
    lone = owned_by(reg.get("lone").view)
    assert len(shared) == 1 and len(lone) == 1 and shared[0] is not lone[0]
    assert reg.remove_tenant("a") and reg.remove_tenant("lone")
    gc.collect()
    eng.solve_round({"b": fleet_mirror()._pods("b2", 10, 3)})
    live = list(solver_mod._CATALOG_CACHE.values())
    assert any(e is shared[0] for e in live)
    assert not any(e is lone[0] for e in live)


def test_flush_refuses_lanes_on_two_devices():
    """A flush carries one device: lanes on two raise, each waiter woken
    with the error."""
    from karpenter_core_tpu_torch.fleet import megasolve
    from karpenter_core_tpu_torch.solver import backends

    dispatcher = megasolve._MegaDispatcher(backends.get_backend("ffd"))
    job = (np.ones((2, 3), dtype=np.int32), np.full((1, 3), 8, dtype=np.int32), np.int32(110))
    lanes = [megasolve._PackWait([job], [{}], "cpu"), megasolve._PackWait([job], [{}], "meta")]
    dispatcher._run_batch(lanes)
    assert all(w.done and isinstance(w.error, ValueError) for w in lanes)
    same = [megasolve._PackWait([job], [{}], "cpu") for _ in range(2)]
    dispatcher._run_batch(same)
    assert all(w.error is None and len(w.results) == 1 for w in same)


def test_registry_defaults_to_the_card():
    """``FleetRegistry()`` means the card; without one it raises."""
    import torch

    from karpenter_core_tpu_torch.fleet import FleetRegistry

    if torch.cuda.is_available():
        assert FleetRegistry().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            FleetRegistry()


def test_fleet_constants_are_the_reference_defaults():
    from karpenter_core_tpu_torch.fleet import megasolve, scheduler
    from karpenter_core_tpu_torch.solver import incremental, solver

    assert (megasolve.FLEET_WORKERS, megasolve.FLEET_JOIN_TIMEOUT_S, megasolve.FLEET_TENANT_LABELS) == (4, 300, 64)
    assert (scheduler.FLEET_QUANTUM, scheduler.FLEET_WINDOW_MS, scheduler.FLEET_ADMIT_CAP) == (1000, 2.0, 10_000)
    assert [incremental.cache_cap(k) for k in ("fleetenv", "fleetcanon", "fleetjob")] == [1024, 64, 2048]
    assert solver.catalog_cache_max() == 8


# -- the kernels' launch counter under concurrency ----------------------------------


def test_launch_counter_exact_under_eight_threads():
    """Eight threads launch through a stubbed library 10,000 times each,
    switching often: the count is exact, and every count is taken under the
    kernel's lock (a bare ``+=`` can lose updates on an interpreter that
    switches threads inside it)."""
    import sys

    from karpenter_core_tpu_torch import buildlib

    kernel = buildlib.CudaKernel("ffd_pack.cu", "stub_launch", [])

    class Lib:
        @staticmethod
        def stub_launch(*args):
            return 0

    class CountingLock:
        def __init__(self):
            self.lock, self.held = threading.Lock(), 0

        def __enter__(self):
            self.lock.acquire()
            self.held += 1

        def __exit__(self, *exc):
            self.lock.release()

    kernel._lib = Lib()
    kernel._lock = CountingLock()
    start = threading.Barrier(8)

    def launch_many():
        start.wait()
        for _ in range(10_000):
            kernel.launch()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch_many, daemon=True) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 80_000 and kernel._lock.held == 80_000
