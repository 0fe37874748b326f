"""The port's cross-tick warm state ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/solver/incremental.py`` is the port's copy of
the JAX package's incremental layer (solve replay, route, compat-row,
job, merge, emit, screen-row and seed memos). Held to it:

- every test of ``tests/test_incremental.py`` (churn canary, no-op tick,
  the invalidation matrix, cache bounds, the kill switch, the metrics)
  runs from its own source on the port: ``TorchScheduler(device="cpu")``
  for ``TPUScheduler``, ``KARPENTER_TORCH_INCREMENTAL`` for
  ``KARPENTER_TPU_INCREMENTAL``, and the cap knobs the port keeps as
  constants set as constants (and ``last_trace_id`` for the reference's
  ``last_timings["trace_id"]``);
- seeded churn sequences (pods added, dropped and resized, a catalog
  price mutation under a generation bump, a pool weight change, no-op
  ticks; one sequence under the ``lp`` backend, one against a kube
  store and cluster, for the seed memo) run tick by tick through a warm
  ``TPUScheduler`` and a warm
  ``TorchScheduler(device="cpu")``. Equal, exactly: each package's warm
  plans and its own cold solve's, the two packages' plan streams, and
  the hit and miss counts of every cache in ``last_cache_stats``;
- the warm-state registry and the compat rows are keyed by device, so a
  CPU solve never fills what a card solve serves;
- the job key keeps isomorphic host-port universes apart (the JAX
  test's own source on both packages), an ``lp`` job hit keeps its cost
  guard, and a pack-configuration switch between unchanged ticks packs
  again (the reference replays: ROADMAP C9);
- ``chip_smoke.py``'s phase 14 runs cut down.
"""

from __future__ import annotations

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_native import reference_native
from test_torch_oracle import _port_helpers, same_start

FILE = "test_incremental.py"
CASES = mirror_cases(FILE)


def cpu_scheduler(*args, **kwargs):
    from karpenter_core_tpu_torch.solver import TorchScheduler

    return TorchScheduler(*args, device="cpu", **kwargs)


def incremental_mirror():
    """test_incremental.py on the port: its autouse fixture a plain
    generator (run around each case), the scheduler the port's on the
    CPU, the job cap the port's constant, the catalog cap the port's
    knob."""
    replace = (
        ("from {pkg}.solver import TPUScheduler, incremental", "from {pkg}.solver import incremental"),
        ("@pytest.fixture(autouse=True)\n", ""),
        ('monkeypatch.setenv("KARPENTER_TPU_JOB_CACHE_MAX", "2")', 'monkeypatch.setitem(incremental._CAPS, "job", 2)'),
        ("KARPENTER_TPU_CATALOG_CACHE_MAX", "KARPENTER_TORCH_CATALOG_CACHE_MAX"),
        ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"),
        # the port keeps last_timings numeric: the trace id is its own field
        ('warm.last_timings["trace_id"]', "warm.last_trace_id"),
    )
    return mirror(FILE, PORT, replace=replace, inject={"TPUScheduler": cpu_scheduler})


def test_mirror_covers_the_file():
    assert len(CASES) == 18
    assert ("TestNoopTick", "test_noop_tick_full_hit_and_zero_pack_spans", 0) in CASES


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_incremental_case_holds_the_port(monkeypatch, case):
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    mod = incremental_mirror()
    fresh = mod._fresh_warm_state()
    next(fresh)
    try:
        run_mirrored(mod, *case, extra={"monkeypatch": monkeypatch})
    finally:
        for _ in fresh:
            pass


# -- seeded churn sequences through both packages ------------------------------

TEAMS = 4
CACHES = ("warmstart", "route", "catalog", "compat", "job", "merge", "emit", "mergerow", "seeds", "lprelax")


def reset_both() -> None:
    """No warm state or catalog entry carried in from an earlier test."""
    for pkg in (REF, PORT):
        importlib.import_module(f"{pkg}.solver.incremental").reset()
        solver_mod = importlib.import_module(f"{pkg}.solver.solver")
        with solver_mod._CATALOG_LOCK:
            solver_mod._CATALOG_CACHE.clear()
        importlib.import_module(f"{pkg}.solver.backends").reset_for_tests()


class Churn:
    """One package's world and its warm scheduler, driven by a
    RandomState: both packages draw the same numbers, so their worlds
    take the same mutations."""

    def __init__(self, pkg: str, seed: int, n_pods: int = 120, n_types: int = 20, cluster: bool = False):
        self.pkg = pkg
        self.rng = np.random.RandomState(seed)
        self.h = importlib.import_module("helpers") if pkg == REF else _port_helpers()
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.wk = imp("apis.labels")
        self.ob = imp("kube.objects")
        fake = imp("cloudprovider.fake")
        self.provider = fake.FakeCloudProvider()
        self.provider.instance_types = [
            fake.new_instance_type(
                f"it-{i}",
                {"cpu": str((i % 12) + 1), "memory": f"{2 * ((i % 12) + 1)}Gi", "pods": "110"},
            )
            for i in range(n_types)
        ]
        self.provider.bump_catalog_generation()
        self.pool = self.h.make_nodepool(
            requirements=[self.ob.NodeSelectorRequirement("team", "In", [f"t{t}" for t in range(TEAMS)])]
        )
        self.kube = self.cluster = None
        if cluster:
            self._cluster(imp)
        self.pods = [self.pod(t % TEAMS) for t in range(n_pods)]
        kw = dict(kube_client=self.kube, cluster=self.cluster)
        self.scheduler_cls = imp("solver").TPUScheduler if pkg == REF else cpu_scheduler
        self.env = "KARPENTER_TPU_INCREMENTAL" if pkg == REF else "KARPENTER_TORCH_INCREMENTAL"
        self.warm = self.scheduler_cls([self.pool], self.provider, **kw)

    def _cluster(self, imp) -> None:
        """A store with one zone-labelled node and team pods bound to it:
        the spread groups' seeds are non-trivial."""
        wk = self.wk
        self.kube = imp("kube.client").KubeClient()
        self.cluster = imp("state.cluster").Cluster(self.kube, self.provider)
        imp("state.informers").Informers(self.kube, self.cluster).start()
        node = self.h.make_node(
            name="seed-node-0",
            labels={wk.NODEPOOL_LABEL_KEY: self.pool.name, "team": "t2", wk.LABEL_TOPOLOGY_ZONE: "test-zone-1"},
            capacity={"cpu": "16", "memory": "64Gi", "pods": "110"},
        )
        self.kube.create(node)
        for i in range(3):
            bound = self.h.make_pod(name=f"bound-{i}", requests={"cpu": "100m"}, labels={"team": "t2"})
            bound.spec.node_name = node.metadata.name
            self.kube.create(bound)

    def pod(self, team: int):
        rng = self.rng
        cpu = ["100m", "250m", "500m", "1", "2"][rng.randint(5)]
        mem = ["128Mi", "512Mi", "1Gi", "2Gi"][rng.randint(4)]
        spread = None
        if team == 2:  # one team zone-spreads: the seeded path
            spread = [self.h.spread(self.wk.LABEL_TOPOLOGY_ZONE, labels={"team": f"t{team}"})]
        p = self.h.make_pod(
            requests={"cpu": cpu, "memory": mem},
            node_selector={"team": f"t{team}"},
            labels={"team": f"t{team}"},
            topology_spread=spread,
        )
        p.metadata.resource_version = "1"
        return p

    def tick(self, k: int) -> None:
        """Tick ``k``'s mutation (tick 0 and every third tick are no-ops)."""
        rng = self.rng
        kind = rng.randint(5) if k and k % 3 else 0
        if kind == 1:  # churn concentrated on two teams
            teams = rng.choice(TEAMS, 2, replace=False)
            drop = {i for i, p in enumerate(self.pods)
                    if int(p.metadata.labels["team"][1:]) in teams and rng.rand() < 0.3}
            self.pods = [p for i, p in enumerate(self.pods) if i not in drop]
            self.pods += [self.pod(int(t)) for t in teams for _ in range(4)]
        elif kind == 2:  # an in-place resize, as a client write (rv bump)
            p = self.pods[rng.randint(len(self.pods))]
            p.spec.containers[0].resources.requests["cpu"] = p.spec.containers[0].resources.requests["cpu"] * 2
            p.metadata.resource_version = str(int(p.metadata.resource_version) + 1)
        elif kind == 3:  # in-place price mutation under a generation bump
            for it in self.provider.instance_types[::4]:
                for o in it.offerings:
                    o.price *= 1.01
            self.provider.bump_catalog_generation()
        elif kind == 4:  # a pool change
            self.pool.spec.weight = (self.pool.spec.weight or 0) + 1

    def solve(self) -> tuple:
        """(warm canon, cold canon, warm cache stats) of this tick."""
        os.environ[self.env] = "0"
        try:
            cold = self.scheduler_cls(
                [self.pool], self.provider, kube_client=self.kube, cluster=self.cluster
            ).solve(list(self.pods))
        finally:
            os.environ.pop(self.env, None)
        warm = self.warm.solve(self.pods)
        return canon(self.pods, warm), canon(self.pods, cold), self.warm.last_cache_stats or {}


def canon(pods, res) -> tuple:
    index = {p.uid: i for i, p in enumerate(pods)}
    return (
        [
            (p.nodepool_name, p.instance_type.name, p.zone, p.capacity_type, round(p.price, 9),
             tuple(sorted(p.pod_indices)))
            for p in res.node_plans
        ],
        sorted((index[uid], err) for uid, err in res.pod_errors.items()),
    )


def counts(stats: dict) -> dict:
    return {
        c: (stats.get("hits", {}).get(c, 0), stats.get("misses", {}).get(c, 0), stats.get("evictions", {}).get(c, 0))
        for c in CACHES
    }


def run_both(monkeypatch, seed: int, ticks: int, **kw) -> dict:
    reference_native(monkeypatch)
    reset_both()
    for env in ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    out = {}
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        world = Churn(pkg, seed, **kw)
        rows = []
        for k in range(ticks):
            world.tick(k)
            rows.append(world.solve())
        out[pkg] = rows
    return out


@pytest.mark.parametrize("seed,backend", [(0, "ffd"), (5, "ffd"), (1, "lp")])
def test_churn_sequence_matches_reference_tick_by_tick(monkeypatch, seed, backend):
    """Under ``lp`` a job hit carries the LP cost guard of its skeleton
    into the merge pass, and the ``lprelax`` memo counts ride along."""
    monkeypatch.setenv("KARPENTER_TPU_PACK_BACKEND", backend)
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", backend)
    out = run_both(monkeypatch, seed, ticks=13)
    hits = 0
    for k, (ref, port) in enumerate(zip(out[REF], out[PORT])):
        assert port[0] == port[1], f"tick {k}: the port's warm plan differs from its cold plan"
        assert ref[0] == ref[1], f"tick {k}: the reference's warm plan differs from its cold plan"
        assert port[0] == ref[0], f"tick {k}: the plan streams differ"
        assert counts(port[2]) == counts(ref[2]), f"tick {k}: cache traffic differs"
        hits += sum(port[2].get("hits", {}).values())
    assert hits > 0
    # the no-op ticks after the first replay whole
    assert all(out[PORT][k][2]["hits"].get("warmstart") == 1 for k in (3, 6, 9, 12))


def test_cluster_sequence_matches_reference_seeds_included(monkeypatch):
    """Against a kube store and cluster: no replay (external state), the
    seed memo serves while the cluster generation holds."""
    out = run_both(monkeypatch, 3, ticks=8, cluster=True)
    for k, (ref, port) in enumerate(zip(out[REF], out[PORT])):
        assert port[0] == port[1] == ref[0] == ref[1], f"tick {k}"
        assert counts(port[2]) == counts(ref[2]), f"tick {k}: cache traffic differs"
        assert "warmstart" not in port[2].get("hits", {})
    assert sum(row[2].get("hits", {}).get("seeds", 0) for row in out[PORT]) > 0


# -- device keying ---------------------------------------------------------------


def test_catalog_entry_released_once_its_providers_are_gone(monkeypatch):
    """The shared catalog cache holds its catalogs strongly. An entry
    whose cloud providers are all gone is released at the next lookup
    (a dropped world's catalog would otherwise stay in the heap until
    the LRU bound); one whose provider lives stays."""
    import gc

    from karpenter_core_tpu_torch.solver import solver as solver_mod

    reset_both()
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")

    def sizes():
        return sorted(len(e.catalog) for e in solver_mod._CATALOG_CACHE.values())

    kept = Churn(PORT, 0, n_pods=20, n_types=20)
    kept.warm.solve(kept.pods)
    dropped = Churn(PORT, 1, n_pods=20, n_types=21)
    dropped.warm.solve(dropped.pods)
    assert sizes() == [20, 21]
    del dropped
    gc.collect()
    assert sizes() == [20, 21]  # released at the next lookup, not before
    assert kept.warm.solve(kept.pods).node_plans  # a hit
    assert sizes() == [20]
    third = Churn(PORT, 2, n_pods=20, n_types=22)
    third.warm.solve(third.pods)
    assert sizes() == [20, 22]
    stats = third.warm.last_cache_stats or {}
    assert "catalog" not in stats.get("evictions", {})  # a release is not an LRU eviction


def test_warm_state_and_compat_rows_are_keyed_by_device(monkeypatch):
    from karpenter_core_tpu_torch.solver import incremental
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    reset_both()
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    world = Churn(PORT, 9, n_pods=40)
    provider = world.provider
    # a solver's identity, as warm_state_for reads it: no card needed
    on = lambda dev: SimpleNamespace(cloud_provider=provider, device=torch.device(dev), _tenant_scope=())  # noqa: E731
    assert incremental.state_key(on("cpu")) != incremental.state_key(on("cuda"))
    cpu_state = incremental.warm_state_for(on("cpu"))
    cuda_state = incremental.warm_state_for(on("cuda"))
    assert cpu_state is not cuda_state
    assert incremental.warm_state_for(on("cpu")) is cpu_state
    world.warm.solve(world.pods)
    assert incremental.warm_state_for(world.warm) is cpu_state
    assert len(cpu_state.jobs) > 0 and len(cuda_state.jobs) == 0
    rows = [key for e in solver_mod._CATALOG_CACHE.values() for key in e.sig_rows]
    assert rows and all(key[-1] == "cpu" for key in rows)
    # the card-resident type side is keyed by device too
    entry = next(iter(solver_mod._CATALOG_CACHE.values()))
    assert entry.device_catalog[0][1] == "cpu"


def test_kill_switch_is_read_per_solve(monkeypatch):
    from karpenter_core_tpu_torch.solver import incremental

    reset_both()
    world = Churn(PORT, 4, n_pods=30)
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    assert incremental.warm_state_for(world.warm) is None
    world.warm.solve(world.pods)
    assert "warmstart" not in world.warm.last_cache_stats.get("misses", {})
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL")
    world.warm.solve(world.pods)
    world.warm.solve(world.pods)
    assert world.warm.last_cache_stats["hits"] == {"warmstart": 1}


def test_prewarm_fills_the_shared_caches(monkeypatch):
    """encode_prewarm on a scheduler of its own warms the compat rows and
    the route memo a live solve then hits; prewarm_catalog the catalog."""
    reset_both()
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    world = Churn(PORT, 6, n_pods=60)
    side = cpu_scheduler([world.pool], world.provider)
    assert side.prewarm_catalog()["misses"] == {"catalog": 1}
    stats = side.encode_prewarm(world.pods)
    assert stats["hits"].get("catalog") == 1 and stats["misses"].get("compat", 0) > 0
    world.warm.solve(world.pods)
    cs = world.warm.last_cache_stats
    assert cs["hits"].get("route") == 1 and cs["hits"].get("compat", 0) > 0
    assert "compat" not in cs["misses"]


# -- chip_smoke.py's phase 14, cut down ---------------------------------------------


def test_chip_smoke_phase14_cut_down(monkeypatch):
    """``chip_smoke.py``'s phase 14 (bench config 7's ticks) on the CPU at
    a cut size, with every check it makes on the card: warm plans equal
    to the restart-shaped cold leg's every tick, a no-op replay, the
    device-engine pass's packed jobs equal to its job misses, a restored
    scheduler plan-identical to the un-killed one with every job served
    from the restored memo, and the last plan equal to a cold CPU solve's."""
    import importlib.util
    from pathlib import Path

    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    reset_both()
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_phase14", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    row = smoke.run_config7_phase("cpu", 1500, 100, 12, 3)
    assert row["plan_identical_ticks"] == 12 and row["native_off_plan_identical_ticks"] == 3
    assert row["noop"]["cache"] == {"hits": {"warmstart": 1}, "misses": {}, "hit_rate": 1.0}
    assert [r["job_misses"] for r in row["native_off"]][0] > 0
    assert all(r["jobs_packed"] == r["job_misses"] for r in row["native_off"])
    restart = row["restart"]["cache"]
    assert "job" not in restart["misses"] and "compat" not in restart["misses"]
    assert row["hits"].get("compat", 0) > 0 and row["hits"].get("job", 0) > 0


# -- a fault of the reference the port does not copy (ROADMAP C9) -------------------


@pytest.mark.parametrize("knob,value", [("PACK_BACKEND", "lp"), ("NATIVE", "0")])
def test_pack_switch_between_unchanged_ticks_packs_again(monkeypatch, knob, value):
    """Two ticks of unchanged pods around a switch of the pack backend or
    the C++ packer: the JAX package's probe replays the first tick's
    plans (its replay key leaves the pack configuration out); the port's
    key carries it, so the second tick packs again on the new engine and
    its plans equal a cold solve on that engine."""
    reference_native(monkeypatch)
    reset_both()
    for env in ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    for pkg in (REF, PORT):
        world = Churn(pkg, 2, n_pods=80)
        prefix = "KARPENTER_TPU_" if pkg == REF else "KARPENTER_TORCH_"
        world.warm.solve(world.pods)
        monkeypatch.setenv(prefix + knob, value)
        res = world.warm.solve(world.pods)
        stats = world.warm.last_cache_stats
        if pkg == REF:
            assert stats["hits"].get("warmstart") == 1  # the reference's replay
        else:
            assert stats["misses"].get("warmstart") == 1 and stats["misses"].get("job", 0) > 0
            monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
            cold = cpu_scheduler([world.pool], world.provider).solve(list(world.pods))
            monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL")
            assert canon(world.pods, res) == canon(world.pods, cold)
        monkeypatch.delenv(prefix + knob)


# -- tests/test_constraint_tensors.py::TestJobMemoPortKeys, on the port ------------

PORT_KEYS_FILE = "test_constraint_tensors.py"


def test_isomorphic_port_features_never_alias(monkeypatch):
    """Two batches whose jobs have byte-identical extended request
    matrices but different host-port universes (8080 and 8080, then 8080
    and 9090): a warm scheduler must not serve the first batch's job or
    merge memo to the second (the port features ride the job key). The
    JAX test runs from its own source on the port, and on the reference."""
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_INCREMENTAL", raising=False)
    reference_native(monkeypatch)
    for pkg in (REF, PORT):
        reset_both()
        replace = (("from {pkg}.solver import TPUScheduler, incremental", "from {pkg}.solver import incremental"),)
        inject = {"TPUScheduler": cpu_scheduler} if pkg == PORT else {}
        mod = mirror(PORT_KEYS_FILE, pkg, replace=replace if pkg == PORT else (), inject=inject)
        run_mirrored(mod, "TestJobMemoPortKeys", "test_isomorphic_port_features_never_alias", 0)


def test_lp_guarded_job_hit_keeps_its_cost_guard(monkeypatch):
    """Bench config 10's first price shape under ``lp``, where the LP
    partition wins: a tick whose pods changed only their resource
    versions misses the replay, hits every job, and its skeletons carry
    the LP cost guard into the merge pass, so its plans equal a cold lp
    solve's and the JAX package's."""
    from test_torch_lp import REF_SMOKE, SMOKE, _provider

    from karpenter_core_tpu_torch.solver import incremental

    reference_native(monkeypatch)
    reset_both()
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", "lp")
    monkeypatch.setenv("KARPENTER_TPU_PACK_BACKEND", "lp")
    monkeypatch.setenv("KARPENTER_TPU_INCREMENTAL", "0")
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    _, catalog, pods = SMOKE.config10_shapes()[0]
    provider, pool = _provider(SMOKE, catalog)
    warm = cpu_scheduler([pool], provider)
    first = warm.solve(pods)
    assert warm.last_pack_stats.get("lp_won", 0) > 0
    for p in pods:
        p.metadata.resource_version = str(int(p.metadata.resource_version or 0) + 1)
    again = warm.solve(pods)
    stats = warm.last_cache_stats
    assert stats["misses"].get("warmstart") == 1 and "job" not in stats["misses"] and stats["hits"]["job"] > 0
    assert any(skel.cost_guard for _, skel in incremental.warm_state_for(warm).jobs.items())
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    cold = cpu_scheduler([pool], provider).solve(list(pods))
    assert canon(pods, again) == canon(pods, cold) == canon(pods, first)
    _, ref_catalog, ref_pods = REF_SMOKE.config10_shapes()[0]
    ref_provider, ref_pool = _provider(REF_SMOKE, ref_catalog)
    ref = importlib.import_module(f"{REF}.solver").TPUScheduler([ref_pool], ref_provider).solve(ref_pods)
    assert canon(ref_pods, ref) == canon(pods, again)
