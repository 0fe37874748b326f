"""The port's sharded solve ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/solver/sharding.py`` is the port's copy of
``karpenter_core_tpu/solver/sharding.py``; the meshes here are D shards
of one placement, the CPU, through the kernels' plain versions
(``test_torch_sharding_cards.py`` holds meshes of several placements). The reference runs
in process on conftest's eight host devices with ``make_mesh(D)``. The
same inputs, made from numpy seeds, go through both:

- ``sharded_pod_pack`` at D ∈ {1, 2, 8} on pod counts D does not divide,
  under both engines: ids, counts and the shard stats;
- ``sharded_mega_solve`` on ``tests/test_sharding.py::_mega_inputs``-shaped
  worlds with ragged P and T, three seeds, D ∈ {1, 8}, the no-mesh path
  and the no-viable-type return: every result key but the ``*_ms``;
- ``sharded_batch_pack`` with its fleet total, ``sharded_compat``,
  ``prepare_sharded_catalog`` with ``allowed_sharded`` on a T that 8 does
  not divide, ``sharded_prefix_screen`` at D = 8, ``pod_shard_token``,
  and the stats' accumulate, replace and drain rules and their
  thread-locality (the fleet's tenant lanes included);
- through the seam (``sharding.install_mesh``), the integrated solve on an
  8-shard mesh against the reference under ``KARPENTER_TPU_SHARDED=on``
  and ``KARPENTER_TPU_SHARD_MIN_PODS=64``, native off: per engine the
  plan streams and ``last_shard_stats`` are equal, and the engines'
  plans equal each other; the memo keys of
  ``tests/test_sharding.py::TestShardEngineMemoKeys``; and a solve with no
  mesh keeps ``last_shard_stats`` None and its plans.

Tolerance: exact equality throughout (integer ids and counts, 0/1
products whose sums are exact in float32, prices from the same arrays).
"""

from __future__ import annotations

import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_core_tpu.solver.sharding as ref_sharding
from karpenter_core_tpu.disruption.tpu_repack import prefix_screen_kernel
from karpenter_core_tpu_torch.disruption import screen_kernels
from karpenter_core_tpu_torch.solver import sharding
from test_sharding import _mega_inputs
from test_torch_pack_device import device_engine_off_native
from test_torch_solver import plan_stream

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"
CAP = np.int32(1 << 30)


def port_mesh(D: int):
    return sharding.make_mesh(D, device="cpu")


@pytest.fixture
def mesh8():
    """The seam: an 8-shard CPU mesh for every solve of the test, the
    mesh before it restored after."""
    prev = sharding.install_mesh(port_mesh(8))
    try:
        yield sharding.active_mesh("cpu")
    finally:
        sharding.install_mesh(prev)


def _sorted_job(seed: int, P: int, R: int = 4):
    rng = np.random.RandomState(seed)
    reqs = rng.randint(1, 200, (P, R)).astype(np.int32)
    reqs = reqs[np.lexsort((-reqs[:, 1], -reqs[:, 0]))]
    frontier = np.sort(rng.randint(500, 4000, (8, R)).astype(np.int32), axis=0)[::-1].copy()
    return reqs, frontier


# -- the pod-axis chunk pack ------------------------------------------------------


@pytest.mark.parametrize("D,P", [(1, 1001), (2, 333), (8, 1001), (8, 333)])
def test_pod_pack_equals_reference(D, P):
    reqs, frontier = _sorted_job(P + D, P)
    for engine in ("sharded", "unsharded"):
        ref_sharding.reset_shard_stats()
        want_ids, want_n = ref_sharding.sharded_pod_pack(ref_sharding.make_mesh(D), reqs, frontier, CAP, engine=engine)
        want_stats = ref_sharding.consume_shard_stats()
        sharding.reset_shard_stats()
        ids, n = sharding.sharded_pod_pack(port_mesh(D), reqs, frontier, CAP, engine=engine)
        np.testing.assert_array_equal(ids, np.asarray(want_ids))
        assert ids.dtype == np.int32 and n == want_n
        assert sharding.consume_shard_stats() == want_stats


def test_pod_pack_degrades_without_mesh():
    """No mesh: ``sharded`` becomes ``unsharded`` explicitly, one chunk,
    the reference's plan and stats."""
    reqs, frontier = _sorted_job(5, 333)
    ref_sharding.reset_shard_stats()
    want = ref_sharding.sharded_pod_pack(None, reqs, frontier, CAP, engine="sharded")
    want_stats = ref_sharding.consume_shard_stats()
    sharding.reset_shard_stats()
    got = sharding.sharded_pod_pack(None, reqs, frontier, CAP, engine="sharded", device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]
    stats = sharding.consume_shard_stats()
    assert stats == want_stats and stats["engine"] == "unsharded"


# -- the mega-solve ---------------------------------------------------------------


def _same_result(got: dict, want: dict) -> None:
    keys = {k for k in want if not k.endswith("_ms")}
    assert keys == {k for k in got if not k.endswith("_ms")}
    for k in sorted(keys):
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    for k in want:
        if k.endswith("_ms"):
            assert isinstance(got[k], float)


@pytest.mark.parametrize("seed,P,T,D", [
    (0, 1003, 517, None), (0, 1003, 517, 1), (0, 1003, 517, 8),
    (1, 777, 129, 1), (1, 777, 129, 8), (2, 1517, 1003, 1), (2, 1517, 1003, 8),
])
def test_mega_solve_equals_reference(seed, P, T, D):
    """Ragged pods and types, each engine; D None is the no-mesh path
    (the host compat matmul, one chunk)."""
    reqs, alloc, prices, sig, typ = _mega_inputs(seed, P, T)
    ref_mesh = None if D is None else ref_sharding.make_mesh(D)
    mesh = None if D is None else port_mesh(D)
    for engine in ("sharded", "unsharded"):
        want = ref_sharding.sharded_mega_solve(ref_mesh, reqs, alloc, prices, sig, typ, engine=engine)
        got = sharding.sharded_mega_solve(mesh, reqs, alloc, prices, sig, typ, engine=engine, device="cpu")
        _same_result(got, want)
        assert got["scheduled"] == P


@pytest.mark.parametrize("D", [None, 8])
def test_mega_solve_no_viable_type(D):
    reqs, alloc, prices, sig, _ = _mega_inputs(7, 129, 103)
    typ = np.zeros((103, sig.shape[1]), dtype=np.float32)  # no overlap: nothing viable
    want = ref_sharding.sharded_mega_solve(None if D is None else ref_sharding.make_mesh(D), reqs, alloc, prices, sig, typ)
    got = sharding.sharded_mega_solve(None if D is None else port_mesh(D), reqs, alloc, prices, sig, typ, device="cpu")
    assert got == want and got["error"] == "no viable instance type"


# -- groups, types, the screen ----------------------------------------------------


def test_batch_pack_and_fleet_total_equal_reference():
    rng = np.random.RandomState(0)
    G, P, F, R = 8, 64, 4, 4
    requests = rng.randint(1, 100, (G, P, R)).astype(np.int32)
    requests = np.take_along_axis(requests, np.argsort(-requests[:, :, 0], axis=1)[..., None], axis=1)
    frontiers = rng.randint(200, 800, (G, F, R)).astype(np.int32)
    caps = np.full(G, 1 << 30, dtype=np.int32)
    want = ref_sharding.sharded_batch_pack(
        ref_sharding.make_mesh(8), jnp.asarray(requests), jnp.asarray(frontiers), jnp.asarray(caps)
    )
    got = sharding.sharded_batch_pack(port_mesh(8), torch.from_numpy(requests), torch.from_numpy(frontiers),
                                      torch.from_numpy(caps))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(np.asarray(want[2])) == int(np.asarray(want[1]).sum())
    with pytest.raises(ValueError, match="divide"):
        sharding.sharded_batch_pack(port_mesh(3), torch.from_numpy(requests), torch.from_numpy(frontiers),
                                    torch.from_numpy(caps))


def test_sharded_compat_equals_reference():
    rng = np.random.RandomState(1)
    S, T, W = 16, 64, 32
    sig = (rng.rand(S, W) > 0.5).astype(np.float32)
    typ = (rng.rand(T, W) > 0.5).astype(np.float32)
    want = np.asarray(ref_sharding.sharded_compat(ref_sharding.make_mesh(8), jnp.asarray(sig), jnp.asarray(typ)))
    got = sharding.sharded_compat(port_mesh(8), sig, typ)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _catalog_inputs(seed: int, S: int, T: int, keys=("a", "b", "c"), Z: int = 3, C: int = 2):
    rng = np.random.RandomState(seed)
    widths = {k: int(rng.randint(1, 40)) for k in keys}
    tm = {k: rng.rand(T, w) < 0.3 for k, w in widths.items()}
    th = {k: rng.rand(T) < 0.8 for k in keys}
    tn = {k: rng.rand(T) < 0.1 for k in keys}
    avail = rng.rand(T, Z, C) < 0.6
    sig = {}
    for k, w in widths.items():
        sig[f"mask:{k}"] = rng.rand(S, w) < 0.4
        sig[f"has:{k}"] = rng.rand(S) < 0.7
        sig[f"neg:{k}"] = rng.rand(S) < 0.1
    sig["valid"] = rng.rand(S) < 0.9
    return tm, th, tn, avail, sig, rng.rand(S, Z) < 0.7, rng.rand(S, C) < 0.8


@pytest.mark.parametrize("T", [61, 203])
def test_prepared_catalog_allowed_equals_reference(T):
    tm, th, tn, avail, sig, zone_ok, ct_ok = _catalog_inputs(T, 13, T)
    keys = tuple(sorted(tm))
    ref_sharding.reset_shard_stats()
    prepared = ref_sharding.prepare_sharded_catalog(ref_sharding.make_mesh(8), tm, th, tn, avail)
    want = np.asarray(ref_sharding.allowed_sharded(prepared, sig, zone_ok, ct_ok, keys))
    want_stats = ref_sharding.consume_shard_stats()
    sharding.reset_shard_stats()
    catalog, n_types = sharding.prepare_sharded_catalog(port_mesh(8), tm, th, tn, avail)
    assert n_types == T and catalog.n_types == -(-T // 8) * 8
    got = sharding.allowed_sharded((catalog, n_types), sig, zone_ok, ct_ok, keys)
    assert got.shape == (13, T)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sharding.consume_shard_stats() == want_stats


def test_prefix_screen_equals_reference():
    rng = np.random.RandomState(2)
    N, R, D = 64, 4, 8
    loads = rng.randint(1, 50, (N, R)).astype(np.int32)
    free = rng.randint(0, 40, (N, R)).astype(np.int32)
    fleet = rng.randint(0, 100, (D, R)).astype(np.int32)
    cap = rng.randint(50, 200, R).astype(np.int32)
    want = np.asarray(ref_sharding.sharded_prefix_screen(
        ref_sharding.make_mesh(D), *(jnp.asarray(a) for a in (loads, free, fleet, cap))
    ))
    assert np.array_equal(want, np.asarray(prefix_screen_kernel(
        jnp.asarray(loads), jnp.asarray(free), jnp.asarray(fleet.sum(axis=0).astype(np.int32)), jnp.asarray(cap)
    )))
    got = sharding.sharded_prefix_screen(port_mesh(D), loads, free, fleet, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    plain = screen_kernels.prefix_screen_reference(*(torch.from_numpy(a) for a in (
        loads, free, fleet.sum(axis=0).astype(np.int32), cap)))
    assert torch.equal(got, plain)
    with pytest.raises(ValueError, match="divide"):
        sharding.sharded_prefix_screen(port_mesh(D), loads[:63], free[:63], fleet, cap)


# -- configuration and stats ------------------------------------------------------


@pytest.mark.parametrize("engine,min_pods", [("sharded", 65536), ("unsharded", 64), ("bogus", 1024), ("sharded", 0)])
def test_pod_shard_token_equals_reference(monkeypatch, engine, min_pods):
    monkeypatch.setenv("KARPENTER_TPU_SHARD_ENGINE", engine)
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", str(min_pods))
    monkeypatch.setattr(sharding, "SHARD_ENGINE", engine)
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", min_pods)
    assert sharding.pod_shard_token(None) == ref_sharding.pod_shard_token(None) == ()
    for D in (1, 8):
        assert sharding.pod_shard_token(port_mesh(D)) == ref_sharding.pod_shard_token(ref_sharding.make_mesh(D))


def test_constants_are_the_reference_defaults():
    assert (sharding.SHARD_ENGINE, sharding.SHARD_MIN_PODS, sharding.SHARDED) == ("sharded", 65536, "auto")


STATS_SCRIPT = (
    ("pods", 1001, 1008, True, {"engine": "sharded", "n_devices": 8, "chunks": 8}),
    ("pods", 333, 336, True, {"engine": "sharded"}),
    ("types", 103, 104, False, {"n_devices": 8}),
    ("types", 61, 64, False, {}),
    ("pods", 0, 0, False, {"chunks": 1}),
    ("pods", 7, 8, True, {}),
)


@pytest.mark.parametrize("upto", range(1, len(STATS_SCRIPT) + 1))
def test_stats_rules_equal_reference(upto):
    """Accumulate, replace and drain, event by event; a drained
    accumulator is empty."""
    for mod in (ref_sharding, sharding):
        mod.reset_shard_stats()
        for axis, used, padded, accumulate, extra in STATS_SCRIPT[:upto]:
            mod.record_shard_padding(axis, used, padded, accumulate=accumulate, **extra)
    got = sharding.consume_shard_stats()
    assert got == ref_sharding.consume_shard_stats()
    assert sharding.consume_shard_stats() == {}


def test_stats_are_per_thread():
    """Eight threads record at once, each its own events; each drains
    exactly its own, and this thread's stats stay untouched."""
    sharding.reset_shard_stats()
    sharding.record_shard_padding("types", 5, 8, accumulate=False)
    barrier = threading.Barrier(8)
    out = {}

    def worker(i):
        sharding.reset_shard_stats()
        barrier.wait(timeout=10)
        for _ in range(50):
            sharding.record_shard_padding("pods", i + 1, i + 2, n_devices=i)
        barrier.wait(timeout=10)
        out[i] = sharding.consume_shard_stats()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        assert out[i] == {"pods_used": 50 * (i + 1), "pods_padded": 50 * (i + 2),
                          "pods_waste": round(1.0 - (i + 1) / (i + 2), 4), "n_devices": i}
    assert sharding.consume_shard_stats() == {"types_used": 5, "types_padded": 8, "types_waste": 0.375}


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_mesh_rules(monkeypatch, mode):
    """The reference's rule with cards for its devices: ``off`` never
    shards, an installed mesh wins otherwise, ``on`` gives a mesh over
    every visible card (one shard a card) when there are two or more,
    ``auto`` the same on the ``cuda`` backend; ``make_mesh`` keeps its
    placements as given."""
    cpu, cards = torch.device("cpu"), (torch.device("cuda", 0), torch.device("cuda", 1))
    monkeypatch.setattr(sharding, "SHARDED", mode)
    monkeypatch.setattr(sharding, "_CARDS", {})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sharding.active_mesh("cpu") is None and sharding.active_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = sharding.active_mesh("cuda")
    if mode == "off":
        assert two is None
    else:
        assert (two.size, two.placements, two.device, two.cards) == (2, cards, cards[0], cards)
        assert sharding.active_mesh("cuda") is two
    assert (sharding.active_mesh("cpu") is not None) == (mode == "on")
    mesh = port_mesh(4)
    monkeypatch.setattr(sharding, "_INSTALLED", mesh)
    assert (sharding.active_mesh("cuda") is mesh) == (mode != "off")
    assert (mesh.size, mesh.axis_names, mesh.device, mesh.placements) == (4, ("groups",), cpu, (cpu,))
    placed = sharding.make_mesh(devices=["cpu"] * 4)
    assert (placed.size, placed.placements, placed.cards) == (4, (cpu,) * 4, (cpu,))
    assert sharding.make_mesh(8, devices=["cpu"] * 4).size == 8
    with pytest.raises(ValueError):
        sharding.make_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        sharding.make_mesh(6, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            sharding.make_mesh(devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_two_cards_default_is_the_one_card_path(monkeypatch, mode):
    """On a host with two cards the mesh spans both, and a solver off its
    first placement (here the CPU's) runs the one-device path: a solve
    whose every ``active_mesh`` call asks for the card's backend plans as
    without a mesh, with no stats."""
    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    _, want = _solve(PORT, 5, 120)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(sharding, "SHARDED", mode)
    assert sharding.active_mesh("cuda").placements == (torch.device("cuda", 0), torch.device("cuda", 1))
    real = sharding.active_mesh
    asked = []

    def as_on_the_card(backend):
        asked.append(backend)
        return real("cuda")

    monkeypatch.setattr(sharding, "active_mesh", as_on_the_card)
    solver, res = _solve(PORT, 5, 120)
    assert asked and solver.last_shard_stats is None
    assert res.pods_scheduled == 120 and plan_stream(res) == plan_stream(want)


# -- the integrated solve ----------------------------------------------------------


def _world(pkg: str, seed: int, n: int, n_types: int = 30):
    """The reference's ``TestIntegratedMegaShardSolve`` world from
    ``pkg``'s classes: one pool, ``instance_types(n_types)``, ``n`` pods
    of seeded cpu and memory requests."""
    NodePool = importlib.import_module(f"{pkg}.apis.nodepool").NodePool
    fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
    ob = importlib.import_module(f"{pkg}.kube.objects")
    pq = importlib.import_module(f"{pkg}.kube.quantity").parse_quantity
    provider = fake.FakeCloudProvider()
    provider.instance_types = fake.instance_types(n_types)
    pool = NodePool()
    pool.metadata.name = "default"
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(n):
        pod = ob.Pod()
        pod.metadata.name = f"m-{seed}-{i}"
        requests = {
            "cpu": pq(["250m", "500m", "1", "2"][rng.randint(4)]),
            "memory": pq(["512Mi", "1Gi", "2Gi"][rng.randint(3)]),
        }
        pod.spec = ob.PodSpec(containers=[ob.Container(name="main", resources=ob.ResourceRequirements(requests=requests))])
        pods.append(pod)
    return [pool], provider, pods


def _solve(pkg: str, seed: int, n: int, metrics=None):
    pools, provider, pods = _world(pkg, seed, n)
    if pkg == REF:
        from karpenter_core_tpu.solver import TPUScheduler

        solver = TPUScheduler(pools, provider, metrics=metrics)
    else:
        from karpenter_core_tpu_torch.solver import TorchScheduler

        solver = TorchScheduler(pools, provider, device="cpu", metrics=metrics)
    return solver, solver.solve(pods)


@pytest.fixture
def mega_both(monkeypatch, mesh8):
    """Both packages on an 8-way mesh with the chunk threshold at 64 and
    their packers off; the reference by its knobs, the port by its
    constants and the seam."""
    device_engine_off_native(monkeypatch)
    monkeypatch.setenv("KARPENTER_TPU_SHARDED", "on")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", "64")
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", 64)

    def engine(name: str):
        monkeypatch.setenv("KARPENTER_TPU_SHARD_ENGINE", name)
        monkeypatch.setattr(sharding, "SHARD_ENGINE", name)

    return engine


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integrated_mega_solve_equals_reference(monkeypatch, mega_both, seed):
    """``TestIntegratedMegaShardSolve`` on both packages: per engine the
    port's plan stream and shard stats equal the reference's; the two
    engines' plans equal each other."""
    monkeypatch.setenv("KARPENTER_TPU_INCREMENTAL", "0")
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    n = 301 + seed  # never divisible by the 8 shards
    streams = {}
    for name in ("sharded", "unsharded"):
        mega_both(name)
        ref_solver, ref_res = _solve(REF, seed, n)
        solver, res = _solve(PORT, seed, n)
        assert res.pods_scheduled == ref_res.pods_scheduled == n
        assert plan_stream(res) == plan_stream(ref_res)
        assert res.total_price == ref_res.total_price
        assert solver.last_shard_stats == ref_solver.last_shard_stats
        assert solver.last_shard_stats["engine"] == name and solver.last_shard_stats["pods_used"] >= n // 2
        streams[name] = plan_stream(res)
    assert streams["sharded"] == streams["unsharded"]


def test_integrated_solve_runs_on_the_mesh(monkeypatch, mega_both):
    """The mesh's routes are taken: the compat through the padded catalog
    (``allowed_sharded``), the mega job through ``sharded_pod_pack``, and
    the padding waste gauge is set per axis as the reference sets it."""
    from karpenter_core_tpu.metrics import Metrics as RefMetrics
    from karpenter_core_tpu_torch.metrics import Metrics

    mega_both("sharded")
    calls = {"allowed": 0, "pod_pack": 0}
    real_allowed, real_pack = sharding.allowed_sharded, sharding.sharded_pod_pack

    def spy_allowed(*a, **k):
        calls["allowed"] += 1
        return real_allowed(*a, **k)

    def spy_pack(*a, **k):
        calls["pod_pack"] += 1
        return real_pack(*a, **k)

    monkeypatch.setattr(sharding, "allowed_sharded", spy_allowed)
    monkeypatch.setattr(sharding, "sharded_pod_pack", spy_pack)
    ref_metrics, metrics = RefMetrics(), Metrics()
    _, ref_res = _solve(REF, 0, 251, metrics=ref_metrics)
    _, res = _solve(PORT, 0, 251, metrics=metrics)
    assert calls["allowed"] >= 1 and calls["pod_pack"] >= 1
    assert plan_stream(res) == plan_stream(ref_res)
    for axis in ("pods", "types"):
        assert metrics.shard_padding_waste.get(axis=axis) is not None
        assert metrics.shard_padding_waste.get(axis=axis) == ref_metrics.shard_padding_waste.get(axis=axis)


def test_group_sharded_pack_below_threshold(monkeypatch, mega_both):
    """Jobs under the chunk threshold take the group-sharded scan on the
    mesh (no C++ packer), plan for plan the reference's."""
    mega_both("sharded")
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", 1 << 20)
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", str(1 << 20))
    calls = {"n": 0}
    real = sharding.sharded_batch_pack

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(sharding, "sharded_batch_pack", spy)
    ref_solver, ref_res = _solve(REF, 4, 120)
    solver, res = _solve(PORT, 4, 120)
    assert calls["n"] >= 1
    assert plan_stream(res) == plan_stream(ref_res)
    assert solver.last_shard_stats == ref_solver.last_shard_stats  # the type axis alone
    assert "pods_used" not in solver.last_shard_stats


def test_shard_config_never_aliases_job_memo(monkeypatch, mega_both):
    """``TestShardEngineMemoKeys`` on the port: flipping the chunk
    threshold or the engine between ticks never serves a memoised job."""
    from karpenter_core_tpu_torch.solver import incremental

    mega_both("sharded")
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "1")
    incremental.reset()
    pools, provider, _ = _world(PORT, 0, 0, n_types=20)
    from karpenter_core_tpu_torch.solver import TorchScheduler

    solver = TorchScheduler(pools, provider, device="cpu")

    def pods():
        # fresh content-identical objects a tick: the whole-solve replay
        # misses, the content-keyed job memo serves the repeat
        return _world(PORT, 9, 200, n_types=20)[2]

    solver.solve(pods())
    solver.solve(pods())
    assert solver.last_cache_stats["hits"].get("job", 0) >= 1
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", 1024)
    solver.solve(pods())
    assert solver.last_cache_stats["hits"].get("job", 0) == 0
    assert solver.last_cache_stats["misses"].get("job", 0) >= 1
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", 64)
    mega_both("unsharded")
    solver.solve(pods())
    assert solver.last_cache_stats["hits"].get("job", 0) == 0


def test_one_card_solve_is_unchanged(monkeypatch):
    """No mesh: no stats, the job keys' meshless token, and the same plans
    as the reference's default route."""
    from karpenter_core_tpu_torch.solver import incremental

    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    assert sharding.active_mesh("cpu") is None
    solver, res = _solve(PORT, 3, 150)
    assert solver.last_shard_stats is None and res.pods_scheduled == 150
    assert incremental.pack_engine_token() == (False, 0, 1024, ())
    with_mesh = incremental.pack_engine_token(port_mesh(8))
    assert with_mesh == (False, 8, 1024, ("sharded", 65536, 8))


def test_fleet_lanes_keep_their_own_stats(monkeypatch, mega_both):
    """Batched fleet lanes under a mesh: each tenant's ``last_shard_stats``
    are its own solve's, as under the solo engine (a flushing thread never
    takes another tenant's padding)."""
    from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry

    mega_both("sharded")
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    sizes = {"a": 70, "b": 130, "c": 97}
    stats = {}
    for engine in ("solo", "batched"):
        monkeypatch.setenv("KARPENTER_TORCH_FLEET_ENGINE", engine)
        reg = FleetRegistry(device="cpu")
        work = {}
        for i, (tid, n) in enumerate(sizes.items()):
            pools, provider, pods = _world(PORT, 20 + i, n)
            reg.add_tenant(tid, pools, provider)
            work[tid] = pods
        out = FleetEngine(reg).solve_round(work)
        assert all(o.error is None for o in out.values())
        stats[engine] = {tid: reg.get(tid).solver.last_shard_stats for tid in sizes}
    assert stats["batched"] == stats["solo"]
    for tid, n in sizes.items():
        assert stats["batched"][tid]["pods_used"] == n


def _two_lane_flush(dispatcher, submit, jobs: dict) -> dict:
    """Two busy lanes, each submitting one mega job at once: each lane's
    own shard stats after its submission returns."""
    out = {}
    barrier = threading.Barrier(len(jobs))
    for _ in jobs:
        dispatcher.worker_begin()

    def lane(name):
        try:
            sharding.reset_shard_stats()
            ref_sharding.reset_shard_stats()
            barrier.wait(timeout=10)
            submit([jobs[name]])
            out[name] = {**ref_sharding.consume_shard_stats(), **sharding.consume_shard_stats()}
        finally:
            dispatcher.worker_end()

    threads = [threading.Thread(target=lane, args=(name,)) for name in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_reference_flush_takes_other_lanes_padding(mega_both):
    """ROADMAP queue C: the reference's ``_MegaDispatcher`` flushes every
    parked lane's mega job on the flushing thread, so their pod padding
    lands in that thread's stats and the other lane's stay empty; the
    port packs a lane under a mesh on its own thread (``pack_alone``),
    and each lane keeps its own."""
    from karpenter_core_tpu.fleet.megasolve import _MegaDispatcher as RefDispatcher
    from karpenter_core_tpu.solver.backends import FFDBackend as RefFFD
    from karpenter_core_tpu_torch.fleet.megasolve import _CoalescingBackend, _MegaDispatcher
    from karpenter_core_tpu_torch.solver.backends import FFDBackend

    mega_both("sharded")
    jobs = {}
    for name, (seed, P) in {"a": (1, 100), "b": (2, 300)}.items():
        reqs, frontier = _sorted_job(seed, P)
        jobs[name] = (reqs, frontier, CAP)
    ref = RefDispatcher(RefFFD(), window=5.0)
    got = _two_lane_flush(ref, lambda js: ref.submit(js, [{}], ref_sharding.make_mesh(8)), jobs)
    assert ref.flushes == 1
    assert sorted(s.get("pods_used", 0) for s in got.values()) == [0, 400]
    port = _MegaDispatcher(FFDBackend(), window=5.0)
    lanes = _CoalescingBackend(port)
    got = _two_lane_flush(port, lambda js: lanes.pack_jobs(js, [{}], device="cpu", mesh=port_mesh(8)), jobs)
    assert {name: s["pods_used"] for name, s in got.items()} == {"a": 100, "b": 300}
