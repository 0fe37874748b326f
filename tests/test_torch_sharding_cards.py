"""The port's mesh across cards ≡ the JAX package's D-device mesh, on the CPU.

A mesh of ``solver/sharding.py`` is D shards over an ordered tuple of
placements: each placement runs its contiguous block of shards as one
launch on its own card, and the collectives are copies to the first
placement. ``make_mesh(devices=["cpu"] * n)`` gives n placements on the
CPU, so the split over placements and the gathers run here through the
kernels' plain versions, as they run over ``cuda:0`` … ``cuda:3`` on a
host with four cards. Every sharded entry point over such a mesh, D ∈
{2, 4, 8} with one shard or two a placement, equals the reference's
D-device mesh (conftest's eight host devices) and the port's mesh of one
placement holding all D shards:

- ``sharded_batch_pack``: ids, counts and the fleet total;
- ``sharded_pod_pack`` at 1,001 and 333 pods;
- ``sharded_compat``, and ``allowed_sharded`` over
  ``prepare_sharded_catalog`` at T = 61 and 203;
- ``sharded_prefix_screen``, whose offsets fold into each placement's
  fleet, on worlds where the earlier shards' loads pass the fleet;
- ``sharded_mega_solve`` on ragged worlds;
- the integrated solve on an 8-shard mesh (plan streams and stats);
- ``pod_shard_token``, which the placements never change.

Then the launch sites: every kernel launch makes its tensors' card
current, and every ``csrc/*.cu`` launch that raises a kernel's dynamic
shared-memory limit keys that by device.

Tolerance: exact equality throughout (integer ids and counts, 0/1
products whose sums are exact in float32, screens whose partial sums
stay below 2^24).
"""

from __future__ import annotations

import ast
import contextlib
import os
import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_core_tpu.solver.sharding as ref_sharding
from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch.disruption import screen_kernels
from karpenter_core_tpu_torch.solver import devicetime, sharding
from test_sharding import _mega_inputs
from test_torch_pack_device import device_engine_off_native
from test_torch_sharding import CAP, PORT, REF, _catalog_inputs, _same_result, _solve, _sorted_job, _world
from test_torch_solver import plan_stream

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "karpenter_core_tpu_torch")
# (shards, placements): one shard a placement, and two
MESHES = [(2, 2), (4, 4), (8, 8), (4, 2), (8, 4)]


def placed(D: int, n: int):
    """D shards over ``n`` CPU placements."""
    return sharding.make_mesh(D, devices=["cpu"] * n)


def one(D: int):
    """D shards on one CPU placement (one launch)."""
    return sharding.make_mesh(D, device="cpu")


def test_placement_mesh_shape():
    mesh = placed(8, 4)
    assert (mesh.size, len(mesh.placements), mesh.device, mesh.cards) == (8, 4, torch.device("cpu"),
                                                                         (torch.device("cpu"),))
    assert [b[1:] for b in sharding._blocks(mesh, 16)] == [(0, 4), (4, 8), (8, 12), (12, 16)]


# -- groups -------------------------------------------------------------------------


@pytest.mark.parametrize("D,n", MESHES)
def test_batch_pack_over_placements(D, n):
    rng = np.random.RandomState(D + n)
    G, P, F, R = 2 * D, 48, 4, 4
    requests = rng.randint(1, 100, (G, P, R)).astype(np.int32)
    requests = np.take_along_axis(requests, np.argsort(-requests[:, :, 0], axis=1)[..., None], axis=1)
    frontiers = rng.randint(200, 800, (G, F, R)).astype(np.int32)
    caps = np.full(G, 1 << 30, dtype=np.int32)
    want = ref_sharding.sharded_batch_pack(
        ref_sharding.make_mesh(D), jnp.asarray(requests), jnp.asarray(frontiers), jnp.asarray(caps)
    )
    args = [torch.from_numpy(a) for a in (requests, frontiers, caps)]
    got = sharding.sharded_batch_pack(placed(D, n), *args)
    single = sharding.sharded_batch_pack(one(D), *args)
    for a, b in ((got, single), (got, [np.asarray(w) for w in want])):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert int(got[2]) == int(single[2]) == int(np.asarray(want[2])) == int(np.asarray(want[1]).sum())
    with pytest.raises(ValueError, match="divide"):
        sharding.sharded_batch_pack(placed(D, n), *(a[:-1] for a in args))


# -- pods -----------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1001, 333])
@pytest.mark.parametrize("D,n", MESHES)
def test_pod_pack_over_placements(D, n, P):
    reqs, frontier = _sorted_job(P + D, P)
    for engine in ("sharded", "unsharded"):
        ref_sharding.reset_shard_stats()
        want_ids, want_n = ref_sharding.sharded_pod_pack(ref_sharding.make_mesh(D), reqs, frontier, CAP, engine=engine)
        want_stats = ref_sharding.consume_shard_stats()
        single = sharding.sharded_pod_pack(one(D), reqs, frontier, CAP, engine=engine)
        sharding.reset_shard_stats()
        ids, count = sharding.sharded_pod_pack(placed(D, n), reqs, frontier, CAP, engine=engine)
        np.testing.assert_array_equal(ids, np.asarray(want_ids))
        np.testing.assert_array_equal(ids, single[0])
        assert ids.dtype == np.int32 and count == want_n == single[1]
        assert sharding.consume_shard_stats() == want_stats


def test_download_joins_runs_of_one_device():
    parts = [torch.arange(3), torch.arange(3, 5), torch.arange(5, 9)]
    np.testing.assert_array_equal(sharding._download(parts), np.arange(9))


# -- types ----------------------------------------------------------------------------


@pytest.mark.parametrize("D,n", MESHES)
def test_sharded_compat_over_placements(D, n):
    rng = np.random.RandomState(D * n)
    S, T, W = 16, 8 * D, 32
    sig = (rng.rand(S, W) > 0.5).astype(np.float32)
    typ = (rng.rand(T, W) > 0.5).astype(np.float32)
    want = np.asarray(ref_sharding.sharded_compat(ref_sharding.make_mesh(D), jnp.asarray(sig), jnp.asarray(typ)))
    got = sharding.sharded_compat(placed(D, n), sig, typ)
    assert got.dtype == torch.float32 and got.shape == (S, T)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, sharding.sharded_compat(one(D), sig, typ))


@pytest.mark.parametrize("T", [61, 203])
@pytest.mark.parametrize("D,n", MESHES)
def test_allowed_sharded_over_placements(D, n, T):
    tm, th, tn, avail, sig, zone_ok, ct_ok = _catalog_inputs(T + D, 13, T)
    keys = tuple(sorted(tm))
    ref_sharding.reset_shard_stats()
    prepared = ref_sharding.prepare_sharded_catalog(ref_sharding.make_mesh(D), tm, th, tn, avail)
    want = np.asarray(ref_sharding.allowed_sharded(prepared, sig, zone_ok, ct_ok, keys))
    want_stats = ref_sharding.consume_shard_stats()
    sharding.reset_shard_stats()
    mesh = placed(D, n)
    catalog, n_types = sharding.prepare_sharded_catalog(mesh, tm, th, tn, avail)
    assert sharding.consume_shard_stats() == want_stats
    Tp = -(-T // D) * D
    assert n_types == T and catalog.n_types == Tp and [c.n_types for c in catalog.catalogs] == [Tp // n] * n
    got = sharding.allowed_sharded((catalog, n_types), sig, zone_ok, ct_ok, keys)
    assert got.shape == (13, T)
    np.testing.assert_array_equal(got.numpy(), want)
    single = sharding.prepare_sharded_catalog(one(D), tm, th, tn, avail)
    assert torch.equal(got, sharding.allowed_sharded(single, sig, zone_ok, ct_ok, keys))


# -- the screen -----------------------------------------------------------------------


def _screen_world(seed: int, D: int, per: int, R: int = 4):
    """Heavy loads, little free capacity, a small fleet: past the first
    shards the earlier loads pass the fleet and the later free."""
    rng = np.random.RandomState(seed)
    N = D * per
    loads = rng.randint(20, 60, (N, R)).astype(np.int32)
    free = rng.randint(0, 6, (N, R)).astype(np.int32)
    fleet = rng.randint(0, 40, (D, R)).astype(np.int32)
    cap = rng.randint(150, 300, R).astype(np.int32)
    return loads, free, fleet, cap


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("D,n", MESHES)
def test_prefix_screen_fold_over_placements(D, n, seed):
    loads, free, fleet, cap = _screen_world(seed, D, 12)
    want = np.asarray(ref_sharding.sharded_prefix_screen(
        ref_sharding.make_mesh(D), *(jnp.asarray(a) for a in (loads, free, fleet, cap))
    ))
    got = sharding.sharded_prefix_screen(placed(D, n), loads, free, fleet, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, sharding.sharded_prefix_screen(one(D), loads, free, fleet, cap))
    assert want.any() and not want.all()
    # the fold of the last placement: its fleet is negative on every column
    block = loads.shape[0] // n
    earlier = loads[: (n - 1) * block].astype(np.int64).sum(axis=0)
    folded = fleet.astype(np.int64).sum(axis=0) - earlier
    assert (folded < 0).all()


def test_prefix_screen_checks_its_inputs():
    loads, free, fleet, cap = _screen_world(3, 4, 8)
    with pytest.raises(ValueError, match="divide"):
        sharding.sharded_prefix_screen(placed(4, 2), loads[:-1], free[:-1], fleet, cap)
    with pytest.raises(ValueError, match="rows for 4 shards"):
        sharding.sharded_prefix_screen(placed(4, 2), loads, free, fleet[:2], cap)


# -- the mega-solve and the integrated solve --------------------------------------------


@pytest.mark.parametrize("seed,P,T", [(0, 1003, 517), (1, 777, 129), (2, 1517, 1003)])
@pytest.mark.parametrize("D,n", [(2, 2), (4, 4), (8, 4)])
def test_mega_solve_over_placements(D, n, seed, P, T):
    reqs, alloc, prices, sig, typ = _mega_inputs(seed, P, T)
    for engine in ("sharded", "unsharded"):
        want = ref_sharding.sharded_mega_solve(ref_sharding.make_mesh(D), reqs, alloc, prices, sig, typ, engine=engine)
        got = sharding.sharded_mega_solve(placed(D, n), reqs, alloc, prices, sig, typ, engine=engine)
        _same_result(got, want)
        _same_result(got, sharding.sharded_mega_solve(one(D), reqs, alloc, prices, sig, typ, engine=engine))
        assert got["scheduled"] == P


@contextlib.contextmanager
def installed(mesh):
    prev = sharding.install_mesh(mesh)
    try:
        yield
    finally:
        sharding.install_mesh(prev)


@pytest.mark.parametrize("n", [8, 4])
def test_integrated_solve_over_placements(monkeypatch, n):
    """The reference under ``KARPENTER_TPU_SHARDED=on`` over its eight
    devices, chunk threshold 64, packers off, against the port's 8-shard
    mesh over ``n`` placements and over one: equal plan streams, prices
    and shard stats, per engine."""
    device_engine_off_native(monkeypatch)
    for var in ("KARPENTER_TPU_INCREMENTAL", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setenv("KARPENTER_TPU_SHARDED", "on")
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", "64")
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", 64)
    for engine in ("sharded", "unsharded"):
        monkeypatch.setenv("KARPENTER_TPU_SHARD_ENGINE", engine)
        monkeypatch.setattr(sharding, "SHARD_ENGINE", engine)
        ref_solver, ref_res = _solve(REF, 1, 303)
        runs = {}
        for label, mesh in (("placed", placed(8, n)), ("one", one(8))):
            with installed(mesh):
                runs[label] = _solve(PORT, 1, 303)
        for solver, res in runs.values():
            assert res.pods_scheduled == ref_res.pods_scheduled == 303
            assert plan_stream(res) == plan_stream(ref_res) and res.total_price == ref_res.total_price
            assert solver.last_shard_stats == ref_solver.last_shard_stats
            assert solver.last_shard_stats["engine"] == engine


@pytest.mark.parametrize("engine,min_pods", [("sharded", 65536), ("unsharded", 64)])
@pytest.mark.parametrize("D,n", MESHES)
def test_pod_shard_token_ignores_placements(monkeypatch, D, n, engine, min_pods):
    monkeypatch.setenv("KARPENTER_TPU_SHARD_ENGINE", engine)
    monkeypatch.setenv("KARPENTER_TPU_SHARD_MIN_PODS", str(min_pods))
    monkeypatch.setattr(sharding, "SHARD_ENGINE", engine)
    monkeypatch.setattr(sharding, "SHARD_MIN_PODS", min_pods)
    want = ref_sharding.pod_shard_token(ref_sharding.make_mesh(D))
    assert sharding.pod_shard_token(placed(D, n)) == sharding.pod_shard_token(one(D)) == want


def test_solver_shards_only_from_the_first_placement(monkeypatch):
    """A solver shards over the active mesh when that mesh's first
    placement is its own device, and runs the one-device path otherwise."""
    from karpenter_core_tpu_torch.solver import TorchScheduler

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    pools, provider, _ = _world(PORT, 0, 0)
    solver = TorchScheduler(pools, provider, device="cpu")
    with installed(placed(4, 2)):
        assert solver._mesh() == placed(4, 2)
    with installed(sharding.Mesh(2, "groups", (torch.device("cuda", 0), torch.device("cpu")))):
        assert solver._mesh() is None


# -- device time across cards -----------------------------------------------------------


class _FakeEvent:
    def __init__(self, t: float):
        self.t = t

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end) -> float:
        return end.t - self.t


def test_clock_counts_the_longest_card():
    clock = devicetime.Clock()
    clock.pairs.append(("shard", [("cuda:0", _FakeEvent(0.0), _FakeEvent(2.0)),
                                  ("cuda:1", _FakeEvent(0.0), _FakeEvent(3.5))]))
    clock.pairs.append(("pack", [("cuda:0", _FakeEvent(1.0), _FakeEvent(1.5))]))
    assert clock.phase_ms() == {"shard": 3.5, "pack": 0.5}
    assert clock.card_ms() == {"cuda:0": 2.0, "cuda:1": 3.5}
    assert devicetime.Clock().card_ms() == {}


def test_track_off_the_card_records_nothing():
    with devicetime.scope("cpu") as clock:
        with devicetime.track(phase="shard", devices=placed(4, 2).cards):
            pass
    assert clock.pairs == [] and clock.phase_ms() == {}


# -- the launch sites -------------------------------------------------------------------


def test_same_device_normalises_the_index(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    same = buildlib.same_device
    assert same("cuda", "cuda:0") and same(torch.device("cuda:0"), "cuda")
    assert not same("cuda:1", "cuda:0") and not same("cuda", "cuda:1") and not same("cpu", "cuda:0")
    assert same("cpu", torch.device("cpu"))
    t = torch.zeros(3, dtype=torch.int32)
    buildlib.check_tensor("t", t, torch.int32, (3,), torch.device("cpu"))
    with pytest.raises(ValueError, match="expected contiguous"):
        buildlib.check_tensor("t", t, torch.int32, (3,), torch.device("cuda", 1))


def test_launch_makes_the_tensors_card_current(monkeypatch):
    """``CudaKernel.launch(device=)`` calls the launch function with that
    card current, and counts the launch."""
    current = []
    entered = []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append(dev)
        current.append(dev)
        try:
            yield
        finally:
            current.pop()

    class FakeLib:
        @staticmethod
        def fake_launch(*args):
            seen.append((args, current[-1] if current else None))
            return 0

    seen = []
    kernel = buildlib.CudaKernel.__new__(buildlib.CudaKernel)
    kernel.symbol, kernel.launches, kernel.total_launches = "fake_launch", 0, 0
    kernel._lib, kernel._lock = FakeLib(), threading.Lock()
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    card = torch.device("cuda", 1)
    kernel.launch(1, 2, device=card)
    kernel.launch(3)
    assert seen == [((1, 2), card), ((3,), None)] and entered == [card] and kernel.launches == 2


def _launch_calls(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "launch":
            yield node


@pytest.mark.parametrize("module", ["solver/pack.py", "solver/compat_kernels.py", "solver/backends/lp.py",
                                    "disruption/screen_kernels.py"])
def test_every_launch_names_its_card(module):
    """Every ``CudaKernel`` launch passes the tensors' card (``device=``);
    the compat kernel's own ``launch`` takes it from its catalog."""
    calls = list(_launch_calls(os.path.join(PKG, module)))
    assert calls
    for call in calls:
        receiver = ast.unparse(call.func.value)
        if receiver == "COMPAT_ALLOWED":
            continue
        assert any(k.arg == "device" for k in call.keywords), f"{module}:{call.lineno} {receiver}.launch"


def _function_bodies(src: str):
    """(start, end) of every outermost block opened after a ``)``: the
    function bodies of a CUDA source."""
    spans, stack = [], []
    for i, ch in enumerate(src):
        if ch == "{":
            head = src[:i].rstrip()
            stack.append((i, head.endswith(")") or head.endswith("const")))
        elif ch == "}" and stack:
            start, is_fn = stack.pop()
            if is_fn and not any(fn for _, fn in stack):
                spans.append((start, i))
    return spans


@pytest.mark.parametrize("source", sorted(f for f in os.listdir(os.path.join(PKG, "csrc")) if f.endswith(".cu")))
def test_shared_memory_attribute_is_keyed_by_device(source):
    """The dynamic shared-memory limit is a per-device attribute: a launch
    function sets it on every launch, or keeps a table indexed by the
    current device, never a process-wide static."""
    with open(os.path.join(PKG, "csrc", source)) as f:
        src = f.read()
    assert not re.search(r"static[^;{}]*=\s*cudaFuncSetAttribute", src)
    for start, end in _function_bodies(src):
        body = src[start:end]
        if "cudaFuncAttributeMaxDynamicSharedMemorySize" not in body:
            continue
        if re.search(r"\bstatic\s", body) or "[dev]" in body:
            assert "cudaGetDevice(&dev)" in body and "[dev]" in body, f"{source}: {src[max(0, start - 200):start]}"
