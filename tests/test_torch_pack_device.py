"""The port's device pack engine ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch.solver.pack``'s device route (``engine=
"device"``, or ``auto`` with ``KARPENTER_TORCH_NATIVE=0``) runs the FFD
scan (``ffd_pack_batched``) and the existing-node first-fit
(``pack_existing``) on the scheduler's device: on the card the Hopper
kernels ``csrc/ffd_pack.cu`` and ``csrc/pack_existing.cu``, on the CPU
their plain PyTorch versions. This file holds, bit for bit, on
numpy-seeded jobs:

- the plain FFD scan and ``batch_pack(engine="device")`` against the JAX
  package's ``ffd_pack_batched`` and ``batch_pack(engine="device")``:
  ragged P and F in one batch, per-node caps, unschedulable pods, slot
  eviction past 16 open nodes and eviction ties, float32 key ties at
  large counts, closed slots after an eviction, stateful extra columns
  (widths 5, 12 and 20), frontiers past 32 rows, and the bench engine
  shootout's 64 jobs x 512 pods x 4 axes with 32-row frontiers
  (``bench.py:2565-2568``);
- the plain first-fit and ``run_pack_existing(engine="device")`` against
  the JAX ``pack_existing`` scan, on each of the kernel's paths;
- each kernel's step, the ``.cu`` source built by g++ as C++
  (``ffd_pack_host``, ``pack_existing_host``: the card's lane and thread
  functions, each warp collective a loop over the lanes), against the
  same;
- a whole solve on the device engine against ``TPUScheduler`` with its
  native packer off, alone and against a small cluster: plans, existing
  plans and errors identical;
- ``KARPENTER_TORCH_NATIVE=0`` moving ``auto`` to the device engine, and
  a failed native build raising with the knob unset.
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_core_tpu.native as ref_native
from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu.solver import pack as ref_pack
from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch import native as port_native
from karpenter_core_tpu_torch.solver import TorchScheduler
from karpenter_core_tpu_torch.solver import pack as port_pack
from test_torch_existing import Kit, errors_by_index, existing_stream, plan_stream

REF = "karpenter_core_tpu"
PORT = "karpenter_core_tpu_torch"

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions step through many small ops: one intra-op
    thread runs them as fast and leaves the other test workers their
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_HOST: dict = {}


def _host(source: str):
    """``csrc/<source>`` built by g++: the kernel's step functions."""
    if source not in _HOST:
        lib = buildlib.host_library(source)
        if source == "ffd_pack.cu":
            lib.ffd_pack_host.restype = ctypes.c_int
            lib.ffd_pack_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
        else:
            lib.pack_existing_host.restype = ctypes.c_int
            lib.pack_existing_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 2
        _HOST[source] = lib
    return _HOST[source]


def device_engine_off_native(monkeypatch) -> None:
    """Both packages' packers off for a whole solve: the port through its
    knob, the reference by its ``available`` (its own knob is read once
    per process)."""
    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)


# -- the FFD scan ------------------------------------------------------------------


def _job(rng, P, F, R, cap, lo=1, hi=60, front=(50, 400)):
    reqs = rng.randint(lo, hi, size=(P, R)).astype(np.int32)
    reqs = reqs[np.argsort(-reqs[:, 0], kind="stable")]
    frontier = rng.randint(front[0], front[1], size=(F, R)).astype(np.int32)
    return reqs, frontier, np.int32(cap)


def _ragged(seed):
    rng = np.random.RandomState(seed)
    return [
        _job(rng, int(rng.randint(1, 300)), int(rng.randint(1, 9)), 3, int(rng.choice([3, 7, 110, 2**31 - 1])))
        for _ in range(5)
    ]


def _caps(seed):
    rng = np.random.RandomState(seed)
    return [_job(rng, 200, 4, 2, cap) for cap in (1, 2, 5, 110)]


def _unschedulable(seed):
    rng = np.random.RandomState(seed)
    reqs, frontier, cap = _job(rng, 120, 3, 3, 110)
    reqs[::7] = 10_000  # above every frontier row
    reqs = reqs[np.argsort(-reqs[:, 0], kind="stable")]
    return [(reqs, frontier, cap), _job(rng, 40, 2, 3, 110)]


def _eviction(seed):
    # pods of about half a node: far more than 16 nodes open, slots evict
    rng = np.random.RandomState(seed)
    return [_job(rng, 600, 2, 2, 2**31 - 1, lo=40, hi=120, front=(200, 260)) for _ in range(2)]


def _stateful(seed):
    # two widths in one batch: port-feature columns widen R, and each
    # fresh-node port capacity is 1 (one pod per port per node)
    rng = np.random.RandomState(seed)
    plain = [_job(rng, 150, 3, 3, 110) for _ in range(2)]
    reqs, frontier, cap = _job(rng, 150, 3, 3, 110)
    ports = (rng.rand(150, 2) < 0.3).astype(np.int32)
    return plain + [
        (np.hstack([reqs, ports]), np.hstack([frontier, np.ones((3, 2), np.int32)]), cap)
    ]


def _shootout(seed):
    rng = np.random.RandomState(5 + seed)
    jobs = []
    for _ in range(64):
        reqs = rng.randint(1, 200, size=(512, 4)).astype(np.int32)
        frontier = np.sort(rng.randint(500, 4000, size=(32, 4)).astype(np.int32), axis=0)[::-1].copy()
        jobs.append((reqs, frontier, np.int32(110)))
    return jobs


def _key_ties(seed):
    # counts in the hundreds and node ids past 16: count + id * 1e-7
    # rounds to equal float32 keys, which must tie to the lower slot
    del seed
    reqs = np.ones((3000, 2), np.int32)
    front = np.array([[300, 300]], np.int32)
    return [(reqs, front, np.int32(2**31 - 1)), (reqs, front, np.int32(250))]


def _eviction_tie(seed):
    # every pod needs a node of its own and the slots' headrooms tie: the
    # evicted slot is the first of the least
    rng = np.random.RandomState(seed)
    reqs = np.sort(rng.choice([60, 70], size=(90, 1)), axis=0)[::-1]
    reqs = np.hstack([reqs, np.full_like(reqs, 10)]).astype(np.int32)
    return [(reqs, np.array([[100, 100]], np.int32), np.int32(110))]


def _closed_after_eviction(seed):
    # a job that evicts, then in the same batch jobs that open closed
    # slots in order (cap 1 forces a node per pod) and fill them again
    rng = np.random.RandomState(seed)
    evict = _job(rng, 300, 2, 2, 2**31 - 1, lo=40, hi=120, front=(200, 260))
    capped = _job(rng, 10, 2, 2, 1)
    return [evict, capped, _job(rng, 50, 3, 2, 4)]


def _wide(seed, extra):
    # stateful widths: port-feature columns past the base axes
    rng = np.random.RandomState(seed)
    jobs = []
    for _ in range(3):
        reqs, frontier, cap = _job(rng, int(rng.randint(40, 200)), 3, 3, 110)
        ports = (rng.rand(len(reqs), extra) < 0.2).astype(np.int32)
        jobs.append((np.hstack([reqs, ports]), np.hstack([frontier, np.ones((3, extra), np.int32)]), cap))
    return jobs


def _wide_frontier(seed):
    rng = np.random.RandomState(seed)
    return [_job(rng, 333, 40, 3, 110, front=(30, 400)), _job(rng, 65, 33, 3, 7, front=(30, 400))]


FFD_CASES = {
    "key-ties-at-large-counts": lambda: _key_ties(0),
    "eviction-tie": lambda: _eviction_tie(17),
    "closed-after-eviction": lambda: _closed_after_eviction(18),
    "width-12": lambda: _wide(19, 9),
    "width-20": lambda: _wide(20, 17),
    "frontier-past-32": lambda: _wide_frontier(21),
    "ragged-0": lambda: _ragged(0),
    "ragged-1": lambda: _ragged(1),
    "ragged-2": lambda: _ragged(2),
    "per-node-caps": lambda: _caps(3),
    "unschedulable": lambda: _unschedulable(4),
    "eviction-past-16": lambda: _eviction(5),
    "stateful-columns": lambda: _stateful(6),
    "shootout-64x512x4": lambda: _shootout(0),
}


def _padded(jobs):
    """One class of the jobs as the reference pads it: (G, P, R)
    requests with sentinel pods, (G, F_pad, R) frontiers, caps, pods."""
    P = max(j[0].shape[0] for j in jobs)
    R = jobs[0][0].shape[1]
    F_pad = 1 << max((max(len(j[1]) for j in jobs) - 1).bit_length(), 0)
    req = np.zeros((len(jobs), P, R), np.int32)
    front = np.zeros((len(jobs), F_pad, R), np.int32)
    caps = np.zeros(len(jobs), np.int32)
    n = np.zeros(len(jobs), np.int32)
    for g, (r, f, c) in enumerate(jobs):
        req[g] = f.max(axis=0) + 1
        req[g, : len(r)] = r
        front[g, : len(f)] = f
        caps[g] = c
        n[g] = len(r)
    return req, front, caps, n


@pytest.mark.parametrize("case", sorted(FFD_CASES))
def test_batch_pack_device_matches_reference(case):
    jobs = FFD_CASES[case]()
    ref = ref_pack.batch_pack(jobs, engine="device")
    got = port_pack.batch_pack(jobs, engine="device", device="cpu")
    assert len(got) == len(ref)
    for (ids, n), (rids, rn) in zip(got, ref):
        assert int(n) == int(rn)
        assert np.array_equal(np.asarray(ids), np.asarray(rids))
    # the kernel's g++-built step on the same class, padded as batch_pack pads it
    req, front, caps, n = _padded(jobs) if len({j[0].shape[1] for j in jobs}) == 1 else (None,) * 4
    if req is not None:
        h_ids = np.full(req.shape[:2], 7, np.int32)
        h_cnt = np.zeros(len(jobs), np.int32)
        assert _host("ffd_pack.cu").ffd_pack_host(
            req.ctypes.data, front.ctypes.data, caps.ctypes.data, n.ctypes.data, *req.shape[:2],
            front.shape[1], req.shape[2], 16, h_ids.ctypes.data, h_cnt.ctypes.data,
        ) == 0
        for g, (rids, rn) in enumerate(ref):
            assert np.array_equal(h_ids[g, : len(rids)], np.asarray(rids)) and h_cnt[g] == int(rn)
            assert (h_ids[g, len(rids) :] == -1).all()
    if case in ("eviction-past-16", "eviction-tie"):
        assert all(int(n) > 16 for _, n in got)
    if case == "unschedulable":
        assert (np.asarray(got[0][0]) == -1).sum() == (jobs[0][0][:, 0] == 10_000).sum()


@pytest.mark.parametrize(
    "case", sorted(c for c in FFD_CASES if c not in ("stateful-columns", "shootout-64x512x4", "width-12", "width-20"))
)
def test_ffd_scan_and_kernel_steps_match_reference(case):
    """One class, padded as the reference pads it: the plain scan
    (``ffd_pack_reference`` through ``ffd_pack_batched``) and the
    kernel's g++-built step against the JAX ``ffd_pack_batched``."""
    req, front, caps, n = _padded(FFD_CASES[case]())
    G, P, R = req.shape
    rids, rn = ref_pack.ffd_pack_batched(jnp.asarray(req), jnp.asarray(front), jnp.asarray(caps), k_open=16)
    rids, rn = np.asarray(rids), np.asarray(rn)
    ids, cnt = port_pack.ffd_pack_batched(
        torch.from_numpy(req), torch.from_numpy(front), torch.from_numpy(caps), 16, torch.from_numpy(n)
    )
    assert np.array_equal(ids.numpy(), rids) and np.array_equal(cnt.numpy(), rn)
    full, full_cnt = port_pack.ffd_pack_reference(
        torch.from_numpy(req), torch.from_numpy(front), torch.from_numpy(caps)
    )
    assert np.array_equal(full.numpy(), rids) and np.array_equal(full_cnt.numpy(), rn)
    h_ids = np.full((G, P), 7, np.int32)
    h_cnt = np.zeros(G, np.int32)
    rc = _host("ffd_pack.cu").ffd_pack_host(
        req.ctypes.data, front.ctypes.data, caps.ctypes.data, n.ctypes.data,
        G, P, front.shape[1], R, 16, h_ids.ctypes.data, h_cnt.ctypes.data,
    )
    assert rc == 0
    assert np.array_equal(h_ids, rids) and np.array_equal(h_cnt, rn)


@pytest.mark.parametrize("k_open", [1, 4, 32])
def test_ffd_scan_other_slot_counts(k_open):
    req, front, caps, n = _padded(_ragged(7))
    rids, rn = ref_pack.ffd_pack_batched(
        jnp.asarray(req), jnp.asarray(front), jnp.asarray(caps), k_open=k_open
    )
    ids, cnt = port_pack.ffd_pack_batched(
        torch.from_numpy(req), torch.from_numpy(front), torch.from_numpy(caps), k_open
    )
    assert np.array_equal(ids.numpy(), np.asarray(rids)) and np.array_equal(cnt.numpy(), np.asarray(rn))
    h_ids = np.empty_like(req[:, :, 0])
    h_cnt = np.empty(len(req), np.int32)
    assert _host("ffd_pack.cu").ffd_pack_host(
        req.ctypes.data, front.ctypes.data, caps.ctypes.data, n.ctypes.data, *req.shape[:2],
        front.shape[1], req.shape[2], k_open, h_ids.ctypes.data, h_cnt.ctypes.data,
    ) == 0
    assert np.array_equal(h_ids, np.asarray(rids)) and np.array_equal(h_cnt, np.asarray(rn))


def test_ffd_key_ties_at_large_counts():
    """Counts in the hundreds and node ids past 16: count + id * 1e-7
    rounds to equal float32 keys, and the first slot must win as in the
    reference."""
    reqs = np.ones((3000, 2), np.int32)
    front = np.array([[300, 300]], np.int32)
    for cap in (2**31 - 1, 250):
        rids, rn = ref_pack.ffd_pack(jnp.asarray(reqs), jnp.asarray(front), jnp.int32(cap), k_open=16)
        ids, n = port_pack.ffd_pack(torch.from_numpy(reqs), torch.from_numpy(front), cap)
        assert np.array_equal(ids.numpy(), np.asarray(rids)) and int(n) == int(rn)


def test_ffd_kernel_refuses_bad_arguments():
    req, front, caps, n = _padded(_ragged(8))
    out = np.empty(req.shape[:2], np.int32)
    cnt = np.empty(len(req), np.int32)
    lib = _host("ffd_pack.cu")
    for K in (0, 33):
        assert lib.ffd_pack_host(
            req.ctypes.data, front.ctypes.data, caps.ctypes.data, n.ctypes.data, *req.shape[:2],
            front.shape[1], req.shape[2], K, out.ctypes.data, cnt.ctypes.data,
        ) != 0
    with pytest.raises(RuntimeError, match="cuda"):
        port_pack.batch_pack(_ragged(8), engine="device")  # the card, which this host lacks


# -- the existing-node first-fit -----------------------------------------------------


def _existing(seed, P=300, M=40, S=5, R=3):
    rng = np.random.RandomState(seed)
    reqs = rng.randint(1, 40, size=(P, R)).astype(np.int32)
    reqs = reqs[np.argsort(-reqs[:, 0], kind="stable")]
    sig = rng.randint(0, S, size=P).astype(np.int32)
    compat = (rng.rand(S, M) < 0.6).astype(np.uint8)
    free = rng.randint(0, 200, size=(M, R)).astype(np.int32)
    return reqs, sig, compat, free


EXISTING_CASES = {
    **{f"seed-{s}": (lambda s=s: _existing(s)) for s in range(4)},
    "wide-columns": lambda: _existing(9, P=200, M=30, S=3, R=9),
    "many-nodes": lambda: _existing(10, P=400, M=1100, S=4, R=4),
    # the kernel's other paths: the wide register rows at their edge
    # (2,048 nodes, 16 axes), the generic path past 64 signatures and
    # past the register paths' nodes
    "wide-2048-nodes-16-axes": lambda: _existing(24, P=300, M=2048, S=3, R=16),
    "signatures-past-64": lambda: _existing(22, P=600, M=300, S=100, R=3),
    "free-in-device-memory": lambda: _existing(23, P=150, M=30_000, S=70, R=4),
    "all-incompatible": lambda: (lambda r, s, c, f: (r, s, np.zeros_like(c), f))(*_existing(11)),
    "full-nodes": lambda: (lambda r, s, c, f: (r, s, c, np.zeros_like(f)))(*_existing(12)),
}


@pytest.mark.parametrize("case", sorted(EXISTING_CASES))
def test_pack_existing_device_matches_reference(case):
    reqs, sig, compat, free = EXISTING_CASES[case]()
    rassign, rfree = ref_pack.pack_existing(
        jnp.asarray(reqs), jnp.asarray(sig), jnp.asarray(compat.astype(bool)), jnp.asarray(free)
    )
    rassign, rfree = np.asarray(rassign), np.asarray(rfree)
    assign, out = port_pack.run_pack_existing(reqs, sig, compat, free, engine="device", device="cpu")
    assert np.array_equal(assign, rassign) and np.array_equal(out, rfree)
    ta, tf = port_pack.pack_existing(
        torch.from_numpy(reqs), torch.from_numpy(sig), torch.from_numpy(compat), torch.from_numpy(free)
    )
    assert np.array_equal(ta.numpy(), rassign) and np.array_equal(tf.numpy(), rfree)
    P, R = reqs.shape
    S, M = compat.shape
    h_assign = np.full(P, 7, np.int32)
    h_free = np.empty_like(free)
    rc = _host("pack_existing.cu").pack_existing_host(
        reqs.ctypes.data, sig.ctypes.data, compat.ctypes.data, free.ctypes.data,
        P, R, S, M, h_free.ctypes.data, h_assign.ctypes.data,
    )
    assert rc == 0
    assert np.array_equal(h_assign, rassign) and np.array_equal(h_free, rfree)
    if case.startswith("seed"):
        assert (rassign >= 0).any() and (rassign < 0).any()


def test_pack_existing_refuses_bad_signatures():
    reqs, sig, compat, free = _existing(13)
    sig = sig.copy()
    sig[3] = compat.shape[0]
    with pytest.raises(ValueError, match="sig_ids"):
        port_pack.run_pack_existing(reqs, sig, compat, free, engine="device", device="cpu")
    out, assign = np.empty_like(free), np.empty(len(reqs), np.int32)
    assert _host("pack_existing.cu").pack_existing_host(
        reqs.ctypes.data, sig.ctypes.data, compat.ctypes.data, free.ctypes.data,
        len(reqs), reqs.shape[1], compat.shape[0], compat.shape[1], out.ctypes.data, assign.ctypes.data,
    ) != 0


# -- whole solves on the device engine ------------------------------------------------


def _mixed(seed, n_pods=300, n_nodes=0):
    def build(k):
        rng = np.random.RandomState(seed)
        cpus = ["100m", "250m", "500m", "1", "2"]
        mems = ["128Mi", "512Mi", "1Gi", "2Gi"]
        pods = [
            k.pod(f"p-{i}", {"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]})
            for i in range(n_pods)
        ]
        sns = [k.state_node(f"node-{i}", cpu="4", memory="16Gi") for i in range(n_nodes)]
        return [k.nodepool()], k.provider(n_types=12), pods, sns, []

    return build


DEVICE_WORLDS = {
    "alone-0": _mixed(0),
    "alone-1": _mixed(1, n_pods=700),
    "cluster-0": _mixed(2, n_nodes=12),
    "cluster-1": _mixed(3, n_pods=500, n_nodes=30),
}


@pytest.mark.parametrize("world", sorted(DEVICE_WORLDS))
def test_device_engine_solve_matches_reference(monkeypatch, world):
    device_engine_off_native(monkeypatch)
    calls = {"ffd": 0, "existing": 0}
    real_ffd, real_existing = port_pack.ffd_pack_batched, port_pack.pack_existing

    def ffd(*a, **kw):
        calls["ffd"] += 1
        return real_ffd(*a, **kw)

    def existing(*a, **kw):
        calls["existing"] += 1
        return real_existing(*a, **kw)

    monkeypatch.setattr(port_pack, "ffd_pack_batched", ffd)
    monkeypatch.setattr(port_pack, "pack_existing", existing)
    out = []
    for pkg in (REF, PORT):
        pools, provider, pods, nodes, daemons = DEVICE_WORLDS[world](Kit(pkg))
        solver = TPUScheduler(pools, provider) if pkg == REF else TorchScheduler(pools, provider, device="cpu")
        out.append((solver.solve(pods, state_nodes=nodes, daemonset_pods=daemons), pods))
    (ref, ref_pods), (res, pods) = out
    assert plan_stream(res) == plan_stream(ref)
    assert existing_stream(res) == existing_stream(ref)
    assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
    assert (res.node_count, res.pods_scheduled, res.total_price) == (
        ref.node_count, ref.pods_scheduled, ref.total_price
    )
    assert calls["ffd"] >= 1
    assert calls["existing"] >= (1 if world.startswith("cluster") else 0)
    if world.startswith("cluster"):
        assert res.existing_plans


def test_device_and_native_engines_differ_as_in_the_reference():
    """K = 16 against K = 1024: once more than 16 nodes are open the two
    engines partition differently (slot eviction), as in the JAX package."""
    jobs = _eviction(16)
    native = port_pack.batch_pack(jobs, engine="native")
    device = port_pack.batch_pack(jobs, engine="device", device="cpu")
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(native, device))


def test_native_knob_moves_auto_to_the_device_engine(monkeypatch):
    jobs = _ragged(9)
    reqs, sig, compat, free = _existing(14)
    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    assert not port_native.available()
    auto = port_pack.batch_pack(jobs, device="cpu")
    device = port_pack.batch_pack(jobs, engine="device", device="cpu")
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(auto, device))
    assert np.array_equal(
        port_pack.run_pack_existing(reqs, sig, compat, free, device="cpu")[0],
        port_pack.run_pack_existing(reqs, sig, compat, free, engine="device", device="cpu")[0],
    )
    with pytest.raises(RuntimeError, match="KARPENTER_TORCH_NATIVE"):
        port_pack.batch_pack(jobs, engine="native")
    # numpy picks the cheapest fitting types when the packer is off
    usage = np.array([[3, 3], [9, 9], [50, 50]], np.int32)
    alloc = np.array([[4, 4], [10, 10]], np.int32)
    prices = np.array([1.0, 2.0])
    assert port_pack.assign_cheapest_types(usage, alloc, prices).tolist() == [0, 1, -1]
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE")
    assert port_native.available()
    assert port_pack.assign_cheapest_types(usage, alloc, prices).tolist() == [0, 1, -1]


def test_failed_native_build_raises_with_the_knob_unset(monkeypatch):
    """No quiet move to the device engine: with KARPENTER_TORCH_NATIVE
    unset, a packer that cannot build raises from every pack call."""
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE", raising=False)
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "GXX_CMD", ["false"])
    with pytest.raises(RuntimeError, match="failed"):
        port_pack.batch_pack(_ragged(10))
    reqs, sig, compat, free = _existing(15)
    with pytest.raises(RuntimeError, match="failed"):
        port_pack.run_pack_existing(reqs, sig, compat, free)
