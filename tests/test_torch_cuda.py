"""Checks that need the card: the Hopper kernel against its plain
PyTorch versions, and a small solve on ``cuda`` against the same solve on
the CPU. They import nothing of JAX, so they run where only the port is
installed::

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without CUDA they skip (the kernel has no CPU mode; ``nvcc`` builds it
at first use).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch.solver import compat_kernels as ck
from karpenter_core_tpu_torch.solver import kernels as pk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _planes(seed, S, T, widths, Z=3, C=2):
    rng = np.random.RandomState(seed)
    keys = tuple(f"key-{i}" for i in range(len(widths)))
    sig = {"valid": rng.rand(S) > 0.1}
    tm, th, tn = {}, {}, {}
    for key, vk in zip(keys, widths):
        sig[f"mask:{key}"] = rng.rand(S, vk) > 0.6
        sig[f"has:{key}"] = rng.rand(S) > 0.3
        sig[f"neg:{key}"] = rng.rand(S) > 0.7
        tm[key] = rng.rand(T, vk) > 0.6
        th[key] = rng.rand(T) > 0.3
        tn[key] = rng.rand(T) > 0.7
    return keys, sig, tm, th, tn, rng.rand(S, Z) > 0.3, rng.rand(S, C) > 0.3, rng.rand(T, Z, C) > 0.5


@pytest.mark.parametrize(
    "seed,S,T,widths",
    [(0, 1, 1, (1,)), (1, 33, 65, (31, 32, 33)), (2, 200, 300, (1, 200, 300)), (3, 70, 2000, (2001, 7))],
)
def test_kernel_matches_plain_versions(cuda, seed, S, T, widths):
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _planes(seed, S, T, widths)
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, cuda)
    planes = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    before = ck.COMPAT_ALLOWED.launches
    got = ck.allowed_via_kernel(planes, catalog, budget_bytes=T * 32).cpu()
    assert ck.COMPAT_ALLOWED.launches - before == -(-S // 32)  # one launch per row block
    plain = ck.allowed_packed_reference(planes, catalog.planes, catalog.layout).cpu()
    assert torch.equal(got, plain)
    ref = pk.allowed(sig, tm, th, tn, zone_ok, ct_ok, avail, keys, device="cpu")
    assert torch.equal(got, ref)
    compat = ck.compat_via_kernel(sig, tm, th, tn, keys, cuda).cpu()
    t = lambda d: pk.to_tensors(d, "cpu")  # noqa: E731
    assert torch.equal(compat, pk.compat_reference(t(sig), t(tm), t(th), t(tn), keys))


@pytest.mark.parametrize("tile", [ck.TILE_SMALL, ck.TILE_LARGE])
@pytest.mark.parametrize("S,T", [(1, 1), (4, 2000), (17, 129), (65, 257), (130, 65)])
def test_each_tile_shape_matches_plain_version(cuda, tile, S, T):
    """Each tile shape, forced, on row counts around both tiles and the
    slice's widths (the 2001-value keys span several staging chunks)."""
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _planes(10 + S, S, T, (2001, 3, 2, 4, 509))
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, cuda)
    planes = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    out = torch.full((S, T), 7, dtype=torch.uint8, device=cuda)
    ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    torch.cuda.synchronize()
    assert set(out.unique().tolist()) <= {0, 1}
    assert torch.equal(out.cpu().bool(), ck.allowed_packed_reference(planes.cpu(), catalog.planes.cpu(), catalog.layout))
    ref = pk.allowed(sig, tm, th, tn, zone_ok, ct_ok, avail, keys, device="cpu")
    assert torch.equal(out.cpu().bool(), ref)


def test_wrapper_rejects_bad_inputs(cuda):
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _planes(4, 8, 8, (5,))
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, cuda)
    planes = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    out = torch.empty((8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="sig_planes"):
        ck.COMPAT_ALLOWED.launch(planes.cpu(), catalog, out)
    with pytest.raises(ValueError, match="sig_planes"):
        ck.COMPAT_ALLOWED.launch(planes.long(), catalog, out)
    with pytest.raises(ValueError, match="out"):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out[:, :4])
    with pytest.raises(ValueError, match="tile"):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=5)


def test_small_solve_on_card_matches_cpu(cuda):
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.objects import Container, Pod, PodSpec, ResourceRequirements
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.solver import TorchScheduler

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(40)
    pool = NodePool()
    pool.metadata.name = "default"
    rng = np.random.RandomState(5)
    pods = []
    for i in range(500):
        p = Pod()
        p.metadata.name = f"p{i}"
        cpu = ["100m", "250m", "500m", "1"][rng.randint(4)]
        p.spec = PodSpec(containers=[Container(name="main", resources=ResourceRequirements(
            requests={"cpu": parse_quantity(cpu), "memory": parse_quantity("256Mi")}))])
        if i % 3 == 0:
            p.spec.node_selector = {wk.CAPACITY_TYPE_LABEL_KEY: "spot"}
        pods.append(p)

    def stream(res):
        return [(q.instance_type.name, q.zone, q.capacity_type, q.price, q.pod_indices) for q in res.node_plans]

    before = ck.COMPAT_ALLOWED.launches
    gpu = TorchScheduler([pool], provider, device="cuda")
    res = gpu.solve(pods)
    assert ck.COMPAT_ALLOWED.launches > before
    assert gpu.last_timings["device_ms"] > 0.0
    cpu = TorchScheduler([pool], provider, device="cpu").solve(pods)
    assert stream(res) == stream(cpu)
    assert res.pod_errors == cpu.pod_errors


def test_pack_existing_plain_version_on_card_matches_native(cuda):
    from karpenter_core_tpu_torch.solver import pack as pp

    rng = np.random.RandomState(21)
    P, M, S, R = 3000, 200, 5, 3
    reqs = rng.randint(1, 12, size=(P, R)).astype(np.int32)
    reqs = reqs[np.lexsort((-reqs[:, 1], -reqs[:, 0]))]
    sig_ids = rng.randint(0, S, size=P).astype(np.int32)
    compat = (rng.rand(S, M) > 0.3).astype(np.uint8)
    free = rng.randint(0, 60, size=(M, R)).astype(np.int32)
    assign, left = pp.run_pack_existing(reqs, sig_ids, compat, free)
    got, got_left = pp.pack_existing_reference(
        *(torch.from_numpy(x).to(cuda) for x in (reqs, sig_ids, compat, free))
    )
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), assign)
    np.testing.assert_array_equal(got_left.cpu().numpy(), left)
    assert (assign >= 0).any() and (assign < 0).any()


def _smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_cluster_solve_on_card_matches_cpu(cuda):
    """A small live cluster (chip_smoke.py's cluster world, cut down):
    the card's plans, existing plans and errors equal the CPU solve's."""
    from karpenter_core_tpu_torch.solver import TorchScheduler

    smoke = _smoke()

    pools, provider, pods, nodes, daemons, missing = smoke.cluster_world(3000, 200, 60)
    before = ck.COMPAT_ALLOWED.launches
    res = TorchScheduler(pools, provider, device="cuda").solve(
        pods, state_nodes=nodes, daemonset_pods=daemons
    )
    assert ck.COMPAT_ALLOWED.launches - before == 2  # one per pool
    cpu = TorchScheduler(pools, provider, device="cpu").solve(
        pods, state_nodes=nodes, daemonset_pods=daemons
    )
    assert smoke.plan_stream(res) == smoke.plan_stream(cpu)
    assert smoke.existing_stream(res) == smoke.existing_stream(cpu)
    assert res.pod_errors == cpu.pod_errors
    smoke.check_cluster(res, pods, nodes, daemons, missing)


def test_zone_spread_solve_on_card_matches_cpu(cuda):
    """Bench config 3 whole, cut down (chip_smoke.py's config3_world):
    zone-spread groups solve on the card to the CPU solve's plans, the
    kernel launched, and every spread group within its max_skew."""
    from karpenter_core_tpu_torch.solver import TorchScheduler

    smoke = _smoke()
    pools, provider, pods = smoke.config3_world(3000, 200)
    before = ck.COMPAT_ALLOWED.launches
    res = TorchScheduler(pools, provider, device="cuda").solve(pods)
    assert ck.COMPAT_ALLOWED.launches - before == 1  # one pool
    cpu = TorchScheduler(pools, provider, device="cpu").solve(pods)
    assert smoke.plan_stream(res) == smoke.plan_stream(cpu)
    assert res.pod_errors == cpu.pod_errors
    smoke.check_invariants(res, pods)
    assert len(smoke.check_spread(res, pods, [], provider)) == 2


def test_hostname_spread_solve_on_card_matches_cpu(cuda):
    """chip_smoke.py's cluster-spread world cut down: hostname spread
    (one replica per node) and seeded zone spread against existing nodes
    and a kube store, on the card, equal to the CPU solve."""
    from karpenter_core_tpu_torch.solver import TorchScheduler

    smoke = _smoke()
    pools, provider, pods, nodes, daemons, missing, kube = smoke.cluster_spread_world(3000, 200, 60, 50)
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    before = ck.COMPAT_ALLOWED.launches
    res = TorchScheduler(pools, provider, device="cuda", kube_client=kube).solve(pods, **kw)
    assert ck.COMPAT_ALLOWED.launches - before >= 2  # one per pool per round
    cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
    assert smoke.plan_stream(res) == smoke.plan_stream(cpu)
    assert smoke.existing_stream(res) == smoke.existing_stream(cpu)
    assert res.pod_errors == cpu.pod_errors
    smoke.check_cluster(res, pods, nodes, daemons, missing)
    smoke.check_spread(res, pods, nodes, provider, kube)
    assert smoke.check_hostname(res, pods, kube)["pods"] == 50


def test_affinity_solve_on_card_matches_cpu(cuda):
    """chip_smoke.py's phase 8 and 9 worlds cut down: bench config 6's
    pod-affinity post-pass, and config 13's anti_dense with a zone quorum
    against existing nodes and a kube store, on the card, each equal to
    its CPU solve and passing the phases' checks."""
    from karpenter_core_tpu_torch.solver import TorchScheduler

    smoke = _smoke()
    pools, provider, pods = smoke.config6_world(700, 40)
    before = ck.COMPAT_ALLOWED.launches
    res = TorchScheduler(pools, provider, device="cuda").solve(pods)
    assert ck.COMPAT_ALLOWED.launches - before == 1  # one pool
    cpu = TorchScheduler(pools, provider, device="cpu").solve(pods)
    assert smoke.plan_stream(res) == smoke.plan_stream(cpu)
    assert res.pod_errors == cpu.pod_errors
    smoke.check_invariants(res, pods)
    assert smoke.check_affinity(res, pods)["affinity_pods"] == 200
    smoke.check_spread_serial(res, pods, provider)

    pools, provider, pods, nodes, daemons, missing, kube = smoke.anti_cluster_world(1000, 200, 30)
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    before = ck.COMPAT_ALLOWED.launches
    res = TorchScheduler(pools, provider, device="cuda", kube_client=kube).solve(pods, **kw)
    assert ck.COMPAT_ALLOWED.launches - before >= 2  # one per pool per round
    cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
    assert smoke.plan_stream(res) == smoke.plan_stream(cpu)
    assert smoke.existing_stream(res) == smoke.existing_stream(cpu)
    assert res.pod_errors == cpu.pod_errors
    smoke.check_cluster(res, pods, nodes, daemons, missing, spill=False)
    assert sorted(smoke.check_anti(res, pods, kube)["quorum_by_zone"].values()) == [1, 1, 1]


# -- the pack engines: the FFD scan, the existing-node first-fit, the dual ascent --


def _ffd_class(seed, G, P, F, R, cap, lo=1, hi=60):
    """A padded class of FFD jobs as ``batch_pack`` builds it (sentinel
    padding pods past each job's pods)."""
    rng = np.random.RandomState(seed)
    req = np.zeros((G, P, R), np.int32)
    front = rng.randint(50, 400, size=(G, F, R)).astype(np.int32)
    n = rng.randint(1, P + 1, size=G).astype(np.int32)
    for g in range(G):
        r = rng.randint(lo, hi, size=(n[g], R)).astype(np.int32)
        req[g] = front[g].max(axis=0) + 1
        req[g, : n[g]] = r[np.argsort(-r[:, 0], kind="stable")]
    return req, front, np.full(G, cap, np.int32), n


def _ffd_kernel_check(cuda, arrays, k_open):
    """One launch of the FFD kernel on a padded class, bit for bit against
    the plain version on the card and on the CPU → (ids, counts)."""
    from karpenter_core_tpu_torch.solver import pack

    req, front, caps, n = (torch.from_numpy(a).to(cuda) for a in arrays)
    before = pack.FFD_PACK.launches
    ids, counts = pack.ffd_pack_batched(req, front, caps, k_open, n)
    torch.cuda.synchronize()
    assert pack.FFD_PACK.launches - before == 1
    plain_ids, plain_counts = pack.ffd_pack_reference(req, front, caps, k_open)
    assert torch.equal(ids, plain_ids) and torch.equal(counts, plain_counts)
    cpu_ids, cpu_counts = pack.ffd_pack_reference(*(torch.from_numpy(a) for a in arrays[:3]), k_open)
    assert torch.equal(ids.cpu(), cpu_ids) and torch.equal(counts.cpu(), cpu_counts)
    return ids.cpu().numpy(), counts.cpu().numpy()


@pytest.mark.parametrize(
    "seed,G,P,F,R,cap,k_open",
    [(0, 1, 1, 1, 1, 110, 16), (1, 5, 300, 7, 3, 7, 16), (2, 64, 512, 32, 4, 110, 16),
     (3, 3, 600, 2, 2, 2**31 - 1, 16), (4, 4, 200, 4, 9, 2, 32), (5, 2, 100, 3, 3, 110, 1)],
)
def test_ffd_pack_kernel_matches_plain_version(cuda, seed, G, P, F, R, cap, k_open):
    _ffd_kernel_check(cuda, _ffd_class(seed, G, P, F, R, cap, hi=120 if seed == 3 else 60), k_open)


def _ffd_key_ties():
    """Ones onto a 300 x 300 frontier: counts in the hundreds and ids past
    16 round to equal float32 keys, which tie to the lower slot."""
    req = np.ones((2, 6000, 2), np.int32)
    front = np.full((2, 1, 2), 300, np.int32)
    return req, front, np.array([2**31 - 1, 250], np.int32), np.full(2, 6000, np.int32)


def _ffd_eviction_tie():
    """Every pod needs a node of its own and every open slot has the same
    headroom: the evicted slot is the first of the least."""
    req = np.zeros((3, 96, 2), np.int32)
    req[:, :, 0] = np.repeat([70, 60], 48)[None]
    req[:, :, 1] = 10
    n = np.array([96, 95, 33], np.int32)
    for g in range(3):
        req[g, n[g] :] = 101  # padding: above the frontier
    front = np.full((3, 1, 2), 100, np.int32)
    return req, front, np.array([110, 2**31 - 1, 1], np.int32), n


# edge cases of the warp-per-job design, each (arrays, k_open)
FFD_EDGE_CASES = {
    "key-ties-at-large-counts": lambda: (_ffd_key_ties(), 16),
    "eviction-tie": lambda: (_ffd_eviction_tie(), 16),
    "cap-1": lambda: (_ffd_class(30, 4, 300, 3, 3, 1), 16),
    "cap-int-inf": lambda: (_ffd_class(31, 4, 600, 2, 2, 2**31 - 1, lo=40, hi=120), 16),
    "frontier-40-rows": lambda: (_ffd_class(32, 3, 400, 40, 3, 110), 16),
    "frontier-64-rows": lambda: (_ffd_class(33, 2, 300, 64, 4, 110), 32),
    "width-12": lambda: (_ffd_class(34, 5, 250, 3, 12, 110), 16),
    "width-20": lambda: (_ffd_class(35, 5, 250, 3, 20, 110), 16),
    "jobs-5-ragged": lambda: (_ffd_class(36, 5, 500, 4, 3, 110), 16),
    "jobs-7-ragged": lambda: (_ffd_class(37, 7, 129, 2, 5, 7), 16),
    "pods-333": lambda: (_ffd_class(38, 1, 333, 3, 3, 110), 16),
    "k-1": lambda: (_ffd_class(39, 3, 200, 3, 3, 110), 1),
    "k-4": lambda: (_ffd_class(40, 3, 300, 3, 3, 110, lo=40, hi=120), 4),
    "k-32": lambda: (_ffd_class(41, 3, 700, 3, 3, 110, lo=40, hi=120), 32),
}


@pytest.mark.parametrize("case", sorted(FFD_EDGE_CASES))
def test_ffd_pack_kernel_edge_cases(cuda, case):
    arrays, k_open = FFD_EDGE_CASES[case]()
    ids, counts = _ffd_kernel_check(cuda, arrays, k_open)
    if case == "eviction-tie":
        assert (counts > 32).all()
    if case == "key-ties-at-large-counts":
        assert (ids >= 16).any()


def _existing_kernel_check(cuda, arrays):
    """One launch of the first-fit kernel, bit for bit against the plain
    version on the card → assign (numpy)."""
    from karpenter_core_tpu_torch.solver import pack

    req, sig, compat, free = (torch.from_numpy(a).to(cuda) for a in arrays)
    before = pack.PACK_EXISTING.launches
    assign, out = pack.pack_existing(req, sig, compat, free)
    torch.cuda.synchronize()
    assert pack.PACK_EXISTING.launches - before == 1
    plain_assign, plain_free = pack.pack_existing_reference(req, sig, compat, free)
    assert torch.equal(assign, plain_assign) and torch.equal(out, plain_free)
    assert torch.equal(free.cpu(), torch.from_numpy(arrays[3]))  # input untouched
    return assign.cpu().numpy()


def _existing_arrays(seed, P, M, S, R, p_compat=0.6, free_hi=200):
    rng = np.random.RandomState(seed)
    req = rng.randint(1, 40, size=(P, R)).astype(np.int32)
    sig = rng.randint(0, S, size=P).astype(np.int32)
    compat = (rng.rand(S, M) < p_compat).astype(np.uint8)
    free = rng.randint(0, free_hi, size=(M, R)).astype(np.int32)
    return req, sig, compat, free


@pytest.mark.parametrize("seed,P,M,S,R", [(0, 1, 1, 1, 1), (1, 300, 40, 5, 3), (2, 2000, 1100, 6, 4), (3, 500, 3000, 4, 20)])
def test_pack_existing_kernel_matches_plain_version(cuda, seed, P, M, S, R):
    _existing_kernel_check(cuda, _existing_arrays(seed, P, M, S, R))


# edge cases of the one-barrier design: several nodes per thread on each
# register path and its edges (4,096 nodes at 4 axes, 2,048 at 16), the
# generic path past them and past 64 signatures, pods that fit nowhere,
# ragged chunks
EXISTING_EDGE_CASES = {
    "narrow-4096-nodes": lambda: _existing_arrays(58, 700, 4096, 4, 4),
    "wide-2048-nodes-16-axes": lambda: _existing_arrays(59, 700, 2048, 3, 16),
    "generic-2049-nodes-16-axes": lambda: _existing_arrays(60, 700, 2049, 3, 16),
    "wide-5-axes-1-signature": lambda: _existing_arrays(61, 900, 1000, 1, 5),
    "nodes-2500": lambda: _existing_arrays(50, 1500, 2500, 4, 3),
    "nodes-5000-wide": lambda: _existing_arrays(51, 800, 5000, 3, 10),
    "signatures-100": lambda: _existing_arrays(52, 1200, 700, 100, 3),
    "signatures-80-free-in-device-memory": lambda: _existing_arrays(53, 600, 30_000, 80, 4),
    "fit-nowhere": lambda: _existing_arrays(54, 400, 600, 4, 3, p_compat=0.0),
    "full-nodes": lambda: _existing_arrays(55, 400, 600, 4, 3, free_hi=1),
    "pods-257": lambda: _existing_arrays(56, 257, 900, 5, 3),
    "pods-1000": lambda: _existing_arrays(57, 1000, 200, 5, 6),
}


@pytest.mark.parametrize("case", sorted(EXISTING_EDGE_CASES))
def test_pack_existing_kernel_edge_cases(cuda, case):
    assign = _existing_kernel_check(cuda, EXISTING_EDGE_CASES[case]())
    if case in ("fit-nowhere", "full-nodes"):
        assert (assign == -1).all()
    else:
        assert (assign >= 0).any()


@pytest.mark.parametrize("seed,S,T,R,iters", [(0, 1, 1, 1, 8), (1, 8, 64, 3, 160), (2, 37, 300, 5, 160), (3, 16, 2048, 6, 160), (4, 64, 2048, 12, 40)])
def test_dual_ascent_kernel_matches_plain_version(cuda, seed, S, T, R, iters):
    """t* and has_fit exactly; w within the rtol of tests/test_torch_lp.py
    (both sum in the same order, so they agree bit for bit in practice).
    T = 2048 with R = 12 takes the global-scratch layout."""
    from karpenter_core_tpu_torch.solver.backends import lp

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(seed)
    Sp, Tp = max(8, 1 << (S - 1).bit_length()), max(8, 1 << (T - 1).bit_length())
    reqs = np.zeros((Sp, R), np.float32)
    reqs[:S] = rng.randint(1, 200, size=(S, R))
    counts = np.zeros(Sp, np.float32)
    counts[:S] = rng.randint(1, 50, size=S)
    alloc = np.zeros((Tp, R), np.float32)
    alloc[:T] = rng.randint(100, 4000, size=(T, R))
    prices = np.full(Tp, np.float32(1e12), np.float32)
    prices[:T] = rng.rand(T) * 10 + 0.5
    valid = np.zeros(Tp, bool)
    valid[:T] = rng.rand(T) < 0.9
    w0 = (1.0 / np.maximum(alloc, 1.0)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (reqs, counts, alloc, prices, valid, w0)]
    before = lp.DUAL_ASCENT.launches
    w, t_star, has_fit = lp.dual_ascent(*args, iters)
    torch.cuda.synchronize()
    assert lp.DUAL_ASCENT.launches - before == 1
    pw, pt, ph = lp.dual_ascent_reference(*args, iters)
    assert torch.equal(t_star, pt) and torch.equal(has_fit, ph)
    assert torch.allclose(w, pw, rtol=1e-5, atol=0.0)
    cw, ct, ch = lp.dual_ascent_reference(*(torch.from_numpy(a) for a in (reqs, counts, alloc, prices, valid, w0)), iters)
    assert torch.equal(t_star.cpu(), ct) and torch.equal(has_fit.cpu(), ch)
    assert torch.allclose(w.cpu(), cw, rtol=1e-5, atol=0.0)


def test_pack_wrappers_reject_bad_inputs(cuda):
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver.backends import lp

    req = torch.ones((1, 4, 2), dtype=torch.int64, device=cuda)
    front = torch.ones((1, 1, 2), dtype=torch.int32, device=cuda)
    caps = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="requests"):
        pack.ffd_pack_batched(req, front, caps)
    with pytest.raises(RuntimeError, match="cudaError"):
        pack.ffd_pack_batched(req.to(torch.int32), front, caps, k_open=40)
    with pytest.raises(ValueError, match="compat"):
        pack.pack_existing(
            torch.ones((2, 2), dtype=torch.int32, device=cuda), torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.ones((1, 3), dtype=torch.bool, device=cuda), torch.ones((3, 2), dtype=torch.int32, device=cuda),
        )
    f = lambda *shape: torch.ones(shape, dtype=torch.float32, device=cuda)  # noqa: E731
    with pytest.raises(RuntimeError, match="cudaError"):
        lp.dual_ascent(f(8, 17), f(8), f(8, 17), f(8), torch.ones(8, dtype=torch.bool, device=cuda), f(8, 17), 8)


def test_device_engine_and_lp_solves_on_card_match_cpu(cuda, monkeypatch):
    """The device engine (native packer off) on a small cluster and the LP
    backend on two config-10 shapes, on the card: each launches its
    kernels and equals its CPU solve."""
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, pack
    from karpenter_core_tpu_torch.solver.backends import lp

    smoke = _smoke()
    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    pools, provider, pods, nodes, daemons, missing = smoke.cluster_world(2000, 120, 40)
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    before = (pack.FFD_PACK.launches, pack.PACK_EXISTING.launches)
    res = TorchScheduler(pools, provider, device="cuda").solve(pods, **kw)
    assert pack.FFD_PACK.launches > before[0] and pack.PACK_EXISTING.launches > before[1]
    cpu = TorchScheduler(pools, provider, device="cpu").solve(pods, **kw)
    assert smoke.plan_stream(res) == smoke.plan_stream(cpu)
    assert smoke.existing_stream(res) == smoke.existing_stream(cpu)
    assert res.pod_errors == cpu.pod_errors
    smoke.check_cluster(res, pods, nodes, daemons, missing)
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE")
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", "lp")
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider

    for name, catalog, pods in smoke.config10_shapes()[:4:3]:
        got = []
        for dev in ("cuda", "cpu"):
            backends.reset_for_tests()
            provider = FakeCloudProvider()
            provider.instance_types = list(catalog)
            pool = NodePool()
            pool.metadata.name = "default"
            before = lp.DUAL_ASCENT.launches
            res = TorchScheduler([pool], provider, device=dev).solve(pods)
            if dev == "cuda":
                assert lp.DUAL_ASCENT.launches - before == 3  # one relax, two refinements
            got.append((smoke.plan_sha256(res), round(res.total_price, 4)))
        assert got[0] == got[1]
        assert got[0][1] == smoke.CONFIG10_REFERENCE[name][1]
