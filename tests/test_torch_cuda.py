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
