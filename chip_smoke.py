#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``karpenter_core_tpu_torch``) on one
NVIDIA card and check it.

Phases, in order; any failure exits non-zero:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the Hopper compat∧offering kernel (nvcc) and the C++
   packer (g++) from the repo's sources, in parallel.
3. Kernel: the kernel, through the wrapper's own tile pick and with
   each of its two tile shapes forced, against its plain PyTorch
   versions on the card, bit for bit, on seeded ragged planes, the
   slice's, config 3's and the cluster-spread phase's own catalog shapes
   (S = 4, 12, 13 × T = 2000), S ∈ {4, 16, 17, 64, 65, 128, 512} × T=2048 at the
   slice's widths and S=8192 × T=2048; one JSON line per shape with
   ``kernel_ms`` (CUDA events around back-to-back launches alone, queued
   behind a device sleep so host enqueue time is hidden), per tile shape,
   ``wrapper_ms`` (events around one ``allowed_via_kernel`` call, host
   checks and ctypes included), the plain version's time,
   ``library_ms`` (the same function as per-key fp16 ``torch.matmul``
   calls — a yardstick the port never calls), ``bound_ms`` (the least
   time at the published peaks) and ``alu_ceiling_ms`` (the CUDA cores'
   32-bit logic rate at the card's maximum SM clock), and for the main
   shapes the kernel's device time from torch.profiler
   (``profiled_kernel_ms``) and, at 8192 × 2048, the SM clock and power
   sampled under load; and the ptxas registers, shared memory and spills
   of each tile instantiation.
4. Slice: 50,000 pods × 2,000 instance types (bench config 3's mix and
   seed without its topology-spread share) through
   ``TorchScheduler(device="cuda").solve``: one cold solve, the median
   of three warm ones, the kernel's launch count over those four, the
   identical plan stream from ``device="cpu"``, and the plan invariants.
5. Cluster: the same 50,000 pods against a live cluster through
   ``solve(pods, state_nodes, daemonset_pods)``: 1,000 initialized
   existing nodes with about 10k bound pods, three daemonsets, and two
   NodePools, ``reserved`` (weight 10, limits cpu 1000 / memory 1000Gi)
   and ``default``. One cold and three warm solves on the card, the
   kernel's launches over those four, plans, existing plans and pod
   errors identical to the ``device="cpu"`` solve, the fit of every
   existing node, the limit, every pod accounted once, and the C++
   existing-node first-fit against its plain PyTorch version on the card
   on the solve's own inputs.
6. Config 3: bench config 3 whole (``config3_world``: the slice's pods
   with its zone spread on residues 5 and 6), one cold and three warm
   solves on the card, the kernel's launches, plans and errors identical
   to the ``device="cpu"`` solve, the plan invariants and
   ``check_spread`` (every zone that received a spread group's pods is
   within max_skew of the group's least-loaded supported zone).
7. Cluster spread: phase 6's pods plus 800 ``app=ha-web`` pods with a
   hostname spread (one replica per node) against phase 5's cluster,
   whose nodes and bound pods also sit in a ``KubeClient`` passed as
   ``kube_client`` (zone-1 workers labeled ``app=svc-5``, a bound
   ha-web pod on every 5th node): the same solves and comparisons,
   ``check_cluster``, ``check_spread`` against the seeds and
   ``check_hostname``.
8. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM published float32 rate outside the tensor cores: the yardstick
# of bound_ms, kept so rows stay comparable across revisions. The CUDA cores'
# 32-bit logic and compare rate is half of it (64 results per clock per
# SM, compute capability 9.0): alu_ceiling_ms uses that
FP32_OPS_PER_S = 67e12
N_SMS = 132
LOGIC_PER_CLOCK_PER_SM = 64
DEVICE_SLEEP_CYCLES = 20_000_000  # ~10 ms at 2 GHz: launches queue up behind it
N_PODS = 50_000
N_TYPES = 2_000
SEED = 11  # bench.py config 3's RandomState
N_NODES = 1_000  # existing nodes of the cluster phase
NODE_SEED = 12
N_HA = 800  # phase 7's HA front end: one replica per node
# the NodePool example of Karpenter's documentation (Concepts → NodePools)
RESERVED_LIMITS = {"cpu": "1000", "memory": "1000Gi"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 3 helpers -------------------------------------------------------------


def random_planes(rng, S, T, widths, Z=3, C=2):
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
    return dict(
        keys=keys, sig=sig, tm=tm, th=th, tn=tn,
        zone_ok=rng.rand(S, Z) > 0.3, ct_ok=rng.rand(S, C) > 0.3, avail=rng.rand(T, Z, C) > 0.5,
    )


def slice_planes(pools, provider, pods):
    """The compat inputs the slice's solve builds (one pool), from the
    port's own encode functions."""
    from karpenter_core_tpu_torch.solver import podcache
    from karpenter_core_tpu_torch.solver.encode import (
        encode_signature_for_pool,
        extend_encoded_masks,
        finalize_signature_masks,
        group_pods,
    )
    from karpenter_core_tpu_torch.solver.kernels import build_compat_inputs, zone_ct_masks
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    solver = TorchScheduler(pools, provider, device="cpu")
    groups = group_pods(pods, memos=podcache.get_memos(pods))
    enc_pools, catalogs = solver._build_pools()
    entry = solver._catalog_entry(catalogs[0])
    compats = [encode_signature_for_pool(g, enc_pools[0], entry.vocab) for g in groups]
    extend_encoded_masks(entry.enc, entry.vocab)
    finalize_signature_masks(compats, entry.vocab)
    enc = entry.enc
    zone_ok, ct_ok = zone_ct_masks(compats, enc)
    return dict(
        keys=tuple(sorted(enc.key_masks)),
        sig=build_compat_inputs(compats, enc, entry.vocab),
        tm=dict(enc.key_masks), th=dict(enc.key_has), tn=dict(enc.key_neg),
        zone_ok=zone_ok, ct_ok=ct_ok, avail=enc.offering_avail,
    )


def library_allowed(half, keys, offering: bool = True):
    """The same function as per-key fp16 torch.matmul calls (exact: 0/1
    products summed in fp32, tested > 0); without the offering leg it is
    compat ∧ valid. Timed as a yardstick only."""
    import torch

    valid = half["valid"]
    S, T = valid.shape[0], half["avail"].shape[0]
    ok = valid[:, None].expand(S, T).clone()
    for key in keys:
        overlap = torch.matmul(half[f"mask:{key}"], half[f"type:{key}"].T) > 0
        both_has = half[f"has:{key}"][:, None] & half[f"thas:{key}"][None, :]
        both_neg = half[f"neg:{key}"][:, None] & half[f"tneg:{key}"][None, :]
        ok &= ~both_has | overlap | both_neg
    return ok & (torch.matmul(half["pair"], half["avail"].T) > 0) if offering else ok


def raw_kernel_ms(catalog, planes, tile: int, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back launches of the wrapper's
    launch alone (no allocation, no plain version), queued behind a device
    sleep so the host's enqueue time is hidden → ms per launch."""
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    out = torch.empty((planes.shape[1], catalog.n_types), dtype=torch.uint8, device=planes.device)
    for _ in range(3):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(DEVICE_SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernel_ms(catalog, planes, tile: int, reps: int):
    """The kernel's device time per launch from torch.profiler over
    ``reps`` launches, or "not measured" where the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    out = torch.empty((planes.shape[1], catalog.n_types), dtype=torch.uint8, device=planes.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
        torch.cuda.synchronize()
    us, calls = 0.0, 0
    for evt in prof.key_averages():
        if "compat_allowed_" in evt.key and "_kernel" in evt.key:
            us += float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
            calls += int(evt.count)
    return us / 1000.0 / calls if us > 0.0 and calls else "not measured"


def sm_clock_under_load(catalog, planes, tile: int, launches: int) -> list:
    """``nvidia-smi`` SM clock and power samples while ``launches``
    queued launches keep the card busy."""
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    out = torch.empty((planes.shape[1], catalog.n_types), dtype=torch.uint8, device=planes.device)
    for _ in range(launches):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    samples = []
    for _ in range(3):
        time.sleep(0.05)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        samples.append(smi.stdout.strip())
    torch.cuda.synchronize()
    return samples


def kernel_case(
    label: str, planes: dict, reps: int, plain_reps: int, sm_mhz: float, device="cuda",
    profiled: bool = False, clock_launches: int = 0,
) -> dict:
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import kernels as pk

    dev = torch.device(device)
    keys, sig = planes["keys"], planes["sig"]
    tm, th, tn = planes["tm"], planes["th"], planes["tn"]
    zone_ok, ct_ok, avail = planes["zone_ok"], planes["ct_ok"], planes["avail"]
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, dev)
    side = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    W, S = side.shape
    T, K = catalog.n_types, len(catalog.layout.keys)

    got = ck.allowed_via_kernel(side, catalog)
    plain = ck.allowed_packed_reference(side, catalog.planes, catalog.layout)
    semantic = pk.allowed_reference(
        pk.to_tensors(sig, dev), pk.to_tensors(tm, dev), pk.to_tensors(th, dev),
        pk.to_tensors(tn, dev), torch.from_numpy(zone_ok).to(dev),
        torch.from_numpy(ct_ok).to(dev), torch.from_numpy(avail).to(dev), keys,
    )
    compat = ck.compat_via_kernel(sig, tm, th, tn, keys, dev)
    compat_plain = pk.compat_reference(
        pk.to_tensors(sig, dev), pk.to_tensors(tm, dev), pk.to_tensors(th, dev),
        pk.to_tensors(tn, dev), keys,
    )
    forced = {}
    for tile in (ck.TILE_SMALL, ck.TILE_LARGE):
        out = torch.full((S, T), 7, dtype=torch.uint8, device=dev)
        ck.COMPAT_ALLOWED.launch(side, catalog, out, tile=tile)
        forced[tile] = out
    half = {"valid": torch.from_numpy(sig["valid"]).to(dev), "avail": None}
    for key in keys:
        half[f"mask:{key}"] = torch.from_numpy(sig[f"mask:{key}"]).to(dev).half()
        half[f"type:{key}"] = torch.from_numpy(tm[key]).to(dev).half()
        half[f"has:{key}"] = torch.from_numpy(sig[f"has:{key}"]).to(dev)
        half[f"neg:{key}"] = torch.from_numpy(sig[f"neg:{key}"]).to(dev)
        half[f"thas:{key}"] = torch.from_numpy(th[key]).to(dev)
        half[f"tneg:{key}"] = torch.from_numpy(tn[key]).to(dev)
    half["pair"] = torch.from_numpy((zone_ok[:, :, None] & ct_ok[:, None, :]).reshape(S, -1)).to(dev).half()
    half["avail"] = torch.from_numpy(avail.reshape(T, -1)).to(dev).half()
    library = library_allowed(half, keys)

    err = 0
    for name, a, b in (
        ("kernel vs packed plain", got, plain),
        ("kernel vs plain allowed_reference", got, semantic),
        ("small tile vs packed plain", forced[ck.TILE_SMALL], plain),
        ("large tile vs packed plain", forced[ck.TILE_LARGE], plain),
        ("compat_via_kernel vs compat_reference", compat, compat_plain),
        ("library yardstick vs kernel", library, got),
    ):
        if a.shape != b.shape:
            fail(f"{label}: {name}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        diff = int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item()) if a.numel() else 0
        if diff:
            fail(f"{label}: {name} disagree (max abs err {diff})")
        err = max(err, diff)

    tile = ck.tile_for(S)
    tile_ms = {
        name: raw_kernel_ms(catalog, side, t, reps)
        for name, t in (("small", ck.TILE_SMALL), ("large", ck.TILE_LARGE))
    }
    wrapper_ms = median_ms(lambda: ck.allowed_via_kernel(side, catalog), reps)
    plain_ms = median_ms(
        lambda: ck.allowed_packed_reference(side, catalog.planes, catalog.layout), plain_reps
    )
    library_ms = median_ms(lambda: library_allowed(half, keys), plain_reps)
    # least time: each input read once, the output written once; the
    # operations are one AND and one OR per (s, t, word) at the published
    # float32 rate (the reckoning of the kernel's first revision, kept comparable)
    nbytes = (S + T) * W * 4 + (K + 1) * 4 + S * T
    ops = 2 * S * T * W
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    # the CUDA cores' own ceiling: one LOP3 per cell-word, one IMNMX per cell-key
    alu_ceiling_ms = S * T * (W + K) / (N_SMS * LOGIC_PER_CLOCK_PER_SM * sm_mhz * 1e6) * 1e3
    row = dict(
        shape=label, S=int(S), T=int(T), W=int(W), K=int(K),
        tile="small" if tile == ck.TILE_SMALL else "large",
        kernel_ms=tile_ms["small" if tile == ck.TILE_SMALL else "large"],
        kernel_ms_small_tile=tile_ms["small"], kernel_ms_large_tile=tile_ms["large"],
        wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        alu_ceiling_ms=alu_ceiling_ms,
        bytes=int(nbytes), ops=int(ops), max_abs_err=err,
    )
    if profiled:
        row["profiled_kernel_ms"] = profiled_kernel_ms(catalog, side, tile, reps)
        # the compat route (compat_via_kernel): the same kernel on an
        # all-ones offering chunk, against compat_reference and the
        # library yardstick without the offering leg
        ones_cat = ck.catalog_to_device(tm, th, tn, keys, np.ones((T, 1, 1), dtype=bool), dev)
        ones_side = ck.signature_side(
            sig, np.ones((S, 1), dtype=bool), np.ones((S, 1), dtype=bool), ones_cat
        )
        cW = ones_side.shape[0]
        t_sig, t_tm = pk.to_tensors(sig, dev), pk.to_tensors(tm, dev)
        t_th, t_tn = pk.to_tensors(th, dev), pk.to_tensors(tn, dev)
        c_bytes = (S + T) * cW * 4 + (K + 1) * 4 + S * T
        c_bytes_ms = c_bytes / HBM_BYTES_PER_S * 1e3
        c_ops_ms = 2 * S * T * cW / FP32_OPS_PER_S * 1e3
        row["compat_route"] = dict(
            W=int(cW),
            kernel_ms=raw_kernel_ms(ones_cat, ones_side, tile, reps),
            plain_ms=median_ms(lambda: pk.compat_reference(t_sig, t_tm, t_th, t_tn, keys), plain_reps),
            library_ms=median_ms(lambda: library_allowed(half, keys, offering=False), plain_reps),
            bound_ms=max(c_bytes_ms, c_ops_ms),
            bound_by="bytes" if c_bytes_ms >= c_ops_ms else "operations",
            alu_ceiling_ms=S * T * (cW + K) / (N_SMS * LOGIC_PER_CLOCK_PER_SM * sm_mhz * 1e6) * 1e3,
        )
    if clock_launches:
        row["sm_clock_under_load"] = sm_clock_under_load(catalog, side, tile, clock_launches)
    emit({"kernel_case": row})
    return row


def ptxas_usage(log: str) -> dict:
    """Registers, shared memory and spills per kernel from nvcc -Xptxas=-v."""
    usage, name = {}, None
    for line in log.splitlines():
        for tag in ("compat_allowed_small_kernel", "compat_allowed_large_kernel"):
            if tag in line:
                name = tag
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            usage.setdefault(name, {}).update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    return usage


# -- phase 4: the slice ----------------------------------------------------------


def slice_world(n_pods: int = N_PODS, n_types: int = N_TYPES, spread: bool = False):
    """bench.py config 3 (RandomState(11), 50k pods, instance_types(2000),
    NodePool "default"). Without ``spread`` (phases 4 and 5) it drops the
    topology-spread share: residues 5 and 6 become plain pods, so the
    count stays 50,000. With it (``config3_world``) residues 5 and 6
    carry config 3's zone spread: max_skew 1, DoNotSchedule, selector
    ``app=svc-{i % 9}``."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        LabelSelector,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
        Toleration,
        TopologySpreadConstraint,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(SEED)
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(n_pods):
        r = i % 9
        cpu = ["100m", "250m", "500m", "1", "1500m", "2"][rng.randint(6)]
        mem = ["128Mi", "256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(5)]
        pod = Pod()
        pod.metadata.name = f"bench-{i}"
        pod.metadata.labels = {"app": f"svc-{r}"}
        requests = {"cpu": parse_quantity(cpu), "memory": parse_quantity(mem)}
        pod.spec = PodSpec(
            containers=[Container(name="main", resources=ResourceRequirements(requests=requests))]
        )
        if r < 3:
            pod.spec.node_selector = {wk.CAPACITY_TYPE_LABEL_KEY: ["spot", "on-demand"][i % 2]}
        elif r < 5:
            pod.spec.tolerations = [Toleration(key="dedicated", operator="Exists")]
        elif r < 7 and spread:
            pod.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels={"app": f"svc-{r}"}),
                )
            ]
        pod.status.conditions = [
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        ]
        pods.append(pod)
    return [nodepool], provider, pods


def config3_world(n_pods: int = N_PODS, n_types: int = N_TYPES):
    """bench.py config 3 whole (``bench.py:469``): its 2/9 zone-spread
    share included, nothing reduced."""
    return slice_world(n_pods, n_types, spread=True)


def plan_stream(res) -> list:
    return [
        (p.nodepool_name, p.instance_type.name, p.zone, p.capacity_type, p.price, list(p.pod_indices))
        for p in res.node_plans
    ]


def check_invariants(res, pods) -> None:
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.scheduling import resources

    seen = set()
    for plan in res.node_plans:
        for i in plan.pod_indices:
            if i in seen:
                fail(f"pod {i} is planned twice")
            seen.add(i)
        if not resources.fits(plan.requests, plan.instance_type.allocatable()):
            fail(f"plan on {plan.instance_type.name} overflows its allocatable")
        offering = plan.instance_type.offerings.get(plan.capacity_type, plan.zone)
        if offering is None or not offering.available or offering.price != plan.price:
            fail(f"plan on {plan.instance_type.name} names no available offering at {plan.price}")
        for i in plan.pod_indices:
            want = pods[i].spec.node_selector.get(wk.CAPACITY_TYPE_LABEL_KEY)
            if want is not None and want != plan.capacity_type:
                fail(f"pod {i} selects {want} but lands on {plan.capacity_type}")
    errored = {i for i, p in enumerate(pods) if p.uid in res.pod_errors}
    if seen & errored or len(seen | errored) != len(pods):
        fail(f"{len(pods) - len(seen | errored)} pods neither planned nor errored")


def profile_solve(solver, pods, **solve_kw) -> dict:
    """One warm solve under torch.profiler: the device's busy time (sum
    of self device time over every event), the compat kernel's device
    time, and the idle share of the solve's wall time. Reports "not
    measured" where the profiler recorded no device time, and for the
    kernel's time where it recorded none of the launches the wrapper's
    counter saw in that solve (``kernel_launches_counted``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    counted_before = ck.COMPAT_ALLOWED.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(pods, **solve_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    busy_us = 0.0
    kernel_us = 0.0
    kernel_calls = 0
    for evt in prof.key_averages():
        dev_us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        busy_us += dev_us
        if "compat_allowed_" in evt.key and "_kernel" in evt.key:
            kernel_us += dev_us
            kernel_calls += int(evt.count)
    counted = ck.COMPAT_ALLOWED.launches - counted_before
    if busy_us <= 0.0:
        return {"profiled_wall_ms": wall_ms, "device_busy_ms": "not measured",
                "kernel_launches_counted": counted}
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1000.0,
        "device_idle_share": 1.0 - busy_us / 1000.0 / wall_ms,
        "kernel_device_ms_per_launch": kernel_us / 1000.0 / kernel_calls if kernel_calls else "not measured",
        "kernel_launches_profiled": kernel_calls,
        "kernel_launches_counted": counted,
    }


def solve_runs(solver, pods, **solve_kw):
    """One cold and three warm solves with the kernel's launches counted
    from 0 just before and read just after → (cold result, cold ms,
    [(warm ms, last_timings)], launches). Fails if a warm solve changes
    the plans."""
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    ck.COMPAT_ALLOWED.launches = 0
    t0 = time.perf_counter()
    cold = solver.solve(pods, **solve_kw)
    cold_ms = (time.perf_counter() - t0) * 1000.0
    warm_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        warm = solver.solve(pods, **solve_kw)
        warm_runs.append(((time.perf_counter() - t0) * 1000.0, dict(solver.last_timings)))
        if (plan_stream(warm), existing_stream(warm), warm.pod_errors) != (
            plan_stream(cold), existing_stream(cold), cold.pod_errors
        ):
            fail("a warm solve changed the plans")
    return cold, cold_ms, warm_runs, ck.COMPAT_ALLOWED.launches


def timing_row(cold, cold_ms, warm_runs, launches) -> dict:
    warm_ms = statistics.median(ms for ms, _ in warm_runs)
    return {
        "pods_per_s": cold.pods_scheduled / (warm_ms / 1000.0),
        "cold_ms": cold_ms,
        "warm_ms": warm_ms,
        "warm_runs_ms": [ms for ms, _ in warm_runs],
        "device_ms": statistics.median(t["device_ms"] for _, t in warm_runs),
        "host_ms": statistics.median(t["host_ms"] for _, t in warm_runs),
        "warm_phases_ms": {
            k: statistics.median(t[k] for _, t in warm_runs) for k in warm_runs[0][1] if k.endswith("_ms")
        },
        "pods_scheduled": cold.pods_scheduled,
        "pod_errors": len(cold.pod_errors),
        "pod_error_kinds": sorted({e.split(":")[0] for e in cold.pod_errors.values()}),
        "nodes": cold.node_count,
        "total_price": cold.total_price,
        "solves": 4,
        "kernel_launches": launches,
    }


def same_as_cpu(res, cpu, what: str) -> None:
    if plan_stream(cpu) != plan_stream(res):
        fail(f"{what}: the plans differ between cuda and cpu")
    if existing_stream(cpu) != existing_stream(res):
        fail(f"{what}: the existing plans differ between cuda and cpu")
    if cpu.pod_errors != res.pod_errors:
        fail(f"{what}: the pod errors differ between cuda and cpu")


# -- phase 5: the cluster --------------------------------------------------------


def cluster_world(n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES):
    """The slice's pods against a live cluster → (nodepools, provider,
    pods, state_nodes, daemonset_pods, missing): ``missing`` maps each
    node name to the requests of the daemons it should run but does not.

    - NodePools ``reserved`` (weight 10, RESERVED_LIMITS) and ``default``
      (weight 0, no limits).
    - ``n_nodes`` initialized nodes from RandomState(12): type
      ``fake-it-k`` with k uniform in 7..31 (8–32 vCPU), zones
      ``test-zone-1..3`` round-robin, capacity type alternating, every
      50th node in ``reserved`` (20 of 1,000), every 4th tainted
      ``dedicated=true:NoSchedule``; bound pods filling 40–80 % of the
      CPU allocatable, plus the daemon pods the node runs, with ``cni``
      missing on every 10th node.
    - Daemonsets ``cni`` (100m / 64Mi, tolerates everything), ``logs``
      (200m / 256Mi) and ``exporter`` (50m / 32Mi, on-demand nodes only).
    """
    return _cluster_world(n_pods, n_types, n_nodes)[:6]


def cluster_spread_world(
    n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_ha: int = N_HA
):
    """``cluster_world`` with bench config 3's pods whole, an HA front
    end rolling out, and the cluster in a kube store → (nodepools,
    provider, pods, state_nodes, daemonset_pods, missing, kube):

    - the pending pods are ``config3_world``'s, then ``n_ha`` pods
      ``app=ha-web`` (250m / 256Mi) with a self-selecting hostname spread
      (max_skew 1, DoNotSchedule): one replica per node;
    - the bound worker pods on ``test-zone-1`` nodes carry ``app=svc-5``,
      so svc-5's zone seeds are skewed;
    - every 5th node also runs one bound ``app=ha-web`` pod;
    - ``kube`` holds every node and every bound pod, daemons included.
    """
    return _cluster_world(n_pods, n_types, n_nodes, n_ha=n_ha)


def _cluster_world(n_pods: int, n_types: int, n_nodes: int, n_ha: Optional[int] = None):
    """The cluster of phases 5 and 7 (``n_ha`` None: phase 5's, no kube
    store); the random draws are the same either way."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        LabelSelector,
        Node,
        OwnerReference,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
        Taint,
        Toleration,
        TopologySpreadConstraint,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.scheduling import Taints, resources
    from karpenter_core_tpu_torch.state import StateNode

    spread = n_ha is not None
    pools, provider, pods = slice_world(n_pods, n_types, spread=spread)
    kube = KubeClient() if spread else None
    default = pools[0]
    default.spec.weight = 0
    reserved = NodePool()
    reserved.metadata.name = "reserved"
    reserved.spec.weight = 10
    reserved.spec.limits = {k: parse_quantity(v) for k, v in RESERVED_LIMITS.items()}

    def pod(name, cpu, mem, node_name="", daemonset=False, tolerations=(), selector=None, labels=None):
        p = Pod()
        p.metadata.name = name
        p.metadata.labels = dict(labels or {})
        if daemonset:
            p.metadata.owner_references = [OwnerReference(kind="DaemonSet", name=name)]
        p.spec = PodSpec(
            node_name=node_name,
            node_selector=dict(selector or {}),
            tolerations=list(tolerations),
            containers=[
                Container(
                    name="main",
                    resources=ResourceRequirements(
                        requests={"cpu": parse_quantity(cpu), "memory": parse_quantity(mem)}
                    ),
                )
            ],
        )
        p.status.phase = "Running" if node_name else "Pending"
        return p

    daemon_specs = (
        ("cni", "100m", "64Mi", (Toleration(operator="Exists"),), None),
        ("logs", "200m", "256Mi", (), None),
        ("exporter", "50m", "32Mi", (), {wk.CAPACITY_TYPE_LABEL_KEY: wk.CAPACITY_TYPE_ON_DEMAND}),
    )
    daemons = [
        pod(name, cpu, mem, daemonset=True, tolerations=tol, selector=sel)
        for name, cpu, mem, tol, sel in daemon_specs
    ]
    daemon_requests = {name: (cpu, mem) for name, cpu, mem, _, _ in daemon_specs}
    dedicated = Taint(key="dedicated", value="true", effect="NoSchedule")
    rng = np.random.RandomState(NODE_SEED)
    catalog = provider.instance_types
    cpus = ["250m", "500m", "1", "2"]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi"]
    nodes, missing = [], {}
    for m in range(n_nodes):
        it = catalog[int(rng.randint(7, 32))]
        name = f"node-{m:04d}"
        ct = (wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND)[m % 2]
        node = Node()
        node.metadata.name = name
        node.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: "reserved" if m % 50 == 0 else "default",
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.NODE_INITIALIZED_LABEL_KEY: "true",
            wk.LABEL_HOSTNAME: name,
            wk.LABEL_INSTANCE_TYPE: it.name,
            wk.LABEL_TOPOLOGY_ZONE: f"test-zone-{m % 3 + 1}",
            wk.CAPACITY_TYPE_LABEL_KEY: ct,
            wk.LABEL_ARCH: "amd64",
            wk.LABEL_OS: "linux",
        }
        node.spec.provider_id = f"fake:///{name}"
        node.spec.taints = [dedicated] if m % 4 == 0 else []
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = it.allocatable()
        sn = StateNode(node=node)
        bound = []
        worker_labels = (
            {"app": "svc-5"} if spread and node.metadata.labels[wk.LABEL_TOPOLOGY_ZONE] == "test-zone-1" else {}
        )
        target = node.status.allocatable["cpu"] * rng.uniform(0.4, 0.8)
        used, j = 0, 0
        while True:
            c, mem = cpus[rng.randint(len(cpus))], mems[rng.randint(len(mems))]
            if used + parse_quantity(c) > target:
                break
            bound.append(pod(f"{name}-w{j}", c, mem, node_name=name, labels=worker_labels))
            used += parse_quantity(c)
            j += 1
        if spread and m % 5 == 0:
            bound.append(pod(f"{name}-ha", "250m", "256Mi", node_name=name, labels={"app": "ha-web"}))
        runs = [
            d
            for d in daemons
            if Taints(node.spec.taints).tolerates(d) is None
            and all(node.metadata.labels.get(k) == v for k, v in d.spec.node_selector.items())
        ]
        absent = runs[:1] if m % 10 == 0 else []  # cni, which every node runs
        for d in runs[len(absent):]:
            cpu, mem = daemon_requests[d.name]
            bound.append(pod(f"{name}-{d.name}", cpu, mem, node_name=name, daemonset=True))
        for p in bound:
            sn.update_for_pod(p)
        if kube is not None:
            kube.create(node)
            for p in bound:
                kube.create(p)
        missing[name] = resources.requests_for_pods(*absent) if absent else {}
        nodes.append(sn)
    for k in range(n_ha or 0):
        p = pod(f"ha-web-{k}", "250m", "256Mi", labels={"app": "ha-web"})
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_HOSTNAME, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": "ha-web"}),
            )
        ]
        p.status.conditions = [
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        ]
        pods.append(p)
    return [reserved, default], provider, pods, nodes, daemons, missing, kube


def existing_stream(res) -> list:
    return [(e.state_node.name(), list(e.pod_indices)) for e in res.existing_plans]


def check_cluster(res, pods, nodes, daemons, missing) -> dict:
    """Fail unless the cluster solve's plans hold: every pod placed,
    planned or errored exactly once; each existing node's placements
    plus its bound pods and its missing daemons fit its allocatable;
    each new node's pods plus its daemons fit its type; ``reserved``
    stays within its limits and some pods spill to ``default``."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.scheduling import Taints, resources

    seen = {}
    for where, members in [(("new", i), p.pod_indices) for i, p in enumerate(res.node_plans)] + [
        (("existing", e.state_node.name()), e.pod_indices) for e in res.existing_plans
    ]:
        for i in members:
            if i in seen:
                fail(f"pod {i} is placed twice: {seen[i]} and {where}")
            seen[i] = where
    errored = {i for i, p in enumerate(pods) if p.uid in res.pod_errors}
    if set(seen) & errored or len(set(seen) | errored) != len(pods):
        fail(f"{len(pods) - len(set(seen) | errored)} pods neither placed, planned nor errored")
    for e in res.existing_plans:
        sn = e.state_node
        load = resources.merge(
            *(resources.requests_for_pods(pods[i]) for i in e.pod_indices), missing[sn.name()]
        )
        if not resources.fits(load, sn.available()):
            fail(f"existing node {sn.name()} is overcommitted by its placements")
        taints = Taints(sn.taints())
        if any(taints.tolerates(pods[i]) is not None for i in e.pod_indices):
            fail(f"a pod on {sn.name()} does not tolerate its taints")
    # no pool carries a taint or a capacity-type requirement: every new
    # node runs all three daemons
    overhead = resources.requests_for_pods(*daemons)
    for plan in res.node_plans:
        if not resources.fits(resources.merge(plan.requests, overhead), plan.instance_type.allocatable()):
            fail(f"plan on {plan.instance_type.name} overflows its allocatable with its daemons")
    used = resources.merge(
        *(sn.capacity() for sn in nodes if sn.labels().get(wk.NODEPOOL_LABEL_KEY) == "reserved"),
        *(p.instance_type.capacity for p in res.node_plans if p.nodepool_name == "reserved"),
    )
    for k, v in RESERVED_LIMITS.items():
        if used.get(k, 0) > parse_quantity(v):
            fail(f"reserved uses {used.get(k, 0)} {k}, over its limit {v}")
    per_pool = {}
    for p in res.node_plans:
        per_pool.setdefault(p.nodepool_name, [0, 0])
        per_pool[p.nodepool_name][0] += 1
        per_pool[p.nodepool_name][1] += len(p.pod_indices)
    if per_pool.get("default", [0, 0])[1] == 0:
        fail("no pod spilled to the default pool")
    return {
        "pods_on_existing": sum(len(e.pod_indices) for e in res.existing_plans),
        "existing_nodes_used": len(res.existing_plans),
        "new_nodes_by_pool": {k: v[0] for k, v in sorted(per_pool.items())},
        "new_node_pods_by_pool": {k: v[1] for k, v in sorted(per_pool.items())},
        "reserved_cpu_used": used.get("cpu", 0) / 1e9,
        "reserved_memory_gi_used": used.get("memory", 0) / 1e9 / 2**30,
    }


def pack_existing_check(inputs, device: str = "cuda") -> dict:
    """The C++ existing-node first-fit against its plain PyTorch version
    on ``device``, on the inputs a solve handed it."""
    import torch

    from karpenter_core_tpu_torch.solver import pack as pk

    reqs, sig_ids, compat, free = inputs
    t0 = time.perf_counter()
    assign, left = pk.run_pack_existing(reqs, sig_ids, compat, free)
    native_ms = (time.perf_counter() - t0) * 1000.0
    dev = torch.device(device)
    tensors = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (reqs, sig_ids, compat, free)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_assign, plain_left = pk.pack_existing_reference(*tensors)
    plain_assign, plain_left = plain_assign.cpu().numpy(), plain_left.cpu().numpy()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    err = max(
        int(np.abs(assign.astype(np.int64) - plain_assign).max()) if assign.size else 0,
        int(np.abs(left.astype(np.int64) - plain_left).max()) if left.size else 0,
    )
    if err:
        fail(f"pack_existing_native and pack_existing_reference disagree (max abs err {err})")
    return {
        "P": int(reqs.shape[0]), "M": int(free.shape[0]), "R": int(reqs.shape[1]),
        "S": int(compat.shape[0]), "assigned": int((assign >= 0).sum()),
        "native_ms": native_ms, "plain_ms_on_" + dev.type: plain_ms, "max_abs_err": err,
    }


def capture_pack_existing(fn):
    """Run ``fn()`` and return the inputs the solve handed to
    ``run_pack_existing`` (copies)."""
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    real = solver_mod.run_pack_existing
    seen = []

    def spy(reqs, sig_ids, compat, free):
        seen.append(tuple(np.array(x) for x in (reqs, sig_ids, compat, free)))
        return real(reqs, sig_ids, compat, free)

    solver_mod.run_pack_existing = spy
    try:
        out = fn()
    finally:
        solver_mod.run_pack_existing = real
    if len(seen) != 1:
        fail(f"the solve ran the existing-node pack {len(seen)} times, not once")
    return out, seen[0]


def run_cluster_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                      n_nodes: int = N_NODES) -> dict:
    """Phase 5 → its summary line (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing = cluster_world(n_pods, n_types, n_nodes)
    world_s = time.perf_counter() - t0
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
    if device == "cuda" and launches == 0:
        fail("the cluster solve never launched the compat kernel")
    cpu, inputs = capture_pack_existing(
        lambda: TorchScheduler(pools, provider, device="cpu").solve(pods, **kw)
    )
    same_as_cpu(cold, cpu, "cluster")
    summary = check_cluster(cold, pods, nodes, daemons, missing)
    packed = pack_existing_check(inputs, device)
    emit({"pack_existing": packed})
    profiled = profile_solve(solver, pods, **kw) if device == "cuda" else {}
    row = {
        "cluster": (
            f"{n_pods} pods x {n_types} types x {n_nodes} existing nodes, pools reserved "
            f"(limited) + default, daemonsets cni/logs/exporter"
        ),
        "world_build_s": world_s,
        "bound_pods": sum(len(sn.pod_requests) for sn in nodes),
        **timing_row(cold, cold_ms, warm_runs, launches),
        **summary,
        **profiled,
    }
    emit(row)
    return row


# -- phases 6 and 7: topology spread ---------------------------------------------


def check_spread(res, pods, nodes, provider, kube=None) -> list:
    """Fail unless every zone-spread group holds what the serial greedy
    guarantees: for each zone that received any of the group's pods, the
    final count of pods matching its selector (bound pods in ``kube``
    plus placements on existing and new nodes) minus the minimum over
    its supported zones is at most max_skew. A group is the pods sharing
    one (selector, namespace, max_skew); supported zones are those of
    the catalog's available offerings and of the existing nodes (the
    worlds here put no zone requirement or node filter on spread pods).
    → one summary per group."""
    from karpenter_core_tpu_torch.apis import labels as wk

    zone_key = wk.LABEL_TOPOLOGY_ZONE
    where = {}
    for plan in res.node_plans:
        for i in plan.pod_indices:
            where[i] = plan.zone
    for e in res.existing_plans:
        for i in e.pod_indices:
            where[i] = e.state_node.labels().get(zone_key)
    supported = {o.zone for it in provider.instance_types for o in it.offerings if o.available}
    supported |= {sn.labels()[zone_key] for sn in nodes if zone_key in sn.labels()}
    bound = []
    if kube is not None:
        node_zone = {n.name: n.metadata.labels.get(zone_key) for n in kube.list("Node")}
        bound = [
            (p, node_zone.get(p.spec.node_name))
            for p in kube.list("Pod")
            if p.spec.node_name
            and p.status.phase not in ("Succeeded", "Failed")
            and p.metadata.deletion_timestamp is None
        ]
    groups = {}
    for i, p in enumerate(pods):
        for c in p.spec.topology_spread_constraints:
            if c.topology_key == zone_key:
                key = (c.label_selector.key(), p.namespace, c.max_skew)
                groups.setdefault(key, (c.label_selector, []))[1].append(i)
    out = []
    for (_, ns, skew), (sel, members) in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        final = dict.fromkeys(supported, 0)
        for p, z in bound:
            if z is not None and p.namespace == ns and sel.matches(p.metadata.labels):
                final[z] = final.get(z, 0) + 1
        for i, z in where.items():
            if z is not None and pods[i].namespace == ns and sel.matches(pods[i].metadata.labels):
                final[z] = final.get(z, 0) + 1
        lo = min(final[z] for z in supported)
        received = sorted({where[i] for i in members if i in where})
        worst = max((final[z] - lo for z in received), default=0)
        if worst > skew:
            fail(
                f"spread {sel.match_labels} breaks max_skew {skew}: final counts "
                f"{dict(sorted(final.items()))}, pods landed in {received}"
            )
        placed = {}
        for i in members:
            if i in where:
                placed[where[i]] = placed.get(where[i], 0) + 1
        out.append({
            "selector": dict(sel.match_labels), "max_skew": skew, "pods": len(members),
            "placed_by_zone": dict(sorted(placed.items())),
            "final_by_zone": dict(sorted(final.items())), "worst_skew": worst,
        })
    if not out:
        fail("the world has no zone-spread group")
    return out


def check_hostname(res, pods, kube, app: str = "ha-web") -> dict:
    """Fail unless every node that received a pod ``app=<app>`` (existing
    or new) holds at most max_skew of them, bound pods in ``kube``
    included: one replica per node at max_skew 1."""
    from karpenter_core_tpu_torch.apis import labels as wk

    members = [i for i, p in enumerate(pods) if p.metadata.labels.get("app") == app]
    if not members:
        fail(f"the world has no {app} pod")
    (cap,) = {
        c.max_skew
        for i in members
        for c in pods[i].spec.topology_spread_constraints
        if c.topology_key == wk.LABEL_HOSTNAME
    }
    bound = {}
    for p in kube.list("Pod"):
        if p.spec.node_name and p.metadata.labels.get("app") == app:
            bound[p.spec.node_name] = bound.get(p.spec.node_name, 0) + 1
    on_existing = on_new = 0
    for e in res.existing_plans:
        n = sum(1 for i in e.pod_indices if pods[i].metadata.labels.get("app") == app)
        on_existing += n
        if n and n + bound.get(e.state_node.name(), 0) > cap:
            fail(f"existing node {e.state_node.name()} holds {n} + {bound.get(e.state_node.name(), 0)} {app} pods")
    for plan in res.node_plans:
        n = sum(1 for i in plan.pod_indices if pods[i].metadata.labels.get("app") == app)
        on_new += n
        if n > cap:
            fail(f"a new {plan.instance_type.name} node holds {n} {app} pods")
    return {
        "hostname_spread": app, "max_skew": cap, "pods": len(members),
        "on_existing": on_existing, "on_new": on_new,
        "errors": sum(1 for i in members if pods[i].uid in res.pod_errors),
        "bound_seeds": sum(bound.values()),
    }


def run_config3_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES) -> dict:
    """Phase 6: bench config 3 whole, spread share included → its line
    (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    pools, provider, pods = config3_world(n_pods, n_types)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods)
    if device == "cuda" and launches < 4:
        fail(f"config 3 launched the compat kernel {launches} times in 4 solves")
    same_as_cpu(cold, TorchScheduler(pools, provider, device="cpu").solve(pods), "config 3")
    check_invariants(cold, pods)
    spread = check_spread(cold, pods, [], provider)
    row = {
        "config3": f"{n_pods} pods x {n_types} types (bench config 3, zone spread on 2/9)",
        **timing_row(cold, cold_ms, warm_runs, launches),
        "spread": spread,
        **(profile_solve(solver, pods) if device == "cuda" else {}),
    }
    emit(row)
    return row


def run_cluster_spread_phase(
    device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES,
    n_ha: int = N_HA,
) -> dict:
    """Phase 7: config 3 and an HA front end against the live cluster,
    seeded from its kube store → its line (also emitted); fails on any
    check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing, kube = cluster_spread_world(
        n_pods, n_types, n_nodes, n_ha
    )
    world_s = time.perf_counter() - t0
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
    if device == "cuda" and launches < 4:
        fail(f"the cluster spread solve launched the compat kernel {launches} times in 4 solves")
    cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
    same_as_cpu(cold, cpu, "cluster spread")
    summary = check_cluster(cold, pods, nodes, daemons, missing)
    spread = check_spread(cold, pods, nodes, provider, kube)
    ha = check_hostname(cold, pods, kube)
    row = {
        "cluster_spread": (
            f"{len(pods)} pods ({n_pods} config 3 + {n_ha} ha-web) x {n_types} types x "
            f"{n_nodes} existing nodes, kube store seeds"
        ),
        "world_build_s": world_s,
        "bound_pods": len(kube.list("Pod")),
        **timing_row(cold, cold_ms, warm_runs, launches),
        **summary,
        "spread": spread,
        "hostname": ha,
        **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
    }
    emit(row)
    return row


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        from karpenter_core_tpu_torch import native
        from karpenter_core_tpu_torch.solver import compat_kernels as ck
        from karpenter_core_tpu_torch.solver.solver import TorchScheduler
    except ImportError as e:
        fail(f"run from the repository root: the port does not import ({e})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        sm_mhz = float(clock.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no maximum SM clock: {clock.stdout!r} {clock.stderr!r}")
    kind = torch.cuda.get_device_name(0)
    emit({"device": kind, "nvidia_smi": card, "max_sm_mhz": sm_mhz, "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build, one compiler per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kernel_build = pool.submit(ck.COMPAT_ALLOWED.build)
        packer_build = pool.submit(native.build)
        (kernel_lib, kernel_log), (packer_lib, _) = kernel_build.result(), packer_build.result()
    build_s = time.perf_counter() - t0
    emit({"build_s": build_s, "kernel_lib": kernel_lib, "packer_lib": packer_lib})
    for line in kernel_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    usage = ptxas_usage(kernel_log)
    emit({"ptxas": usage})
    if len(usage) != 2:
        fail(f"ptxas reported {sorted(usage)}, not both tile instantiations")

    # 3. kernel vs plain versions on the card
    rng = np.random.RandomState(0)
    ragged = (1, 31, 32, 33, 200, 300)
    for n_keys in range(1, len(ragged) + 1):
        for S, T in ((1, 1), (1, 37), (29, 1)):
            kernel_case(
                f"ragged keys={n_keys} S={S} T={T}",
                random_planes(rng, S, T, ragged[:n_keys]), reps=20, plain_reps=5, sm_mhz=sm_mhz,
            )
    pools, provider, pods = slice_world()
    sp = slice_planes(pools, provider, pods)
    slice_row = kernel_case(
        "slice 50k x 2000", sp, reps=200, plain_reps=20, sm_mhz=sm_mhz, profiled=True
    )
    # the compat shapes of phases 6 and 7 (S = 12 and 13 signatures), from
    # their own worlds, built afresh so those phases' pods meet the solver
    # unmemoized
    spread_rows = [
        kernel_case(
            "config3 50k x 2000", slice_planes(*config3_world()), reps=200, plain_reps=20,
            sm_mhz=sm_mhz, profiled=True,
        ),
        kernel_case(
            "cluster-spread 50.8k x 2000", slice_planes(*cluster_spread_world()[:3]), reps=200,
            plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ),
    ]
    widths = [sp["tm"][k].shape[1] for k in sp["keys"]]
    for S in (4, 16, 17, 64, 65, 128, 512):
        kernel_case(
            f"S={S} x T=2048", random_planes(np.random.RandomState(2 + S), S, 2048, widths),
            reps=100, plain_reps=10, sm_mhz=sm_mhz, profiled=True,
        )
    big_row = kernel_case(
        "S=8192 x T=2048",
        random_planes(np.random.RandomState(1), 8192, 2048, widths), reps=20, plain_reps=5,
        sm_mhz=sm_mhz, profiled=True, clock_launches=2000,
    )

    # 4. the slice on the card: counts from 0 just before the main path
    solver = TorchScheduler(pools, provider, device="cuda")
    cold, cold_ms, warm_runs, slice_launches = solve_runs(solver, pods)
    if slice_launches == 0:
        fail("the solve never launched the compat kernel")
    same_as_cpu(cold, TorchScheduler(pools, provider, device="cpu").solve(pods), "slice")
    check_invariants(cold, pods)
    emit(
        {
            "slice": f"{N_PODS} pods x {N_TYPES} types (bench config 3 mix without spread)",
            **timing_row(cold, cold_ms, warm_runs, slice_launches),
            **profile_solve(solver, pods),
        }
    )

    # 5. the cluster: existing nodes, daemonset overhead, NodePool limits
    cluster = run_cluster_phase("cuda")

    # 6. bench config 3 whole; 7. with the cluster, its kube store and an
    # HA front end
    config3 = run_config3_phase("cuda")
    cluster_spread = run_cluster_spread_phase("cuda")

    # 8. the kernels line, then the last line
    emit(
        {
            "kernels": [
                {
                    "name": "compat_allowed",
                    "route": "cuda",
                    "source": "karpenter_core_tpu_torch/csrc/compat_allowed.cu",
                    "replaces": "karpenter_core_tpu/solver/pallas_kernels.py:118",
                    "launches": slice_launches + cluster["kernel_launches"]
                    + config3["kernel_launches"] + cluster_spread["kernel_launches"],
                    "launches_by_path": {
                        "slice": slice_launches, "cluster": cluster["kernel_launches"],
                        "config3": config3["kernel_launches"],
                        "cluster-spread": cluster_spread["kernel_launches"],
                    },
                    "max_abs_err": max(
                        row["max_abs_err"] for row in [slice_row, big_row, *spread_rows]
                    ),
                    "ms": slice_row["kernel_ms"],
                    "kernel_ms": slice_row["kernel_ms"],
                    "profiled_kernel_ms": slice_row["profiled_kernel_ms"],
                    "wrapper_ms": slice_row["wrapper_ms"],
                    "plain_ms": slice_row["plain_ms"],
                    "bound_ms": slice_row["bound_ms"],
                    "bound_by": slice_row["bound_by"],
                    "alu_ceiling_ms": slice_row["alu_ceiling_ms"],
                    "library_ms": slice_row["library_ms"],
                    "at_8192x2048": {
                        k: big_row[k]
                        for k in (
                            "kernel_ms", "profiled_kernel_ms", "wrapper_ms", "plain_ms",
                            "library_ms", "bound_ms", "bound_by", "alu_ceiling_ms",
                        )
                    },
                    "at_spread_paths": [
                        {
                            k: row[k]
                            for k in (
                                "shape", "S", "T", "W", "kernel_ms", "profiled_kernel_ms",
                                "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                "max_abs_err",
                            )
                        }
                        for row in spread_rows
                    ],
                    "compat_route": slice_row["compat_route"],
                    "ptxas": usage,
                }
            ]
        }
    )
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
