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
   slice's own catalog shapes, S ∈ {4, 16, 17, 64, 65, 128, 512} × T=2048 at the
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
5. A ``{"kernels": [...]}`` line, then the last line
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


def slice_world():
    """bench.py config 3 (RandomState(11), 50k pods, instance_types(2000),
    NodePool "default") without its topology-spread share: residues 5
    and 6 become plain pods, so the count stays 50,000."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
        Toleration,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(SEED)
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(N_TYPES)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(N_PODS):
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
        pod.status.conditions = [
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        ]
        pods.append(pod)
    return [nodepool], provider, pods


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


def profile_solve(solver, pods) -> dict:
    """One warm solve under torch.profiler: the device's busy time (sum
    of self device time over every event), the compat kernel's device
    time, and the idle share of the solve's wall time. Reports "not
    measured" where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(pods)
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
    if busy_us <= 0.0:
        return {"profiled_wall_ms": wall_ms, "device_busy_ms": "not measured"}
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1000.0,
        "device_idle_share": 1.0 - busy_us / 1000.0 / wall_ms,
        "kernel_device_ms_per_launch": kernel_us / 1000.0 / max(kernel_calls, 1),
        "kernel_launches_profiled": kernel_calls,
    }


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
    ck.COMPAT_ALLOWED.launches = 0
    t0 = time.perf_counter()
    cold = solver.solve(pods)
    cold_ms = (time.perf_counter() - t0) * 1000.0
    warm_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        warm = solver.solve(pods)
        warm_runs.append(((time.perf_counter() - t0) * 1000.0, dict(solver.last_timings)))
    launches = ck.COMPAT_ALLOWED.launches
    if launches == 0:
        fail("the solve never launched the compat kernel")
    warm_ms = statistics.median(ms for ms, _ in warm_runs)
    device_ms = statistics.median(t["device_ms"] for _, t in warm_runs)
    if plan_stream(warm) != plan_stream(cold):
        fail("warm solve changed the plans")
    cpu = TorchScheduler(pools, provider, device="cpu").solve(pods)
    if plan_stream(cpu) != plan_stream(cold) or cpu.pod_errors != cold.pod_errors:
        fail("the cuda solve's plans differ from the cpu solve's")
    check_invariants(cold, pods)
    profiled = profile_solve(solver, pods)
    emit(
        {
            "slice": f"{N_PODS} pods x {N_TYPES} types (bench config 3 mix without spread)",
            "pods_per_s": cold.pods_scheduled / (warm_ms / 1000.0),
            "cold_ms": cold_ms,
            "warm_ms": warm_ms,
            "warm_runs_ms": [ms for ms, _ in warm_runs],
            "device_ms": device_ms,
            "host_ms": statistics.median(t["host_ms"] for _, t in warm_runs),
            "pods_scheduled": cold.pods_scheduled,
            "pod_errors": len(cold.pod_errors),
            "nodes": cold.node_count,
            "total_price": cold.total_price,
            "solves": 4,
            "kernel_launches": launches,
            "warm_phases_ms": {
                k: statistics.median(t[k] for _, t in warm_runs)
                for k in warm_runs[0][1]
                if k.endswith("_ms")
            },
            **profiled,
        }
    )

    # 5. the kernels line, then the last line
    emit(
        {
            "kernels": [
                {
                    "name": "compat_allowed",
                    "route": "cuda",
                    "source": "karpenter_core_tpu_torch/csrc/compat_allowed.cu",
                    "replaces": "karpenter_core_tpu/solver/pallas_kernels.py:118",
                    "launches": launches,
                    "max_abs_err": max(slice_row["max_abs_err"], big_row["max_abs_err"]),
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
                    "compat_route": slice_row["compat_route"],
                    "ptxas": usage,
                }
            ]
        }
    )
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
