#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``karpenter_core_tpu_torch``) on one
NVIDIA card and check it.

Phases, in order; any failure exits non-zero:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the Hopper compat∧offering kernel, the three pack
   kernels, the disruption screens (nvcc) and the C++ packer (g++) from
   the repo's sources, one compiler each, in parallel.
3. Kernel: the kernel, through the wrapper's own tile pick and with
   each of its two tile shapes forced, against its plain PyTorch
   versions on the card, bit for bit, on seeded ragged planes, the
   slice's, config 3's, the cluster-spread, config 6 and both
   anti-affinity phases' own catalog shapes (T = 2000; config 6 T = 400,
   anti-dense T = 200), bench config 7's (T = 500) whole and for four of
   its teams alone (the shape of a warm tick's missing signatures),
   S ∈ {4, 16, 17, 64, 65, 128, 512} × T=2048 at the
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
8. Config 6: bench config 6 whole (``config6_world``: karpenter-core's
   diverse mix, 7,000 pods × 400 types, two sevenths of them with pod
   affinity on hostname or zone, resolved by the post-pass): the same
   solves and comparisons, ``check_invariants``, ``check_affinity``
   (every placed affinity pod shares its zone or node with a pod each
   term matches) and ``check_spread_serial``.
9. Anti-affinity: config 13's ``anti_dense`` (10,000 pods with one- and
   three-term anti-affinity against eight bound ``ext-*`` anchors) and a
   six-pod zone quorum, first as the bench builds it (``anti_dense_world``:
   200 types, no existing nodes, so the zone exclusion narrows each
   group's pool rows and the quorum takes unmerged one-pod nodes), then
   against phase 5's cluster in a kube store with the anchors on
   existing nodes (``anti_cluster_world``): the same solves and
   comparisons, ``check_invariants`` (``check_cluster`` on the
   cluster), and ``check_anti`` (no anti pod shares an excluded zone or node with
   a matching pod, one quorum member per zone).

10. Stateful: config 13's ``stateful_dense`` (10,000 pods: ephemeral
   volumes, host ports 8000–8011, plain; 16 existing nodes with CSI
   attach limit 8, built in the solver's units) and ``spread_skew`` as
   the bench builds them, then ``stateful_cluster_world``: phase 5's
   cluster with CSI limits, mounted claims and node-exporter's
   hostPort 9100, a ``db`` pool, the ``stateful_dense`` pods, 100
   hostPort-9100 agents and three 50-replica StatefulSets whose claims
   pin zones: the same solves and comparisons (the CPU solve on its
   own copy of the pods), ``check_cluster`` where there are nodes,
   ``check_ports``, ``check_volumes``, ``check_zone_pins`` (``check_spread``
   for ``spread_skew``), and the C++ first-fit against its plain version
   on the card on every stateful first-fit's inputs.

11. Oracle and relaxation: bench config 1 (1,000 uniform pods × 10
   types) through the port's greedy scheduler (``build_scheduler(...)
   .solve``) as the bench runs it, host only; ``oracle_mix_world``
   (config 6 whole plus 342 pods of Helm releases with Bitnami's soft
   pod anti-affinity, ten one-selector releases and two postgresql
   releases whose selector matches their primary and read replicas),
   which the solve's routing sends to the greedy fallback, as built and
   against phase 5's cluster in a kube store (``oracle_cluster_world``);
   ``relax_cluster_world`` (phase 5's world with every ``test-zone-3``
   offering unavailable, every 5th pod preferring that zone and every
   20th with a two-term required zone affinity whose first term no
   offering meets), which the preference-relaxation retry solves; and
   ``packing_parity_vs_oracle`` (``bench.py:214-243``) of the solve on
   the card against the port's greedy scheduler on config 6's
   1,500-pod stratified subsample and on config 1. Each path: the same
   solves and cuda-vs-cpu comparisons (the greedy fallback's claims
   included), ``check_oracle`` (exactly the release pods routed off,
   one replica per node wherever the soft preference held, every claim
   fits its cheapest option), ``check_affinity`` and
   ``check_spread_serial`` for config 6's part, ``check_cluster`` on the
   clusters, no new node in the drought zone, and a relaxation that
   placed pods.

12. Pack engines: with ``KARPENTER_TORCH_NATIVE=0`` (the device engine)
   bench config 3 whole and phase 5's cluster, one cold and three warm
   solves on the card with the launches of the FFD scan kernel
   (``csrc/ffd_pack.cu``) and the existing-node first-fit kernel
   (``csrc/pack_existing.cu``) counted, plans, existing plans and errors
   equal to the ``device="cpu"`` solve through their plain versions, and
   the idle share; the LP backend (``KARPENTER_TORCH_PACK_BACKEND=lp``)
   on bench config 10 whole: each of its eleven shapes under ffd and lp
   on the card, plans equal to the CPU's, each shape's $/hr equal to the
   JAX package's (``CONFIG10_REFERENCE``), lp <= ffd, bound <= cost, the
   same pods, the 41.2 % adversarial saving and a dual-ascent launch
   (``csrc/dual_ascent.cu``) in every lp solve; config 10 again under lp
   with the native packer off (repair packs through the scan kernel);
   bench config 5 whole (10,000 pods x 2,000 types x 6 zones) under ffd,
   lp and auto (threshold pinned): 164 nodes at $873.4703/hr each, the
   cost guard keeping FFD, the calibrated threshold on its own line.
   Then every distinct captured call of each pack kernel against its
   plain version on the card, bit for bit, with ``kernel_ms`` (events
   around queued launches), the plain version's time and ``bound_ms``;
   for the two scans also ``step_us``, the time of one pod step (over
   the longest job's pods for B5, over all pods for B6), for B7
   ``iter_us`` (over its iterations) and its plan (threads, replicas,
   layout);
   synthetic calls at shapes no path gives (``synthetic_scan_calls``,
   ``synthetic_dual_calls``: B5 at widths 12 and 700, B6 wide and past
   4,096 nodes, B7 at 4,096 types and with its work area in device
   memory); and ``lp.relax`` split into its uploads, kernel, downloads
   and host bound on a captured config 5 and config 10 call
   (``relax_split``).

13. Provisioner: the port's ``Provisioner.reconcile`` over a live
   in-memory store (``KubeClient`` + ``Informers`` into a ``Cluster`` +
   ``Recorder`` + ``Metrics``, every clock fixed), on the batched path
   (``use_tpu_solver``) on the card, each kernel's launches counted from
   0 just before the reconcile and read just after. 13a
   ``config2-provisioner``: bench config 2 whole (10,000 pods, 480 + 20
   GPU types) as pending pods: one reconcile, three ``schedule()``
   calls, plans equal to a direct ``TorchScheduler.solve``, one claim
   per plan, a Nominated event per placed pod, ``nodeclaims_created``
   and ``solver_duration`` counted, the trace ``provisioner.reconcile``
   → ``snapshot_nodes``, ``pending_pods``, ``solve``,
   ``create_node_claims``; the same claims from a CPU reconcile in a
   fresh store; then one parity shadow and its ``solver_parity`` gauge.
   13b ``cluster-provisioner``: phase 5's world as store objects (1,000
   nodes with their NodeClaims, the bound pods, three DaemonSets, two
   pools) and its 50,000 pending pods, reconciled with the C++ packer
   and with ``KARPENTER_TORCH_NATIVE=0`` (the scan kernels), and with the
   C++ packer on the CPU: plans equal to the direct solve of phase 5's
   inputs under the same packer (the device engine's direct solve is
   phase 12's cluster-device path, held there to the CPU's plain
   scans), existing placements nominated with no claim,
   ``check_cluster``; a captured compat call and the device run's
   existing-node first-fit held against their plain versions. 13c
   ``anti-cluster-oracle``: phase 9's cluster cut to 200 nodes and 3,000
   anti pods, three bound guards with required anti-affinity, and phase
   11's Helm release pods (the greedy fallback, whose topology walks the
   guards): ``check_inverse`` (no greedy placement in a domain a guard
   excludes; the tensor path's counted, as the JAX package's), the
   claims and the fallback's equal to a CPU reconcile's.

14. Config 7 ticks: bench config 7 (``bench.py:763-960``) on the card
   (``run_config7_phase``): 10,000 pods of RandomState(23), 480 + 20 GPU
   types, 40 teams, 30 ticks at 5 % churn on four teams, every tenth a
   1 % price rise on every 16th type, a catalog generation bump and a
   pool weight change. Each tick a restart-shaped cold leg (fresh pods,
   catalog, pool and TorchScheduler, ``KARPENTER_TORCH_INCREMENTAL=0``)
   and a warm leg on one long-lived ``TorchScheduler(device="cuda")``:
   plans identical every tick, the warm leg's compat launches at most
   the cold leg's; a no-op tick that replays with no compat and no FFD
   launch; ten more ticks with ``KARPENTER_TORCH_NATIVE=0``, whose FFD
   scan launches are one per (size class, width) class of the jobs the
   job memo missed, plans equal to a cold solve of the tick's pods on the
   same engine and, on its last tick, to a cold CPU solve through the
   plain scans; a restart (``snapshot``, ``simulate_process_death``,
   ``restore`` into a fresh card scheduler) whose first solve of the last
   tick's pods is plan-identical to the un-killed scheduler's with no
   compat launch; and the last tick's plan equal to a cold CPU solve's.
   Every compat and FFD call of the phase's solves is captured, and each
   distinct shape is held against its plain version on the card, bit for
   bit; ``sections_s`` splits the phase's wall time. Phases 4-13 run
   with ``KARPENTER_TORCH_INCREMENTAL=0``: they measure the cold
   pipeline, as before the warm state existed.
15. Disruption (``run_disruption_phase``), the warm state on, every
   world built twice (card and CPU) with the same generated identities.
   15a ``config4-consolidation``: bench config 4 whole
   (``bench.py:552-602``): 5,000 initialized ``fake-it-4`` nodes with one
   100m / 128Mi pod each, an hour on, ``get_candidates`` then
   ``MultiNodeConsolidation.compute_command`` (the batched engine: the
   prefix and subset screens, the repack bound, greedy simulations);
   again with ``KARPENTER_TORCH_NATIVE=0`` (the repack bound on B6); both
   commands and engine stats equal to a CPU run's. 15b
   ``config9-disruption``: bench config 9 (``bench.py:1150-1460``): 500
   ``dx-host`` nodes carrying ``scenario_spot_storm(50,000, 20 teams,
   seed 9)``'s base step (49,973 pods bind), a 5 % budget, the batched
   solver's simulations; phase A's decision and five steady ones, phase
   B's churn steps (the storm recovering at 70 %, a price storm), the
   single-node decision, each batched and sequential with equal command
   keys, all equal to a CPU run's; the churn steps again with
   ``KARPENTER_TORCH_NATIVE=0`` (B6 and the FFD scan), the same commands.
   15c ``controller-e2e``: a 40-node store world with drift, expiration,
   emptiness and an underutilized pool: the markers, ``reconcile`` until
   nothing is left, the orchestration queue; conditions, taints, claims,
   deletion marks, events and disruption metrics equal to a CPU run's.
   15d: every distinct captured screen call, and the synthetic shapes
   past them (``synthetic_screen_calls``: the subset family at its cap of
   8,193 rows and at 8 columns, the prefix at 1,000 × 8 and 4,097 × 3,
   sums past 2^24), against its plain version on the card, bit for bit,
   with its time, the reference formula's as one PyTorch expression
   (``library_ms``), the bound, the chain (``chain_ms``: the dependent
   adds at FADD_CYCLES cycles each at the maximum SM clock) and the
   largest partial sum. ``sections_s`` splits the phase's wall time.

Then a ``{"kernels": [...]}`` line (the compat kernel's cases at the
shapes of phases 8–11 too, the three pack kernels and the disruption
screens; launches by path, phase 13's, 14's and 15's legs included),
and the last line ``{"ok": true, "device": {...}}``.
The profiled warm solves of phases 4–11 report device times only from
traces that hold every kernel launch of the solve (``profile_solve``).

Run from the repository root: ``python3 chip_smoke.py`` (``--log PATH``
appends every JSON line to PATH as well).
"""

from __future__ import annotations

import copy
import gc
import hashlib
import json
import os
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
# cycles of one dependent float32 add on the CUDA cores: the assumption of
# the B8 screens' chain_ms (a fixed-order sum is that many cycles a step)
FADD_CYCLES = 4
N_PODS = 50_000
N_TYPES = 2_000
SEED = 11  # bench.py config 3's RandomState
N_NODES = 1_000  # existing nodes of the cluster phase
NODE_SEED = 12
N_HA = 800  # phase 7's HA front end: one replica per node
# the NodePool example of Karpenter's documentation (Concepts → NodePools)
RESERVED_LIMITS = {"cpu": "1000", "memory": "1000Gi"}
N_CONFIG6 = 7_000  # bench.py config 6: pods, instance types, RandomState
N_CONFIG6_TYPES = 400
CONFIG6_SEED = 17
N_ANTI = 10_000  # bench.py config 13 anti_dense: pods, RandomState
ANTI_SEED = 13
N_ANTI_TYPES = 200  # the catalog config 13 builds
N_QUORUM = 6  # phase 9's zone quorum: three place, one per zone
N_STATEFUL = 10_000  # bench.py config 13 stateful_dense and spread_skew: pods
CSI_DRIVER = "ebs.csi.bench"  # the CSI driver of config 13's default StorageClass
N_REPLICAS = 50  # phase 10's stateful cluster: replicas of each of three StatefulSets
N_CONFIG1 = 1_000  # bench.py config 1: uniform pods
N_RELEASES = 10  # phase 11's Helm releases with the soft anti-affinity preset, and their
N_RELEASE_REPLICAS = 30  # replicas; requests drawn per release from RandomState(21)
RELEASE_SEED = 21
RELEASE_CHARTS = (
    "redis", "memcached", "rabbitmq", "kafka", "mongodb", "nginx", "keycloak", "elasticsearch",
    "mariadb", "minio",
)
DROUGHT_ZONE = "test-zone-3"  # phase 11's relax-cluster: every offering there unavailable
N_PARITY = 1_500  # bench.py config 6's stratified subsample for packing parity


# ``--log PATH``: every emitted line is appended there too (the output a
# caller keeps may hold only its end)
LOG_PATH: Optional[str] = None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(json.dumps({"fail": msg}) + "\n")
    sys.exit(1)


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(line + "\n")


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


def slice_planes(pools, provider, pods, kube=None):
    """The compat inputs the slice's solve builds (the first pool), from
    the port's own encode functions; with ``kube``, after the solve's
    PVC zone pins join the pods."""
    from karpenter_core_tpu_torch.solver import podcache
    from karpenter_core_tpu_torch.solver.encode import (
        encode_signature_for_pool,
        extend_encoded_masks,
        finalize_signature_masks,
        group_pods,
    )
    from karpenter_core_tpu_torch.solver.kernels import build_compat_inputs, zone_ct_masks
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
    if kube is not None:
        solver._inject_volume_zones(pods)
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


def profiler_probe(catalog, planes, sessions: int = 4) -> dict:
    """What torch.profiler records of the wrapper's launches, against
    what the launch counter saw, in the ways a profiled solve can meet
    them: ``n`` back-to-back ``allowed_via_kernel`` launches with their
    host copies, in fresh sessions (``plain``), each after a short
    session of its own (``after_session``), with a synchronize between
    launches (``sync_between``), with ``acc_events`` (``acc_events``), a
    torch kernel beside them (``torch_op``: its ``add`` events), 100 ms
    of host work before each launch (``host_busy``), and as a solve
    issues them: all launches queued, 100 ms of host work, then the host
    copies (``queued``).
    → per variant and ``n``, the kernel events each session held."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.ones(1024, device="cuda")

    def host_work(seconds: float) -> None:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass

    def session(n: int, variant: str) -> list:
        kw = {"acc_events": True} if variant == "acc_events" else {}
        if variant == "after_session":
            with profile(activities=acts):
                x.add_(1)
                torch.cuda.synchronize()
        with profile(activities=acts, **kw) as prof:
            if variant == "queued":
                outs = [ck.allowed_via_kernel(planes, catalog) for _ in range(n)]
                host_work(0.1)
                for out in outs:
                    out.cpu()
            for _ in range(0 if variant == "queued" else n):
                if variant == "host_busy":
                    host_work(0.1)
                ck.allowed_via_kernel(planes, catalog).cpu()
                if variant == "sync_between":
                    torch.cuda.synchronize()
                if variant == "torch_op":
                    x.add_(1)
            torch.cuda.synchronize()
        kernels = adds = 0
        for evt in prof.key_averages():
            if "compat_allowed_" in evt.key and "_kernel" in evt.key:
                kernels += int(evt.count)
            if float(getattr(evt, "self_device_time_total", 0.0) or 0.0) > 0 and "add" in evt.key.lower():
                adds += int(evt.count)
        return [kernels, adds] if variant == "torch_op" else kernels

    out = {}
    for variant in (
        "plain", "after_session", "sync_between", "acc_events", "torch_op", "host_busy", "queued",
    ):
        for n in (1, 2, 4):
            try:
                out[f"{variant} n={n}"] = [session(n, variant) for _ in range(sessions)]
            except TypeError as e:  # a torch without acc_events
                out[f"{variant} n={n}"] = f"not run: {e}"
    return out


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
    greedy = set(oracle_placements(res, pods))
    if seen & greedy:
        fail(f"{len(seen & greedy)} pods are planned by both the tensor path and the greedy fallback")
    seen |= greedy
    errored = {i for i, p in enumerate(pods) if p.uid in res.pod_errors}
    if seen & errored or len(seen | errored) != len(pods):
        fail(f"{len(pods) - len(seen | errored)} pods neither planned nor errored")


def _profile_once(solver, pods, after_session: bool = False, **solve_kw) -> dict:
    """One warm solve under torch.profiler (``after_session``: right
    after a short session of its own) → wall ms, the device's busy time
    (sum of self device time over every event), the compat kernel's
    device time and calls, and the launches the wrapper's counter saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    if after_session:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    counted_before = ck.COMPAT_ALLOWED.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(pods, **solve_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    busy_us = kernel_us = 0.0
    kernel_calls = device_events = 0
    for evt in prof.key_averages():
        dev_us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        busy_us += dev_us
        device_events += int(evt.count) if dev_us > 0.0 else 0
        if "compat_allowed_" in evt.key and "_kernel" in evt.key:
            kernel_us += dev_us
            kernel_calls += int(evt.count)
    return dict(
        wall_ms=wall_ms, busy_us=busy_us, kernel_us=kernel_us, kernel_calls=kernel_calls,
        device_events=device_events, counted=ck.COMPAT_ALLOWED.launches - counted_before,
    )


def _try_summary(got: dict) -> dict:
    return {
        k: got[k]
        for k in ("after_session", "wall_ms", "device_events", "busy_us", "kernel_calls", "counted")
    }


def profile_solve(solver, pods, attempts: int = 3, **solve_kw) -> dict:
    """A warm solve under torch.profiler: the device's busy time, the
    compat kernel's device time and the idle share of the solve's wall
    time. A trace is complete when it holds every kernel launch the
    wrapper's counter saw in that solve; an incomplete one is retried up
    to ``attempts`` times. If none is complete the numbers are "not
    measured", and a ``profiler_gap`` line before the phase's line says
    what each attempt recorded: a run prints no device time the profiler
    did not record in full."""
    tries = []
    for attempt in range(attempts):
        got = _profile_once(solver, pods, after_session=attempt % 2 == 1, **solve_kw)
        got["after_session"] = attempt % 2 == 1
        tries.append(got)
        if got["busy_us"] > 0.0 and got["counted"] and got["kernel_calls"] == got["counted"]:
            return {
                "profile_tries": [_try_summary(t) for t in tries],
                "profiled_wall_ms": got["wall_ms"],
                "device_busy_ms": got["busy_us"] / 1000.0,
                "device_idle_share": 1.0 - got["busy_us"] / 1000.0 / got["wall_ms"],
                "kernel_device_ms_per_launch": got["kernel_us"] / 1000.0 / got["kernel_calls"],
                "kernel_launches_profiled": got["kernel_calls"],
                "kernel_launches_counted": got["counted"],
            }
    emit({
        "profiler_gap": (
            "no trace of this solve held every compat kernel launch the wrapper counted; "
            "its device times are not measured"
        ),
        "attempts": [_try_summary(t) for t in tries],
    })
    return {
        "profiled_wall_ms": tries[-1]["wall_ms"],
        "device_busy_ms": "not measured",
        "device_idle_share": "not measured",
        "kernel_device_ms_per_launch": "not measured",
        "kernel_launches_counted": tries[-1]["counted"],
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


def _cluster_world(
    n_pods: int, n_types: int, n_nodes: int, n_ha: Optional[int] = None, store: bool = False
):
    """The cluster of phases 5, 7 and 9 (``n_ha`` None: phase 5's, with a
    kube store when ``store``); the random draws are the same either
    way."""
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
    kube = KubeClient() if spread or store else None
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


def check_cluster(res, pods, nodes, daemons, missing, spill: bool = True, pools=()) -> dict:
    """Fail unless the cluster solve's plans hold: every pod placed,
    planned or errored exactly once (the greedy fallback's placements
    included); each existing node's placements, over every plan that
    names it, plus its bound pods and its missing daemons fit its
    allocatable; each new node's pods plus its daemons fit its type;
    ``reserved``'s new nodes from the tensor path stay within its limits
    and, with ``spill`` (the 50k-pod worlds, whose new nodes outgrow its
    limits), some pods spill to ``default``. A new node of a pool in
    ``pools`` runs the daemons that tolerate the pool's taints; other new
    nodes run every daemon. The greedy fallback's claims in ``reserved``
    are reported beside the limit, not held to it: the greedy scheduler
    starts from the pools' limits less the existing nodes, without the
    tensor path's new nodes, as the JAX package's does."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.scheduling import Taints, resources

    index = {p.uid: i for i, p in enumerate(pods)}
    placed = [(("new", i), p.pod_indices) for i, p in enumerate(res.node_plans)] + [
        (("existing", e.state_node.name()), e.pod_indices) for e in res.existing_plans
    ]
    greedy = res.oracle_results
    if greedy is not None:
        placed += [(("claim", n), [index[p.uid] for p in c.pods]) for n, c in enumerate(greedy.new_node_claims)]
        placed += [
            (("existing", e.name()), [index[p.uid] for p in e.pods]) for e in greedy.existing_nodes if e.pods
        ]
    seen = {}
    on_node = {}
    for where, members in placed:
        for i in members:
            if i in seen:
                fail(f"pod {i} is placed twice: {seen[i]} and {where}")
            seen[i] = where
        if where[0] == "existing":
            on_node.setdefault(where[1], []).extend(members)
    errored = {i for i, p in enumerate(pods) if p.uid in res.pod_errors}
    if set(seen) & errored or len(set(seen) | errored) != len(pods):
        fail(f"{len(pods) - len(set(seen) | errored)} pods neither placed, planned nor errored")
    by_name = {sn.name(): sn for sn in nodes}
    for name, members in on_node.items():
        sn = by_name[name]
        load = resources.merge(*(resources.requests_for_pods(pods[i]) for i in members), missing[name])
        if not resources.fits(load, sn.available()):
            fail(f"existing node {name} is overcommitted by its placements")
        taints = Taints(sn.taints())
        if any(taints.tolerates(pods[i]) is not None for i in members):
            fail(f"a pod on {name} does not tolerate its taints")
    # no pool carries a capacity-type requirement: a new node runs every
    # daemon its pool's taints admit
    taints = {p.name: Taints(p.spec.template.taints) for p in pools}
    for plan in res.node_plans:
        pool_taints = taints.get(plan.nodepool_name)
        overhead = resources.requests_for_pods(
            *(d for d in daemons if pool_taints is None or pool_taints.tolerates(d) is None)
        )
        if not resources.fits(resources.merge(plan.requests, overhead), plan.instance_type.allocatable()):
            fail(f"plan on {plan.instance_type.name} overflows its allocatable with its daemons")
    used = resources.merge(
        *(sn.capacity() for sn in nodes if sn.labels().get(wk.NODEPOOL_LABEL_KEY) == "reserved"),
        *(p.instance_type.capacity for p in res.node_plans if p.nodepool_name == "reserved"),
    )
    for k, v in RESERVED_LIMITS.items():
        if used.get(k, 0) > parse_quantity(v):
            fail(f"reserved uses {used.get(k, 0)} {k}, over its limit {v}")
    # the greedy claims' largest option is what its limit tracking charges
    greedy_reserved = resources.merge(
        *(
            resources.max_resources(*(it.capacity for it in c.instance_type_options))
            for c in (greedy.new_node_claims if greedy is not None else ())
            if c.nodepool_name == "reserved"
        )
    )
    per_pool = {}
    for p in res.node_plans:
        per_pool.setdefault(p.nodepool_name, [0, 0])
        per_pool[p.nodepool_name][0] += 1
        per_pool[p.nodepool_name][1] += len(p.pod_indices)
    if spill and per_pool.get("default", [0, 0])[1] == 0:
        fail("no pod spilled to the default pool")
    return {
        "pods_on_existing": sum(len(m) for m in on_node.values()),
        "existing_nodes_used": len(on_node),
        "new_nodes_by_pool": {k: v[0] for k, v in sorted(per_pool.items())},
        "new_node_pods_by_pool": {k: v[1] for k, v in sorted(per_pool.items())},
        "reserved_cpu_used": used.get("cpu", 0) / 1e9,
        "reserved_memory_gi_used": used.get("memory", 0) / 1e9 / 2**30,
        "reserved_cpu_greedy_claims_max": greedy_reserved.get("cpu", 0) / 1e9,
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


def capture_pack_existing(fn, calls: int = 1):
    """Run ``fn()`` and return the inputs the solve handed to
    ``run_pack_existing`` (copies): those of its one call, or with
    ``calls`` None the list of every call's."""
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    real = solver_mod.run_pack_existing
    seen = []

    def spy(reqs, sig_ids, compat, free, **kw):
        seen.append(tuple(np.array(x) for x in (reqs, sig_ids, compat, free)))
        return real(reqs, sig_ids, compat, free, **kw)

    solver_mod.run_pack_existing = spy
    try:
        out = fn()
    finally:
        solver_mod.run_pack_existing = real
    if calls is None:
        return out, seen
    if len(seen) != calls:
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


# -- phases 8 and 9: pod affinity and anti-affinity -------------------------------


_QUANTITIES: dict = {}


def pending_pod(name: str, cpu: str, mem: str, labels=None):
    """A pending pod as ``bench.py::_mk_pod`` builds it."""
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    pod = Pod()
    pod.metadata.name = name
    pod.metadata.labels = dict(labels or {})
    # parsed quantities are ints: one parse per distinct string
    for q in (cpu, mem):
        if q not in _QUANTITIES:
            _QUANTITIES[q] = parse_quantity(q)
    requests = {"cpu": _QUANTITIES[cpu], "memory": _QUANTITIES[mem]}
    pod.spec = PodSpec(containers=[Container(name="main", resources=ResourceRequirements(requests=requests))])
    pod.status.conditions = [PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]
    return pod


def config6_world(n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES, seed: int = CONFIG6_SEED):
    """bench.py config 6 whole (``bench.py:674``, RandomState(17)):
    karpenter-core's ``makeDiversePods`` mix
    (scheduling_benchmark_test.go:184-287). 3/7 generic, then 1/7 each
    of zone spread, hostname spread (max_skew 1, DoNotSchedule, selector
    ``my-label`` drawn from seven values, so mostly counting other
    pods), hostname pod affinity and zone pod affinity (selector
    ``my-affininity`` from the same seven values). Catalog
    ``instance_types(n_types)``, one NodePool ``default``, no cluster.
    → ([nodepool], provider, pods)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        LabelSelector,
        PodAffinity,
        PodAffinityTerm,
        TopologySpreadConstraint,
    )

    rng = np.random.RandomState(seed)
    vals = ["a", "b", "c", "d", "e", "f", "g"]
    cpus = ["100m", "250m", "500m", "1", "1500m"]
    mems = ["100Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]

    def rnd(seq):
        return seq[rng.randint(len(seq))]

    seventh = n_pods // 7
    pods = []

    def base(labels):
        return pending_pod(f"bench-{len(pods)}", rnd(cpus), rnd(mems), labels=labels)

    for _ in range(3 * seventh + (n_pods - 7 * seventh)):
        pods.append(base({"my-label": rnd(vals)}))
    for key in (wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME):
        for _ in range(seventh):
            p = base({"my-label": rnd(vals)})
            p.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels={"my-label": rnd(vals)}),
                )
            ]
            pods.append(p)
    for key in (wk.LABEL_HOSTNAME, wk.LABEL_TOPOLOGY_ZONE):
        for _ in range(seventh):
            p = base({"my-affininity": rnd(vals)})
            p.spec.affinity = Affinity(
                pod_affinity=PodAffinity(
                    required=[
                        PodAffinityTerm(
                            topology_key=key,
                            label_selector=LabelSelector(match_labels={"my-affininity": rnd(vals)}),
                        )
                    ]
                )
            )
            pods.append(p)
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    return [nodepool], provider, pods


def anti_dense_pods(n_pods: int = N_ANTI, n_quorum: int = N_QUORUM) -> list:
    """bench.py config 13 ``anti_dense``'s pending pods
    (``bench.py:2035-2090``, RandomState(13)): 55 % ``team=t-d`` with a
    required zone anti-affinity to ``app=ext-(d % 8)``, 15 % ``team=m-d``
    with two zone terms (``ext-(d % 8)``, ``ext-((d + 3) % 8)``) and a
    hostname term (``ext-(d % 8)``), 30 % plain 500m / 512Mi; then
    ``n_quorum`` ``app=quorum`` pods (1 CPU / 2Gi) with a required zone
    self-anti-affinity: an etcd-style quorum, one member per zone."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        LabelSelector,
        PodAffinityTerm,
        PodAntiAffinity,
    )

    def anti(*terms):
        return Affinity(
            pod_anti_affinity=PodAntiAffinity(
                required=[
                    PodAffinityTerm(topology_key=key, label_selector=LabelSelector(match_labels={"app": app}))
                    for key, app in terms
                ]
            )
        )

    zone, host = wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME
    rng = np.random.RandomState(ANTI_SEED)
    pods = []
    for i in range(n_pods):
        roll = rng.rand()
        d = rng.randint(24)
        if roll < 0.55:
            p = pending_pod(
                f"bench-{i}", ["250m", "500m", "1"][rng.randint(3)], ["256Mi", "1Gi"][rng.randint(2)],
                labels={"team": f"t-{d}"},
            )
            p.spec.affinity = anti((zone, f"ext-{d % 8}"))
        elif roll < 0.70:
            p = pending_pod(
                f"bench-{i}", ["250m", "500m"][rng.randint(2)], ["256Mi", "512Mi"][rng.randint(2)],
                labels={"team": f"m-{d}"},
            )
            s1, s2 = d % 8, (d + 3) % 8
            p.spec.affinity = anti((zone, f"ext-{s1}"), (zone, f"ext-{s2}"), (host, f"ext-{s1}"))
        else:
            p = pending_pod(f"bench-{i}", "500m", "512Mi")
        pods.append(p)
    for k in range(n_quorum):
        p = pending_pod(f"quorum-{k}", "1", "2Gi", labels={"app": "quorum"})
        p.spec.affinity = anti((zone, "quorum"))
        pods.append(p)
    return pods


def bound_anchor(name: str, labels: dict, node_name: str):
    """A running 100m / 128Mi pod bound to ``node_name``."""
    p = pending_pod(name, "100m", "128Mi", labels=labels)
    p.spec.node_name = node_name
    p.status.phase = "Running"
    p.status.conditions = []
    return p


def anti_dense_world(n_pods: int = N_ANTI, n_types: int = N_ANTI_TYPES, n_quorum: int = N_QUORUM):
    """bench.py config 13 ``anti_dense`` as the bench builds it
    (``bench.py:1953-2090``): ``instance_types(n_types)``, one NodePool
    ``default``, no existing nodes, a kube store holding nodes
    ``seed-test-zone-1..3`` (a zone label only) and the eight anchors
    ``ext-s`` (``app=ext-s``) on ``seed-test-zone-{s % 3 + 1}``; the pods
    of ``anti_dense_pods``. Every pod takes a new node. → ([nodepool],
    provider, pods, [], [], {}, kube)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import Node

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    kube = KubeClient()
    for z in range(3):
        node = Node()
        node.metadata.name = f"seed-test-zone-{z + 1}"
        node.metadata.labels = {wk.LABEL_TOPOLOGY_ZONE: f"test-zone-{z + 1}"}
        kube.create(node)
    for s in range(8):
        kube.create(bound_anchor(f"seed-ext-{s}", {"app": f"ext-{s}"}, f"seed-test-zone-{s % 3 + 1}"))
    return [nodepool], provider, anti_dense_pods(n_pods, n_quorum), [], [], {}, kube


def anti_cluster_world(
    n_pods: int = N_ANTI, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_quorum: int = N_QUORUM
):
    """``anti_dense_pods`` against phase 5's cluster in a kube store →
    (nodepools, provider, pods, state_nodes, daemonset_pods, missing,
    kube): the cluster is ``_cluster_world``'s (RandomState(12), pools
    ``reserved`` and ``default``, the ``instance_types(n_types)``
    catalog), every node and bound pod also in ``kube``, and the anchor
    ``ext-s`` is bound on ``node-{s + 3:04d}`` (nodes 0003..0010), a node
    of zone ``test-zone-{s % 3 + 1}``, the zone ``bench.py`` seeds it
    in."""
    from karpenter_core_tpu_torch.apis import labels as wk

    pools, provider, _, nodes, daemons, missing, kube = _cluster_world(0, n_types, n_nodes, store=True)
    by_name = {sn.name(): sn for sn in nodes}
    for s in range(8):
        node_name = f"node-{s + 3:04d}"
        sn = by_name[node_name]
        if sn.labels()[wk.LABEL_TOPOLOGY_ZONE] != f"test-zone-{s % 3 + 1}":
            fail(f"anchor node {node_name} is not in zone test-zone-{s % 3 + 1}")
        p = bound_anchor(f"seed-ext-{s}", {"app": f"ext-{s}"}, node_name)
        sn.update_for_pod(p)
        kube.create(p)
    return pools, provider, anti_dense_pods(n_pods, n_quorum), nodes, daemons, missing, kube


def placements(res) -> dict:
    """pod index → (zone, node key) of every placement; node keys are
    ``("existing", name)`` and ``("new", plan ordinal)``."""
    from karpenter_core_tpu_torch.apis import labels as wk

    where = {}
    for n, plan in enumerate(res.node_plans):
        for i in plan.pod_indices:
            where[i] = (plan.zone, ("new", n))
    for e in res.existing_plans:
        for i in e.pod_indices:
            where[i] = (e.state_node.labels().get(wk.LABEL_TOPOLOGY_ZONE), ("existing", e.state_node.name()))
    return where


def bound_domains(kube) -> list:
    """(pod, zone, node key) of every pod bound in ``kube`` that counts."""
    from karpenter_core_tpu_torch.apis import labels as wk

    if kube is None:
        return []
    node_zone = {n.name: n.metadata.labels.get(wk.LABEL_TOPOLOGY_ZONE) for n in kube.list("Node")}
    return [
        (p, node_zone.get(p.spec.node_name), ("existing", p.spec.node_name))
        for p in kube.list("Pod")
        if p.spec.node_name
        and p.status.phase not in ("Succeeded", "Failed")
        and p.metadata.deletion_timestamp is None
    ]


def check_affinity(res, pods, kube=None) -> dict:
    """Fail unless every placed pod with required pod-affinity terms
    shares, for each term, its zone (zone terms) or its node (hostname
    terms) with a pod of its namespace the term's selector matches:
    another placement of this batch, a planned member, a bound pod, or
    itself (the pod that seeds an empty domain of its own selector)."""
    from karpenter_core_tpu_torch.apis import labels as wk

    where = placements(res)
    by_zone, by_node = {}, {}
    for i, (z, node) in where.items():
        by_zone.setdefault(z, []).append((pods[i].namespace, pods[i].metadata.labels))
        by_node.setdefault(node, []).append((pods[i].namespace, pods[i].metadata.labels))
    for p, z, node in bound_domains(kube):
        by_zone.setdefault(z, []).append((p.namespace, p.metadata.labels))
        by_node.setdefault(node, []).append((p.namespace, p.metadata.labels))
    checked = {"zone": 0, "hostname": 0}
    for i, (z, node) in sorted(where.items()):
        a = pods[i].spec.affinity
        if a is None or a.pod_affinity is None:
            continue
        for t in a.pod_affinity.required:
            hostname = t.topology_key == wk.LABEL_HOSTNAME
            members = by_node[node] if hostname else by_zone[z]
            if not any(ns == pods[i].namespace and t.label_selector.matches(lbl) for ns, lbl in members):
                fail(
                    f"pod {pods[i].name} on {node} in {z} has no pod matching its "
                    f"{t.topology_key} affinity {t.label_selector.match_labels}"
                )
            checked["hostname" if hostname else "zone"] += 1
    affinity_pods = [i for i, p in enumerate(pods) if p.spec.affinity is not None and p.spec.affinity.pod_affinity]
    if not affinity_pods:
        fail("the world has no pod-affinity pod")
    return {
        "affinity_pods": len(affinity_pods),
        "affinity_placed": sum(1 for i in affinity_pods if i in where),
        "affinity_errors": sum(1 for i in affinity_pods if pods[i].uid in res.pod_errors),
        "terms_checked": checked,
    }


def check_anti(res, pods, kube) -> dict:
    """Fail unless no placed pod with required anti-affinity shares its
    zone (zone terms) or its node (hostname terms) with another pod of
    its namespace the term's selector matches, bound or placed, and at
    most one ``app=quorum`` pod sits in each zone."""
    from karpenter_core_tpu_torch.apis import labels as wk

    where = placements(res)
    by_zone, by_node = {}, {}
    for i, (z, node) in where.items():
        by_zone.setdefault(z, []).append((i, pods[i].namespace, pods[i].metadata.labels))
        by_node.setdefault(node, []).append((i, pods[i].namespace, pods[i].metadata.labels))
    for p, z, node in bound_domains(kube):
        by_zone.setdefault(z, []).append((None, p.namespace, p.metadata.labels))
        by_node.setdefault(node, []).append((None, p.namespace, p.metadata.labels))
    checked = {"zone": 0, "hostname": 0}
    for i, (z, node) in sorted(where.items()):
        a = pods[i].spec.affinity
        if a is None or a.pod_anti_affinity is None:
            continue
        for t in a.pod_anti_affinity.required:
            hostname = t.topology_key == wk.LABEL_HOSTNAME
            for j, ns, lbl in by_node.get(node, []) if hostname else by_zone.get(z, []):
                if j != i and ns == pods[i].namespace and t.label_selector.matches(lbl):
                    fail(
                        f"pod {pods[i].name} on {node} in {z} shares its {t.topology_key} with "
                        f"a pod its anti-affinity {t.label_selector.match_labels} excludes"
                    )
            checked["hostname" if hostname else "zone"] += 1
    quorum = [i for i, p in enumerate(pods) if p.metadata.labels.get("app") == "quorum"]
    per_zone = {}
    for i in quorum:
        if i in where:
            per_zone[where[i][0]] = per_zone.get(where[i][0], 0) + 1
    if any(n > 1 for n in per_zone.values()):
        fail(f"quorum members share a zone: {per_zone}")
    anti = [i for i, p in enumerate(pods) if p.spec.affinity is not None and p.spec.affinity.pod_anti_affinity]
    return {
        "anti_pods": len(anti),
        "anti_placed": sum(1 for i in anti if i in where),
        "anti_on_existing": sum(1 for i in anti if i in where and where[i][1][0] == "existing"),
        "terms_checked": checked,
        "quorum_by_zone": dict(sorted(per_zone.items())),
        "quorum_errors": sorted({res.pod_errors[pods[i].uid] for i in quorum if pods[i].uid in res.pod_errors}),
    }


def check_spread_serial(res, pods, provider, first=()) -> list:
    """Fail unless every zone-spread group holds its max_skew in the
    serial order the tensor path schedules a batch whose spread groups
    share one pack class (bench config 6): the spread groups in the
    order of their first pod, each seeing the spread pods placed before
    it, the pods without a spread after all of them. A self-selecting
    group's zones must end within max_skew of the least-loaded supported
    zone, its own pods counted; a group whose selector does not match
    its own pods adds nothing to the counts, so the zones it took must
    have been within max_skew when it came (topologygroup.go:166-175).
    The final counts, which ``check_spread`` reads, also hold the pods
    without a constraint placed later, which the constraint does not
    bound. ``first``: pods placed before every spread group (against a
    cluster, the unconstrained pods the existing-node first-fit placed).
    → one summary per group."""
    from karpenter_core_tpu_torch.apis import labels as wk

    zone_key = wk.LABEL_TOPOLOGY_ZONE
    where = {i: z for i, (z, _) in placements(res).items()}
    supported = sorted({o.zone for it in provider.instance_types for o in it.offerings if o.available})
    groups = {}
    for i, p in enumerate(pods):
        for c in p.spec.topology_spread_constraints:
            if c.topology_key == zone_key:
                key = (p.namespace, tuple(sorted(p.metadata.labels.items())), c.label_selector.key(), c.max_skew)
                groups.setdefault(key, (c, []))[1].append(i)
    before: list = list(first)
    out = []
    for (ns, _, _, skew), (c, members) in groups.items():
        sel = c.label_selector
        counts = dict.fromkeys(supported, 0)
        for j in before:
            if j in where and pods[j].namespace == ns and sel.matches(pods[j].metadata.labels):
                counts[where[j]] += 1
        placed = {}
        for i in members:
            if i in where:
                placed[where[i]] = placed.get(where[i], 0) + 1
        self_selecting = sel.matches(pods[members[0]].metadata.labels)
        if self_selecting:
            counts = {z: n + placed.get(z, 0) for z, n in counts.items()}
        lo = min(counts.values())
        worst = max((counts[z] - lo for z in placed), default=0)
        if worst > skew:
            fail(
                f"spread {sel.match_labels} of pods {dict(pods[members[0]].metadata.labels)} breaks "
                f"max_skew {skew}: counts {counts}, pods landed in {sorted(placed)}"
            )
        out.append({
            "selector": dict(sel.match_labels), "self_selecting": self_selecting, "pods": len(members),
            "placed_by_zone": dict(sorted(placed.items())), "worst_skew": worst,
        })
        before.extend(members)
    if not out:
        fail("the world has no zone-spread group")
    return out


def run_config6_phase(device: str = "cuda", n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES) -> dict:
    """Phase 8: bench config 6 whole → its line (also emitted); fails on
    any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    pools, provider, pods = config6_world(n_pods, n_types)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods)
    if device == "cuda" and launches < 4:
        fail(f"config 6 launched the compat kernel {launches} times in 4 solves")
    same_as_cpu(cold, TorchScheduler(pools, provider, device="cpu").solve(pods), "config 6")
    check_invariants(cold, pods)
    row = {
        "config6": f"{n_pods} pods x {n_types} types (bench config 6, karpenter-core's diverse mix)",
        **timing_row(cold, cold_ms, warm_runs, launches),
        "affinity": check_affinity(cold, pods),
        "spread": check_spread_serial(cold, pods, provider),
        **(profile_solve(solver, pods) if device == "cuda" else {}),
    }
    emit(row)
    return row


def run_anti_phase(device: str = "cuda", n_pods: int = N_ANTI, n_nodes: int = N_NODES,
                   n_quorum: int = N_QUORUM, n_types=(N_ANTI_TYPES, N_TYPES)) -> tuple:
    """Phase 9: config 13 ``anti_dense`` and a zone quorum, first as the
    bench builds it (every pod on a new node), then against the live
    cluster → their two lines (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    rows = []
    for name, world, args in (
        ("anti_dense", anti_dense_world, (n_pods, n_types[0], n_quorum)),
        ("anti_cluster", anti_cluster_world, (n_pods, n_types[1], n_nodes, n_quorum)),
    ):
        t0 = time.perf_counter()
        pools, provider, pods, nodes, daemons, missing, kube = world(*args)
        world_s = time.perf_counter() - t0
        kw = dict(state_nodes=nodes, daemonset_pods=daemons)
        solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
        cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
        if device == "cuda" and launches < 4 * len(pools):
            fail(f"{name} launched the compat kernel {launches} times in 4 solves")
        cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
        same_as_cpu(cold, cpu, name)
        if not nodes:
            check_invariants(cold, pods)
        row = {
            name: (
                f"{len(pods)} pods ({n_pods} config 13 anti_dense + {n_quorum} zone quorum) x "
                f"{len(provider.instance_types)} types"
                + (f" x {len(nodes)} existing nodes" if nodes else ", no existing nodes")
                + ", kube store seeds"
            ),
            "world_build_s": world_s,
            "bound_pods": len(kube.list("Pod")),
            **timing_row(cold, cold_ms, warm_runs, launches),
            **(check_cluster(cold, pods, nodes, daemons, missing, spill=False) if nodes else {}),
            "anti": check_anti(cold, pods, kube),
            **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
        }
        emit(row)
        rows.append(row)
    return tuple(rows)


# -- phase 10: host ports and CSI volumes ------------------------------------------


def stateful_dense_pods(n_pods: int = N_STATEFUL) -> list:
    """bench.py config 13 ``stateful_dense``'s pending pods
    (``bench.py:2102-2134``, RandomState(13)): 40 % StatefulSet-shaped
    pods with one generic ephemeral volume (250m or 500m, 512Mi or 1Gi),
    30 % host-port deployments (250m / 256Mi) on one of the 12 ports
    8000–8011, 30 % plain 500m / 512Mi."""
    from karpenter_core_tpu_torch.kube.objects import ContainerPort, Volume

    rng = np.random.RandomState(ANTI_SEED)
    pods = []
    for i in range(n_pods):
        roll = rng.rand()
        if roll < 0.4:
            p = pending_pod(f"bench-{i}", ["250m", "500m"][rng.randint(2)], ["512Mi", "1Gi"][rng.randint(2)])
            p.spec.volumes = [Volume(name="data", ephemeral=True)]
        elif roll < 0.7:
            p = pending_pod(f"bench-{i}", "250m", "256Mi")
            p.spec.containers[0].ports = [ContainerPort(host_port=8000 + int(rng.randint(12)))]
        else:
            p = pending_pod(f"bench-{i}", "500m", "512Mi")
        pods.append(p)
    return pods


def _default_storage_class(kube) -> None:
    """The default StorageClass of config 13 (``bench-standard``,
    provisioner ``ebs.csi.bench``)."""
    from karpenter_core_tpu_torch.kube.objects import StorageClass

    sc = StorageClass(provisioner=CSI_DRIVER)
    sc.metadata.name = "bench-standard"
    sc.metadata.annotations = {"storageclass.kubernetes.io/is-default-class": "true"}
    kube.create(sc)


def stateful_dense_world(n_pods: int = N_STATEFUL, n_types: int = N_ANTI_TYPES, bench_units: bool = False):
    """bench.py config 13 ``stateful_dense`` (``bench.py:2102-2150``):
    ``stateful_dense_pods``, ``instance_types(n_types)``, one NodePool
    ``default``, a kube store holding the default StorageClass, and 16
    initialized nodes ``csi-node-m`` in zones ``test-zone-(m % 3 + 1)``
    with CSI attach limit 8 for ``ebs.csi.bench`` → (nodepools, provider,
    pods, state_nodes, [], missing, kube). The nodes hold 16 CPU, 64Gi
    and 110 pods in the solver's units (``parse_quantity``); with
    ``bench_units`` they hold the raw integers ``bench.py`` writes (16e9
    nano-CPU, but 64·2^30 nano-bytes and 110 nano-pods: no pod fits)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import Node
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.state import StateNode

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    kube = KubeClient()
    _default_storage_class(kube)
    pods = stateful_dense_pods(n_pods)
    if bench_units:
        capacity = {"cpu": 16 * 10**9, "memory": 64 * 1024**3, "pods": 110}
    else:
        capacity = {"cpu": parse_quantity("16"), "memory": parse_quantity("64Gi"), "pods": parse_quantity("110")}
    nodes = []
    for m in range(16):
        node = Node()
        node.metadata.name = f"csi-node-{m}"
        node.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: "default",
            wk.LABEL_HOSTNAME: f"csi-node-{m}",
            wk.LABEL_TOPOLOGY_ZONE: f"test-zone-{m % 3 + 1}",
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.NODE_INITIALIZED_LABEL_KEY: "true",
        }
        node.status.capacity = dict(capacity)
        node.status.allocatable = dict(capacity)
        sn = StateNode(node=node)
        sn.volume_usage.csi_limits = {CSI_DRIVER: 8}
        nodes.append(sn)
    return [nodepool], provider, pods, nodes, [], {sn.name(): {} for sn in nodes}, kube


def spread_skew_world(n_pods: int = N_STATEFUL, n_types: int = N_ANTI_TYPES):
    """bench.py config 13 ``spread_skew`` as the bench builds it
    (``bench.py:2009-2034``, RandomState(13)): pods ``app=svc-d`` (d
    uniform in 0..19; 250m, 500m or 1 CPU; 256Mi or 1Gi) with a zone
    spread (max_skew 1, DoNotSchedule) on their own service, against
    seeds skewed to ``test-zone-1``: every even service has ``d % 5 + 1``
    bound pods on ``seed-test-zone-1``. ``instance_types(n_types)``, one
    NodePool ``default``, no existing nodes → (nodepools, provider, pods,
    [], [], {}, kube)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import LabelSelector, Node, TopologySpreadConstraint

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    kube = KubeClient()
    node = Node()
    node.metadata.name = "seed-test-zone-1"
    node.metadata.labels = {wk.LABEL_TOPOLOGY_ZONE: "test-zone-1"}
    for d in range(0, 20, 2):
        for k in range(d % 5 + 1):
            if kube.get("Node", node.name) is None:
                kube.create(node)
            kube.create(bound_anchor(f"seed-skew-{d}-{k}", {"app": f"svc-{d}"}, node.name))
    rng = np.random.RandomState(ANTI_SEED)
    pods = []
    for i in range(n_pods):
        d = rng.randint(20)
        p = pending_pod(
            f"bench-{i}", ["250m", "500m", "1"][rng.randint(3)], ["256Mi", "1Gi"][rng.randint(2)],
            labels={"app": f"svc-{d}"},
        )
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": f"svc-{d}"}),
            )
        ]
        pods.append(p)
    return [nodepool], provider, pods, [], [], {}, kube


def stateful_cluster_world(
    n_pods: int = N_STATEFUL, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_replicas: int = N_REPLICAS
):
    """``stateful_dense_pods`` and three StatefulSets against phase 5's
    cluster in a kube store → (nodepools, provider, pods, state_nodes,
    daemonset_pods, missing, kube):

    - the cluster is ``_cluster_world``'s (RandomState(12), pools
      ``reserved`` and ``default``), every node with a CSI attach limit
      of 25 for ``ebs.csi.bench`` (EBS on Nitro instances); on every
      third node the first 20–25 bound workers (RandomState(14); all of
      them where it runs fewer) mount one claim each (four of 1,000
      nodes full);
    - the ``exporter`` daemon takes hostPort 9100, as Prometheus'
      node-exporter does, on every on-demand node;
    - a third NodePool ``db`` (label and taint ``workload=db``) for the
      databases;
    - pending: ``stateful_dense_pods(n_pods)``; ``n_pods // 100``
      ``app=metrics-agent`` pods on hostPort 9100 (100m / 128Mi), which
      the exporter's nodes refuse; and three StatefulSets of
      ``n_replicas`` replicas, each replica with its own claim:
      ``pg`` (2 CPU / 8Gi, on ``db``) and ``redis`` (500m / 2Gi, any
      node) with claims bound to PersistentVolumes pinned to zone
      ``test-zone-(k % 3 + 1)``, ``kafka`` (1 CPU / 4Gi, on ``db``) with
      unbound claims of StorageClass ``zonal`` (allowed topologies
      ``test-zone-1`` and ``test-zone-2``)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.kube.objects import (
        ContainerPort,
        PersistentVolume,
        PersistentVolumeClaim,
        StorageClass,
        Taint,
        Toleration,
        Volume,
    )
    from karpenter_core_tpu_torch.scheduling.volumes import get_volumes

    pools, provider, _, nodes, daemons, missing, kube = _cluster_world(0, n_types, n_nodes, store=True)
    _default_storage_class(kube)
    zonal = StorageClass(provisioner=CSI_DRIVER, zones=["test-zone-1", "test-zone-2"])
    zonal.metadata.name = "zonal"
    kube.create(zonal)
    exporter = next(d for d in daemons if d.name == "exporter")
    exporter.spec.containers[0].ports = [ContainerPort(host_port=9100)]
    bound_by_node = {}
    for p in kube.list("Pod"):
        bound_by_node.setdefault(p.spec.node_name, []).append(p)
    rng = np.random.RandomState(NODE_SEED + 2)
    for m, sn in enumerate(nodes):
        sn.volume_usage.csi_limits = {CSI_DRIVER: 25}
        bound = kube.get("Pod", f"{sn.name()}-exporter", namespace="default")
        if bound is not None:
            bound.spec.containers[0].ports = [ContainerPort(host_port=9100)]
            sn.update_for_pod(bound)
        if m % 3:
            continue
        workers = [w for w in bound_by_node.get(sn.name(), ()) if w.name.startswith(f"{sn.name()}-w")]
        for p in workers[: int(rng.randint(20, 26))]:
            claim = PersistentVolumeClaim(storage_class_name="bench-standard")
            claim.metadata.name = f"data-{p.name}"
            kube.create(claim)
            p.spec.volumes = [Volume(name="data", persistent_volume_claim=claim.name)]
            sn.volume_usage.add(p, get_volumes(kube, p))
    db = NodePool()
    db.metadata.name = "db"
    db.spec.template.metadata.labels = {"workload": "db"}
    db.spec.template.taints = [Taint(key="workload", value="db", effect="NoSchedule")]
    pods = stateful_dense_pods(n_pods)
    for k in range(n_pods // 100):
        p = pending_pod(f"metrics-agent-{k}", "100m", "128Mi", labels={"app": "metrics-agent"})
        p.spec.containers[0].ports = [ContainerPort(host_port=9100)]
        pods.append(p)
    for sts, cpu, mem, on_db, pinned in (
        ("pg", "2", "8Gi", True, True), ("kafka", "1", "4Gi", True, False), ("redis", "500m", "2Gi", False, True),
    ):
        for k in range(n_replicas):
            claim = PersistentVolumeClaim(storage_class_name="bench-standard" if pinned else "zonal")
            claim.metadata.name = f"data-{sts}-{k}"
            if pinned:
                pv = PersistentVolume(zones=[f"test-zone-{k % 3 + 1}"], driver=CSI_DRIVER)
                pv.metadata.name = f"pv-{sts}-{k}"
                kube.create(pv)
                claim.volume_name = pv.name
            kube.create(claim)
            p = pending_pod(f"{sts}-{k}", cpu, mem, labels={"app": sts})
            p.spec.volumes = [Volume(name="data", persistent_volume_claim=claim.name)]
            if on_db:
                p.spec.node_selector = {"workload": "db"}
                p.spec.tolerations = [Toleration(key="workload", value="db", effect="NoSchedule")]
            pods.append(p)
    return [*pools, db], provider, pods, nodes, daemons, missing, kube


def pod_host_ports(pod) -> list:
    from karpenter_core_tpu_torch.scheduling.hostports import HostPort

    return [
        HostPort(ip=p.host_ip or "0.0.0.0", port=p.host_port, protocol=p.protocol or "TCP")
        for c in pod.spec.containers + pod.spec.init_containers
        for p in c.ports
        if p.host_port
    ]


def check_ports(res, pods, nodes=()) -> dict:
    """Fail unless no node, existing or new, holds two pods whose host
    ports conflict (``HostPort.matches``: same protocol and port, equal
    IPs or either unspecified), the existing nodes' own reservations
    counted."""
    where = placements(res)
    by_node = {}
    for sn in nodes:
        for key, ports in sn.host_port_usage.reserved.items():
            if ports:
                by_node.setdefault(("existing", sn.name()), []).append((("bound",) + key, ports))
    port_pods = 0
    for i, (_, node) in where.items():
        ports = pod_host_ports(pods[i])
        if ports:
            port_pods += 1
            by_node.setdefault(node, []).append((i, ports))
    for node, entries in by_node.items():
        for a in range(len(entries)):
            for b in range(a):
                if any(x.matches(y) for x in entries[a][1] for y in entries[b][1]):
                    fail(f"pods {entries[a][0]} and {entries[b][0]} on {node} hold conflicting host ports")
    return {
        "port_pods_placed": port_pods,
        "port_pods_on_existing": sum(1 for i, (_, n) in where.items() if n[0] == "existing" and pod_host_ports(pods[i])),
    }


def pod_volume_ids(pod, kube) -> dict:
    """driver → claim ids of a pod's volumes, resolved PVC → bound PV's
    driver, else its StorageClass's (the default class for ephemeral
    volumes and claims without one); an ephemeral volume's claim is
    ``<pod>-<volume>``."""
    classes = kube.list("StorageClass")
    default = next(
        (sc.name for sc in classes if sc.metadata.annotations.get("storageclass.kubernetes.io/is-default-class") == "true"),
        None,
    )
    out = {}
    for v in pod.spec.volumes:
        if v.persistent_volume_claim:
            pvc = kube.get("PersistentVolumeClaim", v.persistent_volume_claim, namespace=pod.namespace)
            if pvc is None:
                continue
            claim, pv_name, sc_name = v.persistent_volume_claim, pvc.volume_name, pvc.storage_class_name or default
        elif v.ephemeral:
            claim, pv_name, sc_name = f"{pod.name}-{v.name}", "", default
        else:
            continue
        pv = kube.get("PersistentVolume", pv_name) if pv_name else None
        sc = kube.get("StorageClass", sc_name) if sc_name else None
        driver = pv.driver if pv is not None and pv.driver else (sc.provisioner if sc is not None else "")
        if driver:
            out.setdefault(driver, set()).add(f"{pod.namespace}/{claim}")
    return out


def check_volumes(res, pods, nodes, kube) -> dict:
    """Fail unless, on every existing node and for every CSI driver, the
    claims it mounts and those its new pods bring, shared claims counted
    once, stay within its attach limit."""
    by_name = {sn.name(): sn for sn in nodes}
    volume_pods = 0
    for e in res.existing_plans:
        sn = by_name[e.state_node.name()]
        mounted = {d: set(ids) for d, ids in sn.volume_usage.volumes.items()}
        for i in e.pod_indices:
            ids = pod_volume_ids(pods[i], kube)
            volume_pods += bool(ids)
            for d, claims in ids.items():
                mounted.setdefault(d, set()).update(claims)
        for d, claims in mounted.items():
            limit = sn.volume_usage.csi_limits.get(d)
            if limit is not None and len(claims) > limit:
                fail(f"existing node {sn.name()} mounts {len(claims)} {d} volumes, over its limit {limit}")
    return {
        "volume_pods_on_existing": volume_pods,
        "volume_pods_placed": sum(1 for i in placements(res) if pods[i].spec.volumes),
    }


def check_zone_pins(res, pods, kube) -> dict:
    """Fail unless every placed pod whose claim is pinned (a bound PV
    with zones, else a StorageClass with allowed zones) sits in a zone
    the pin allows."""
    where = placements(res)
    pinned = 0
    for i, (zone, node) in sorted(where.items()):
        for v in pods[i].spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = kube.get("PersistentVolumeClaim", v.persistent_volume_claim, namespace=pods[i].namespace)
            if pvc is None:
                continue
            pv = kube.get("PersistentVolume", pvc.volume_name) if pvc.volume_name else None
            sc = kube.get("StorageClass", pvc.storage_class_name) if pvc.storage_class_name else None
            zones = pv.zones if pv is not None and pv.zones else (sc.zones if sc is not None else [])
            if not zones:
                continue
            pinned += 1
            if zone not in zones:
                fail(f"pod {pods[i].name} on {node} sits in {zone}, outside its claim's zones {zones}")
    return {"pinned_placed": pinned}



def stateful_pack_check(calls, axis_width: int, device: str = "cuda") -> dict:
    """``pack_existing_check`` on every existing-node first-fit of a
    solve whose inputs carry port or ephemeral-volume columns beyond the
    resource axis (the stateful pass) → their sums."""
    extended = [c for c in calls if c[3].shape[1] > axis_width]
    rows = [pack_existing_check(c, device) for c in extended]
    return {
        "calls": len(calls), "extended_calls": len(extended),
        "P": sum(r["P"] for r in rows), "max_R": max((r["R"] for r in rows), default=0),
        "assigned": sum(r["assigned"] for r in rows),
        "native_ms": sum(r["native_ms"] for r in rows),
        f"plain_ms_on_{device}": sum(r[f"plain_ms_on_{device}"] for r in rows),
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=0),
    }


def run_stateful_phase(device: str = "cuda", n_pods: int = N_STATEFUL, n_nodes: int = N_NODES,
                       n_replicas: int = N_REPLICAS, n_types=(N_ANTI_TYPES, N_TYPES)) -> tuple:
    """Phase 10: config 13 ``stateful_dense`` (its nodes in the solver's
    units) and ``spread_skew`` as the bench builds them, then the
    stateful cluster → their three lines (also emitted); fails on any
    check. The CPU solve gets its own copy of the pods, made before the
    card's solves pin their claims' zones."""
    import copy

    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    rows = []
    for name, world, args in (
        ("stateful_dense", stateful_dense_world, (n_pods, n_types[0])),
        ("spread_skew", spread_skew_world, (n_pods, n_types[0])),
        ("stateful_cluster", stateful_cluster_world, (n_pods, n_types[1], n_nodes, n_replicas)),
    ):
        t0 = time.perf_counter()
        pools, provider, pods, nodes, daemons, missing, kube = world(*args)
        cpu_pods = copy.deepcopy(pods)
        world_s = time.perf_counter() - t0
        kw = dict(state_nodes=nodes, daemonset_pods=daemons)
        solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
        cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
        if device == "cuda" and launches < 4 * len(pools):
            fail(f"{name} launched the compat kernel {launches} times in 4 solves")
        cpu_solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
        cpu, calls = capture_pack_existing(lambda: cpu_solver.solve(cpu_pods, **kw), calls=None)
        same_as_cpu(cold, cpu, name)
        row = {
            name: (
                f"{len(pods)} pods x {len(provider.instance_types)} types"
                + (f" x {len(nodes)} existing nodes" if nodes else ", no existing nodes")
                + f", {len(pools)} nodepools, kube store"
            ),
            "world_build_s": world_s,
            **timing_row(cold, cold_ms, warm_runs, launches),
        }
        if nodes:
            row.update(check_cluster(cold, pods, nodes, daemons, missing, spill=False, pools=pools))
            if solver._existing_ctx is not None:
                row["pack_existing"] = stateful_pack_check(calls, solver._existing_ctx["axis"].count, device)
        else:
            check_invariants(cold, pods)
        if name == "spread_skew":
            row["spread"] = check_spread(cold, pods, nodes, provider, kube)
        else:
            row["ports"] = check_ports(cold, pods, nodes)
            row["volumes"] = check_volumes(cold, pods, nodes, kube)
            row["zone_pins"] = check_zone_pins(cold, pods, kube)
        if device == "cuda":
            row.update(profile_solve(solver, pods, **kw))
        emit(row)
        rows.append(row)
    return tuple(rows)


# -- phase 11: the greedy oracle, the oracle fallback and preference relaxation --


def config1_world(n_pods: int = N_CONFIG1):
    """bench.py config 1 (``bench.py:388-419``): ``n_pods`` uniform
    500m / 512Mi pods, ``instance_types(10)``, one NodePool ``default``
    → ([nodepool], provider, pods)."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(10)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    return [nodepool], provider, [pending_pod(f"bench-{i}", "500m", "512Mi") for i in range(n_pods)]


def soft_anti_affinity(selector: dict):
    """Bitnami's ``common.affinities.pods.soft`` (``podAntiAffinityPreset:
    soft``): one preferred term of weight 1 on ``kubernetes.io/hostname``
    whose selector is ``selector``."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        LabelSelector,
        PodAffinityTerm,
        PodAntiAffinity,
        WeightedPodAffinityTerm,
    )

    term = PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME, label_selector=LabelSelector(match_labels=dict(selector)))
    return Affinity(pod_anti_affinity=PodAntiAffinity(preferred=[WeightedPodAffinityTerm(1, term)]))


def release_pods(n_releases: int = N_RELEASES, replicas: int = N_RELEASE_REPLICAS, seed: int = RELEASE_SEED) -> list:
    """Helm releases with Bitnami's default soft pod anti-affinity:

    - ``n_releases`` releases ``{chart}-{k}`` of ``replicas`` replicas,
      labels ``app.kubernetes.io/name``, ``/instance`` and ``/component``,
      the selector all three (one replica per node while it holds), the
      requests drawn per release from RandomState(``seed``);
    - two ``postgresql`` releases whose selector leaves out ``component``:
      a primary (1 replica, 1 CPU / 2Gi) and 20 read replicas (500m /
      1Gi), so each selector matches two groups of the batch.
    """
    rng = np.random.RandomState(seed)
    pods = []
    for k in range(n_releases):
        chart = RELEASE_CHARTS[k % len(RELEASE_CHARTS)]
        labels = {
            "app.kubernetes.io/name": chart,
            "app.kubernetes.io/instance": f"{chart}-{k}",
            "app.kubernetes.io/component": "server",
        }
        cpu = ["250m", "500m", "1", "2"][rng.randint(4)]
        mem = ["256Mi", "1Gi", "2Gi", "4Gi"][rng.randint(4)]
        for j in range(replicas):
            p = pending_pod(f"{chart}-{k}-server-{j}", cpu, mem, labels=labels)
            p.spec.affinity = soft_anti_affinity(labels)
            pods.append(p)
    for k in range(2):
        base = {"app.kubernetes.io/name": "postgresql", "app.kubernetes.io/instance": f"pg-{k}"}
        for component, n, cpu, mem in (("primary", 1, "1", "2Gi"), ("read", 20, "500m", "1Gi")):
            for j in range(n):
                p = pending_pod(
                    f"pg-{k}-{component}-{j}", cpu, mem,
                    labels={**base, "app.kubernetes.io/component": component},
                )
                p.spec.affinity = soft_anti_affinity(base)
                pods.append(p)
    return pods


def oracle_mix_world(n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES, n_releases: int = N_RELEASES):
    """Bench config 6 whole (``config6_world``) and ``release_pods`` →
    ([nodepool], provider, pods, [], [], {}, None): the release pods go
    to the greedy fallback, config 6's to the tensor path."""
    pools, provider, pods = config6_world(n_pods, n_types)
    return pools, provider, pods + release_pods(n_releases), [], [], {}, None


def oracle_cluster_world(
    n_pods: int = N_CONFIG6, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_releases: int = N_RELEASES
):
    """``oracle_mix_world``'s pods against phase 5's cluster in a kube
    store (``_cluster_world``: pools ``reserved`` and ``default``, the
    ``instance_types(n_types)`` catalog, ``n_nodes`` nodes with their
    bound pods, three daemonsets) → (nodepools, provider, pods,
    state_nodes, daemonset_pods, missing, kube)."""
    pools, provider, _, nodes, daemons, missing, kube = _cluster_world(0, n_types, n_nodes, store=True)
    pods = config6_world(n_pods, 1)[2] + release_pods(n_releases)
    return pools, provider, pods, nodes, daemons, missing, kube


def relax_cluster_world(n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES):
    """Phase 5's world whole (``cluster_world``) under a capacity drought
    and with soft preferences → (nodepools, provider, pods, state_nodes,
    daemonset_pods, missing, None):

    - every offering in ``test-zone-3`` is unavailable, as bench config
      10's capacity-drought shape marks a zone (``bench.py:1495-1568``);
    - every 5th pod prefers ``test-zone-3`` (preferred node affinity,
      weight 100): existing nodes there may take it, a new node cannot;
    - every 20th pod also has a required node affinity of two terms, the
      first naming ``test-zone-4``, a zone no offering has, the second
      ``test-zone-1`` or ``test-zone-2``.
    """
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        NodeAffinity,
        NodeSelector,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        PreferredSchedulingTerm,
    )

    pools, provider, pods, nodes, daemons, missing = cluster_world(n_pods, n_types, n_nodes)
    for it in provider.instance_types:
        for o in it.offerings:
            if o.zone == DROUGHT_ZONE:
                o.available = False

    def zone_term(*zones):
        return NodeSelectorTerm(
            match_expressions=[NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, "In", list(zones))]
        )

    for i, p in enumerate(pods):
        if i % 5:
            continue
        na = NodeAffinity(preferred=[PreferredSchedulingTerm(weight=100, preference=zone_term(DROUGHT_ZONE))])
        if i % 20 == 0:
            na.required = NodeSelector(
                node_selector_terms=[zone_term("test-zone-4"), zone_term("test-zone-1", "test-zone-2")]
            )
        p.spec.affinity = Affinity(node_affinity=na)
    return pools, provider, pods, nodes, daemons, missing, None


def greedy_stream(results, pods) -> dict:
    """A greedy ``Results`` by content: claims (nodepool, pod indices,
    instance-type options), existing nodes' pods, errors by pod index."""
    index = {p.uid: i for i, p in enumerate(pods)}
    return dict(
        claims=[
            (c.nodepool_name, [index[p.uid] for p in c.pods], [it.name for it in c.instance_type_options])
            for c in results.new_node_claims
        ],
        existing=[(e.name(), [index[p.uid] for p in e.pods]) for e in results.existing_nodes if e.pods],
        errors={index[uid]: err for uid, err in results.pod_errors.items()},
    )


def same_oracle_as_cpu(res, pods, cpu, cpu_pods, what: str) -> None:
    mine = greedy_stream(res.oracle_results, pods) if res.oracle_results is not None else None
    theirs = greedy_stream(cpu.oracle_results, cpu_pods) if cpu.oracle_results is not None else None
    if mine != theirs:
        fail(f"{what}: the greedy fallback's claims differ between cuda and cpu")


def oracle_placements(res, pods) -> dict:
    """pod index → node key of every greedy-fallback placement: existing
    nodes ``("existing", name)``, claims ``("claim", ordinal)``."""
    where = {}
    if res.oracle_results is None:
        return where
    index = {p.uid: i for i, p in enumerate(pods)}
    for n, c in enumerate(res.oracle_results.new_node_claims):
        for p in c.pods:
            where[index[p.uid]] = ("claim", n)
    for e in res.oracle_results.existing_nodes:
        for p in e.pods:
            where[index[p.uid]] = ("existing", e.name())
    return where


def check_oracle(res, pods, n_release_pods: int, route: dict) -> dict:
    """Fail unless the greedy fallback took exactly the release pods
    (``route``: the solve's ``last_route_stats``), every release pod that
    kept its soft anti-affinity shares no node with another pod its
    selector matches (placements of the tensor path and of the fallback
    both), and every claim's requests fit its cheapest option."""
    from karpenter_core_tpu_torch.cloudprovider.types import order_by_price
    from karpenter_core_tpu_torch.scheduling import resources

    if route["oracle"] != n_release_pods or res.oracle_results is None:
        fail(f"{route['oracle']} pods went to the greedy fallback, not the {n_release_pods} release pods")
    where = {i: node for i, (_, node) in placements(res).items()}
    where.update(oracle_placements(res, pods))
    by_node = {}
    for i, node in where.items():
        by_node.setdefault(node, []).append(i)
    kept = relaxed = 0
    for i, p in enumerate(pods):
        if "app.kubernetes.io/instance" not in p.metadata.labels:
            continue
        a = p.spec.affinity
        if a is None or a.pod_anti_affinity is None or not a.pod_anti_affinity.preferred:
            relaxed += 1
            continue
        kept += 1
        if i not in where:
            continue
        sel = a.pod_anti_affinity.preferred[0].pod_affinity_term.label_selector
        for j in by_node[where[i]]:
            if j != i and sel.matches(pods[j].metadata.labels):
                fail(f"release pod {p.name} shares {where[i]} with {pods[j].name}, which its soft anti-affinity matches")
    claims = res.oracle_results.new_node_claims
    for c in claims:
        cheapest = order_by_price(c.instance_type_options, c.requirements)[0]
        if not resources.fits(c.requests, cheapest.allocatable()):
            fail(f"a greedy claim's requests overflow its cheapest option {cheapest.name}")
    return {
        "oracle_pods": route["oracle"], "oracle_share": route["oracle_share"],
        "oracle_claims": len(claims),
        "oracle_on_existing": sum(len(e.pods) for e in res.oracle_results.existing_nodes),
        "soft_kept": kept, "soft_relaxed": relaxed,
    }


def first_fit(res, pods) -> list:
    """Pods without a topology spread or pod affinity that the solve put
    on existing nodes: the existing-node first-fit places them before any
    spread group gets its zones."""
    return [
        i
        for i, (_, node) in placements(res).items()
        if node[0] == "existing"
        and not pods[i].spec.topology_spread_constraints
        and not (pods[i].spec.affinity is not None and pods[i].spec.affinity.pod_affinity is not None)
    ]


def run_config1_phase(n_pods: int = N_CONFIG1) -> dict:
    """Phase 11, config1: bench config 1 through the port's greedy
    scheduler, as the bench runs it (a warm build and solve, then a fresh
    build and the timed solve); its claims must equal those of a solve of
    the same world built afresh. Host only: no kernel runs."""
    from karpenter_core_tpu_torch.scheduler.builder import build_scheduler

    pools, provider, pods = config1_world(n_pods)
    build_scheduler(None, None, pools, provider, pods).solve(pods)
    sched = build_scheduler(None, None, pools, provider, pods)
    t0 = time.perf_counter()
    res = sched.solve(pods)
    dt = time.perf_counter() - t0
    pools2, provider2, pods2 = config1_world(n_pods)
    again = build_scheduler(None, None, pools2, provider2, pods2).solve(pods2)
    if greedy_stream(res, pods) != greedy_stream(again, pods2):
        fail("config1: the greedy scheduler's claims differ between two builds of the world")
    if res.pod_errors:
        fail(f"config1: {len(res.pod_errors)} pods failed")
    per_node = np.asarray([len(c.pods) for c in res.new_node_claims] or [0], dtype=np.float64)
    row = {
        "config1": f"{n_pods} uniform 500m/512Mi pods x 10 types (bench config 1), the greedy scheduler "
                   "on the host: nothing of this runs on the card",
        "pods_per_s": sum(len(c.pods) for c in res.new_node_claims) / dt,
        "solve_ms": dt * 1000.0,
        "nodes": len(res.new_node_claims),
        "pods_per_node_min": int(per_node.min()), "pods_per_node_max": int(per_node.max()),
        "pods_per_node_mean": float(per_node.mean()), "pods_per_node_stddev": float(per_node.std()),
    }
    emit(row)
    return row


def run_oracle_phase(device: str = "cuda", n_pods: int = N_CONFIG6, n_nodes: int = N_NODES,
                     n_releases: int = N_RELEASES, n_types=(N_CONFIG6_TYPES, N_TYPES)) -> tuple:
    """Phase 11, oracle-mix and oracle-cluster: bench config 6 and the
    Helm releases, as built and against phase 5's cluster → their two
    lines (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    rows = []
    for name, world, args in (
        ("oracle_mix", oracle_mix_world, (n_pods, n_types[0], n_releases)),
        ("oracle_cluster", oracle_cluster_world, (n_pods, n_types[1], n_nodes, n_releases)),
    ):
        t0 = time.perf_counter()
        pools, provider, pods, nodes, daemons, missing, kube = world(*args)
        world_s = time.perf_counter() - t0
        n_release = len(pods) - n_pods
        # the CPU solve's own copy, taken before any solve (the greedy
        # scheduler relaxes the pods it is given in place)
        cpu_pods = copy.deepcopy(pods)
        kw = dict(state_nodes=nodes, daemonset_pods=daemons)
        solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
        cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
        if device == "cuda" and launches < 4 * len(pools):
            fail(f"{name} launched the compat kernel {launches} times in 4 solves")
        route = dict(solver.last_route_stats)
        cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(cpu_pods, **kw)
        same_as_cpu(cold, cpu, name)
        same_oracle_as_cpu(cold, pods, cpu, cpu_pods, name)
        if not nodes:
            check_invariants(cold, pods)
        row = {
            name: (
                f"{len(pods)} pods ({n_pods} bench config 6 + {n_release} Helm release pods with "
                f"Bitnami's soft anti-affinity) x {len(provider.instance_types)} types"
                + (f" x {len(nodes)} existing nodes, kube store seeds" if nodes else ", no existing nodes")
            ),
            "world_build_s": world_s,
            **timing_row(cold, cold_ms, warm_runs, launches),
            **(check_cluster(cold, pods, nodes, daemons, missing, spill=False) if nodes else {}),
            "oracle": check_oracle(cold, pods, n_release, route),
            "affinity": check_affinity(cold, pods, kube),
            "spread": check_spread_serial(cold, pods, provider, first=first_fit(cold, pods)),
            **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
        }
        emit(row)
        rows.append(row)
    return tuple(rows)


def run_relax_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                    n_nodes: int = N_NODES) -> dict:
    """Phase 11, relax-cluster: ``relax_cluster_world`` → its line (also
    emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing, _ = relax_cluster_world(n_pods, n_types, n_nodes)
    world_s = time.perf_counter() - t0
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
    relax = dict(solver.last_relax_stats)
    if solver.last_route_stats["oracle"]:
        fail(f"relax-cluster sent {solver.last_route_stats['oracle']} pods to the greedy fallback")
    if relax["rounds"] == 0 or relax["pods_placed"] == 0:
        fail(f"relax-cluster: the relaxation placed no pod ({relax})")
    if device == "cuda" and launches < 4 * len(pools) * 2:
        fail(f"relax-cluster launched the compat kernel {launches} times in 4 solves")
    if cold.pod_errors:
        fail(f"relax-cluster: {len(cold.pod_errors)} pods failed")
    if any(p.zone == DROUGHT_ZONE for p in cold.node_plans):
        fail(f"relax-cluster opened a node in {DROUGHT_ZONE}, whose offerings are all unavailable")
    cpu = TorchScheduler(pools, provider, device="cpu").solve(pods, **kw)
    same_as_cpu(cold, cpu, "relax-cluster")
    where = placements(cold)
    row = {
        "relax_cluster": (
            f"{n_pods} pods x {n_types} types x {n_nodes} existing nodes (phase 5's world), every "
            f"{DROUGHT_ZONE} offering unavailable, every 5th pod preferring it, every 20th with a "
            "two-term required zone affinity whose first term no offering meets"
        ),
        "world_build_s": world_s,
        **timing_row(cold, cold_ms, warm_runs, launches),
        **check_cluster(cold, pods, nodes, daemons, missing),
        "relax_rounds": relax["rounds"],
        "relax_pods_retried": relax["pods_retried"],
        "relax_pods_placed": relax["pods_placed"],
        "preferring_pods_in_drought_zone": sum(
            1 for i in range(0, len(pods), 5) if where[i][0] == DROUGHT_ZONE
        ),
        "launches_per_solve": launches / 4,
        **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
    }
    emit(row)
    return row


def packing_parity(pods, provider, nodepool, device: str, subsample: Optional[int] = None) -> dict:
    """``packing_parity_vs_oracle`` as ``bench.py:214-243`` computes it,
    the port alone: the port's greedy scheduler against ``TorchScheduler``
    on ``device`` over the same (stratified every-k-th) pods, with the
    batched solve's kernel launches counted from 0."""
    from karpenter_core_tpu_torch.scheduler.builder import build_scheduler
    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    sel = pods
    if subsample is not None and subsample < len(pods):
        step = len(pods) / float(subsample)
        sel = [pods[int(i * step)] for i in range(subsample)]
    t0 = time.perf_counter()
    oracle = build_scheduler(None, None, [nodepool], provider, sel).solve(sel)
    oracle_ms = (time.perf_counter() - t0) * 1000.0
    o_nodes = len(oracle.new_node_claims)
    o_sched = sum(len(c.pods) for c in oracle.new_node_claims)
    ck.COMPAT_ALLOWED.launches = 0
    t0 = time.perf_counter()
    batched = TorchScheduler([nodepool], provider, device=device).solve(sel)
    batched_ms = (time.perf_counter() - t0) * 1000.0
    launches = ck.COMPAT_ALLOWED.launches
    if device == "cuda" and launches == 0:
        fail("the parity solve never launched the compat kernel")
    if batched.pods_scheduled < o_sched:
        parity = 0.0  # scheduling fewer pods is a failure, not "fewer nodes"
    elif batched.node_count <= o_nodes:
        parity = 1.0  # one-sided: "not worse than the oracle"
    else:
        parity = o_nodes / batched.node_count
    return {
        "packing_parity_vs_oracle": round(parity, 4),
        "parity_oracle_nodes": o_nodes,
        "parity_batched_nodes": batched.node_count,
        "parity_oracle_pods": o_sched,
        "parity_batched_pods": batched.pods_scheduled,
        "parity_pods": len(sel),
        "oracle_solve_ms": oracle_ms,
        "batched_cold_solve_ms": batched_ms,
        "kernel_launches": launches,
    }


def run_parity_phase(device: str = "cuda", n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES,
                     subsample: int = N_PARITY, n_config1: int = N_CONFIG1) -> tuple:
    """Phase 11, parity: ``packing_parity_vs_oracle`` on config 6's
    stratified subsample and on config 1 → their two lines."""
    rows = []
    pools, provider, pods = config6_world(n_pods, n_types)
    rows.append({
        "parity_config6": f"bench config 6's stratified {subsample}-pod subsample (bench.py:759) x {n_types} types",
        **packing_parity(pods, provider, pools[0], device, subsample),
    })
    pools, provider, pods = config1_world(n_config1)
    rows.append({
        "parity_config1": f"bench config 1, {n_config1} pods x 10 types",
        **packing_parity(pods, provider, pools[0], device),
    })
    for row in rows:
        emit(row)
    return tuple(rows)


# -- phase 12: the pack engines (device scans and the LP backend) --------------

N_CONFIG5 = 10_000  # bench.py config 5: pods, types, six zones, RandomState(3)
N_CONFIG5_TYPES = 2_000
# bench config 10 (bench.py:1463-1660), $/hr per shape under ffd and lp as
# the JAX package gives them: bench.py's config10() run on the JAX
# package on a CPU host (JAX_PLATFORMS=cpu, default knobs, its native
# packer), the run tests/test_torch_lp.py repeats against these values
CONFIG10_REFERENCE = {
    "bignode-trap": (100.0, 68.8),
    "midsize-sweetspot": (74.6, 50.6),
    "podcap-trap": (25.6, 17.6),
    "hetero-split": (99.0, 59.8),
    "hetero-split-narrow": (82.0, 82.0),
    "hetero-split-wide": (150.0, 30.9),
    "spot-cliff-steep": (104.0, 35.7),
    "spot-cliff-shallow": (33.8, 33.02),
    "capacity-drought": (54.7, 44.8),
    "superlinear-ladder": (88.0, 54.4),
    "linear-control": (128.1026, 128.1026),
}
CONFIG10_SAVING_PCT = 41.2  # adversarial shapes, 811.7 -> 477.62 $/hr
# bench config 5 whole under ffd, lp and auto (nodes, $/hr): bench.py's
# config 5 world solved by the JAX package on a CPU host under each backend
CONFIG5_REFERENCE = (164, 873.4703)


def config10_shapes() -> list:
    """bench.py config 10's eleven price shapes (``_price_shapes``) from
    the port's classes: (name, catalog, pods), pods named as
    ``_mk_pod`` names them."""
    from karpenter_core_tpu_torch.cloudprovider.fake import instance_types, new_instance_type
    from karpenter_core_tpu_torch.cloudprovider.types import Offering

    def it(name, cpu, mem_gi, pods, price, available=True):
        return new_instance_type(
            name,
            {"cpu": str(cpu), "memory": f"{mem_gi}Gi", "pods": str(pods)},
            offerings=[
                Offering("on-demand", "test-zone-1", price, available),
                Offering("on-demand", "test-zone-2", price, available),
            ],
        )

    def mk(name, cpu, mem):
        return pending_pod(f"bench-{name}", cpu, mem)

    rng = np.random.RandomState(17)
    shapes = [
        ("bignode-trap", [it("huge", 64, 128, 110, 20.0), it("small", 4, 8, 110, 0.8)],
         [mk(f"big-{i}", "1", "2Gi") for i in range(256)]),
        ("midsize-sweetspot",
         [it("xl", 96, 192, 220, 14.0), it("m", 48, 96, 110, 4.6), it("s", 8, 16, 110, 1.1)],
         [mk(f"mid-{i}", "2", "3Gi") for i in range(240)]),
        ("podcap-trap", [it("dense", 16, 32, 32, 3.2), it("lean", 16, 32, 8, 0.55)],
         [mk(f"cap-{i}", "100m", "128Mi") for i in range(256)]),
    ]

    def hetero(tag, gen_price, cpu_price, mem_price):
        cat = [it(f"general-{tag}", 32, 64, 110, gen_price), it(f"cpuopt-{tag}", 32, 8, 110, cpu_price),
               it(f"memopt-{tag}", 4, 64, 110, mem_price)]
        pods = [mk(f"cpuh-{tag}-{i}", "3", "256Mi") for i in range(96)] + [
            mk(f"memh-{tag}-{i}", "100m", "4Gi") for i in range(96)
        ]
        return cat, pods

    shapes.append(("hetero-split", *hetero("mid", 9.9, 3.6, 3.4)))
    shapes.append(("hetero-split-narrow", *hetero("nar", 8.2, 6.9, 6.7)))
    shapes.append(("hetero-split-wide", *hetero("wide", 15.0, 1.9, 1.7)))
    cliff = [it("cliff-s", 4, 8, 110, 0.6), it("cliff-m", 8, 16, 110, 1.3), it("cliff-l", 16, 32, 110, 8.0)]
    shapes.append(("spot-cliff-steep", cliff, [mk(f"spot-{i}", "1", "2Gi") for i in range(192)]))
    shallow = [it("shal-s", 4, 8, 110, 0.62), it("shal-m", 8, 16, 110, 1.2), it("shal-l", 16, 32, 110, 2.6)]
    shapes.append(("spot-cliff-shallow", shallow, [mk(f"shal-{i}", "1", "2Gi") for i in range(192)]))
    drought = [
        it("dry-s", 4, 8, 110, 0.7),
        it("dry-m1", 8, 16, 110, 1.3, available=False),
        it("dry-m2", 16, 32, 110, 2.5, available=False),
        it("dry-l", 64, 128, 110, 18.0),
    ]
    shapes.append(("capacity-drought", drought, [mk(f"dry-{i}", "1", "2Gi") for i in range(192)]))
    ladder = [it("lad-4", 4, 8, 110, 0.8), it("lad-8", 8, 16, 110, 1.7), it("lad-16", 16, 32, 110, 3.8),
              it("lad-32", 32, 64, 110, 9.0), it("lad-64", 64, 128, 110, 22.0)]
    shapes.append(("superlinear-ladder", ladder, [mk(f"lad-{i}", "1", "2Gi") for i in range(224)]))
    lin = [
        mk(f"lin-{i}", ["250m", "500m", "1", "2"][rng.randint(4)], ["512Mi", "1Gi", "2Gi"][rng.randint(3)])
        for i in range(400)
    ]
    shapes.append(("linear-control", instance_types(20), lin))
    return shapes


def config5_world(n_pods: int = N_CONFIG5, n_types: int = N_CONFIG5_TYPES):
    """bench.py config 5 (``config5``, :617-671): spot-weighted packing,
    2,000 types x 6 zones with on-demand and spot offerings drawn from
    RandomState(3), 10,000 pods → (nodepool, provider, pods)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import (
        FakeCloudProvider,
        new_instance_type,
        price_from_resources,
    )
    from karpenter_core_tpu_torch.cloudprovider.types import Offering
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(3)
    zones = [f"test-zone-{z}" for z in range(1, 7)]
    cat = []
    for i in range(n_types):
        cpu, mem = (i % 64) + 1, 2 * ((i % 64) + 1)
        res = {"cpu": str(cpu), "memory": f"{mem}Gi", "pods": str(max(110, cpu * 8))}
        base = price_from_resources({k: parse_quantity(v) for k, v in res.items()})
        offerings = []
        for z in zones:
            od = base * (1.0 + 0.05 * rng.rand())
            spot = od * (0.25 + 0.5 * rng.rand())
            offerings.append(Offering(wk.CAPACITY_TYPE_ON_DEMAND, z, od))
            offerings.append(Offering(wk.CAPACITY_TYPE_SPOT, z, spot))
        cat.append(new_instance_type(f"fake-it-{i}", res, offerings=offerings))
    provider = FakeCloudProvider()
    provider.instance_types = cat
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(n_pods):
        cpu = ["250m", "500m", "1", "2"][rng.randint(4)]
        mem = ["512Mi", "1Gi", "2Gi"][rng.randint(3)]
        pods.append(pending_pod(f"bench-{i}", cpu, mem))
    return nodepool, provider, pods


def plan_sha256(res) -> str:
    """Digest of the ordered plan stream (the ROADMAP's plan identity)."""
    return hashlib.sha256(json.dumps(plan_stream(res)).encode()).hexdigest()


def pack_kernels() -> dict:
    """The pack engines' kernel wrappers, by kernel name."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver.backends import lp

    return {"ffd_pack": pack.FFD_PACK, "pack_existing": pack.PACK_EXISTING, "dual_ascent": lp.DUAL_ASCENT}


def reset_pack_launches() -> None:
    for k in pack_kernels().values():
        k.launches = 0


def pack_launches() -> dict:
    return {name: k.launches for name, k in pack_kernels().items()}


class knobs:
    """Environment knobs set for a block, restored after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class capture:
    """Record (on the CPU) the tensor arguments of every call of
    ``module.attr`` inside the block, up to ``limit`` calls."""

    def __init__(self, module, attr: str, limit: int = 1 << 30):
        self.module, self.attr, self.limit, self.calls = module, attr, limit, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.attr)

        def spy(*args):
            if len(self.calls) < self.limit:
                self.calls.append(tuple(a.detach().cpu().clone() if hasattr(a, "detach") else a for a in args))
            return real(*args)

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


class capture_kw:
    """Record the arguments of the first ``limit`` calls of
    ``module.attr`` inside the block as keyword dicts (numpy arrays
    copied; ``device`` left out)."""

    def __init__(self, module, attr: str, limit: int = 1):
        self.module, self.attr, self.limit, self.calls = module, attr, limit, []

    def __enter__(self):
        import inspect

        real = self.real = getattr(self.module, self.attr)
        sig = inspect.signature(real)

        def spy(*args, **kw):
            if len(self.calls) < self.limit:
                bound = sig.bind(*args, **kw).arguments
                self.calls.append({k: (np.array(v) if isinstance(v, np.ndarray) else v)
                                   for k, v in bound.items() if k != "device"})
            return real(*args, **kw)

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


class timed:
    """Sum the wall time of every call of ``module.attr`` inside the block
    (a device function's callers sync on its result, so this is its
    share of the solve)."""

    def __init__(self, module, attr: str):
        self.module, self.attr, self.ms, self.n = module, attr, 0.0, 0

    def __enter__(self):
        real = self.real = getattr(self.module, self.attr)

        def spy(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                self.ms += (time.perf_counter() - t0) * 1000.0
                self.n += 1

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


def config10_rows(device: str, profile: bool = False) -> list:
    """bench config 10 on ``device``: each shape solved under ffd and lp
    (a cold solve, the scheduler fresh and the relax memo empty, then a
    warm one) → one row per shape: $/hr, nodes, pods, plan digest, cold
    and warm ms of both, the cold lp solve's pack stats, pack and relax
    ms and dual-ascent launches, and the relaxation lower bound of the lp
    plan; with ``profile`` a profiled cold lp solve too (the idle share)."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, plancost
    from karpenter_core_tpu_torch.solver.backends import lp

    rows = []
    for name, catalog, pods in config10_shapes():
        row = {"shape": name, "pods": len(pods), "types": len(catalog)}
        for bk in ("ffd", "lp"):
            backends.reset_for_tests()
            provider = FakeCloudProvider()
            provider.instance_types = list(catalog)
            pool = NodePool()
            pool.metadata.name = "default"
            solver = TorchScheduler([pool], provider, device=device)
            before = lp.DUAL_ASCENT.launches
            with knobs(KARPENTER_TORCH_PACK_BACKEND=bk):
                with timed(lp, "relax") as relax:
                    t0 = time.perf_counter()
                    res = solver.solve(pods)
                    solve_ms = (time.perf_counter() - t0) * 1000.0
                if bk == "lp":
                    row["dual_ascent_launches"] = lp.DUAL_ASCENT.launches - before
                    row["relax_ms"] = relax.ms
                    row["relax_share"] = relax.ms / solve_ms
                    row["pack_ms"] = solver.last_timings["pack_ms"]
                    row["stats"] = dict(solver.last_pack_stats)
                t0 = time.perf_counter()
                solver.solve(pods)  # warm: the relax memo hits, no dual ascent
                row[f"{bk}_warm_ms"] = (time.perf_counter() - t0) * 1000.0
                if profile and bk == "lp":
                    # a cold lp solve under the profiler: its relaxations run again
                    backends.reset_for_tests()
                    row["lp_cold_profile"] = profile_solve(solver, pods)
            row[bk] = round(res.total_price, 4)
            row[f"{bk}_nodes"] = res.node_count
            row[f"{bk}_pods"] = res.pods_scheduled
            row[f"{bk}_sha"] = plan_sha256(res)
            row[f"{bk}_ms"] = solve_ms
            if bk == "lp":
                row["bound"] = plancost.relaxation_lower_bound(res.node_plans, catalog, device=device)
        rows.append(row)
    return rows


def check_config10(rows) -> dict:
    """The JAX package's $/hr per shape and backend, lp <= ffd, bound <=
    cost, the same pods scheduled under both, and the adversarial
    saving."""
    for r in rows:
        want = CONFIG10_REFERENCE[r["shape"]]
        if (r["ffd"], r["lp"]) != want:
            fail(f"config10 {r['shape']}: $/hr {(r['ffd'], r['lp'])}, the JAX package gives {want}")
        if r["lp"] > r["ffd"] + 1e-6:
            fail(f"config10 {r['shape']}: lp {r['lp']} prices above ffd {r['ffd']}")
        if r["bound"] > r["lp"] + 1e-6:
            fail(f"config10 {r['shape']}: bound {r['bound']} above the lp plan's {r['lp']}")
        if r["lp_pods"] != r["ffd_pods"]:
            fail(f"config10 {r['shape']}: lp schedules {r['lp_pods']} pods, ffd {r['ffd_pods']}")
    adv = [r for r in rows if r["shape"] != "linear-control"]
    ffd, lp = sum(r["ffd"] for r in adv), sum(r["lp"] for r in adv)
    saving = round((ffd - lp) / ffd * 100.0, 1)
    if saving != CONFIG10_SAVING_PCT:
        fail(f"config10: adversarial saving {saving} %, the JAX package's is {CONFIG10_SAVING_PCT} %")
    return {"adversarial_ffd": round(ffd, 4), "adversarial_lp": round(lp, 4), "saving_pct": saving}


def events_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back calls of ``fn`` queued
    behind a device sleep (host enqueue hidden) → ms per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(DEVICE_SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_row(bytes_moved: float, ops: float) -> dict:
    b, o = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations", "bytes": bytes_moved, "ops": ops}


def ffd_kernel_case(call, reps: int = 3) -> dict:
    """The FFD scan kernel against its plain version on the card, on one
    captured call (requests, frontiers, caps, k_open, n_pods), bit for
    bit, with both times and the bound: each real pod's requests read
    once, the frontiers once, ids and counts written once; the fit tests
    the pods need, (K + 1) x F x R int32 compares each at most.
    ``step_us``: the kernel's time over the longest job's pods (the
    jobs run side by side)."""
    import torch

    from karpenter_core_tpu_torch.solver import pack

    req, front, caps, k_open, n = (a.cuda() if hasattr(a, "cuda") else a for a in call)
    G, P, R = req.shape
    F = front.shape[1]
    ids, counts = pack.ffd_pack_batched(req, front, caps, k_open, n)
    m = int(n.max())
    t0 = time.perf_counter()
    plain_ids, plain_counts = pack.ffd_pack_reference(req[:, :m], front, caps, k_open)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    plain_ids = torch.nn.functional.pad(plain_ids, (0, P - m), value=-1)
    if not (torch.equal(ids, plain_ids) and torch.equal(counts, plain_counts)):
        fail(f"ffd_pack kernel differs from its plain version at G={G} P={P} F={F} R={R}")
    pods = int(n.sum())
    kernel_ms = events_ms(lambda: pack.ffd_pack_batched(req, front, caps, k_open, n), reps)
    return {
        "G": G, "P": P, "F": F, "R": R, "pods": pods, "longest_job": m, "max_abs_err": 0,
        "kernel_ms": kernel_ms, "step_us": kernel_ms * 1000.0 / max(m, 1),
        "plain_ms": plain_ms,
        **bound_row(pods * R * 4 + G * F * R * 4 + pods * 4 + G * 8, pods * (k_open + 1) * F * R),
    }


def existing_kernel_case(call, reps: int = 3) -> dict:
    """The existing-node first-fit kernel against its plain version on
    the card, bit for bit; the bound counts the node checks this data
    needs (each pod walks the nodes up to the one it takes, all of them
    when it fits none, R compares each). ``step_us``: the kernel's time
    over the pods."""
    import torch

    from karpenter_core_tpu_torch.solver import pack

    req, sig, compat, free = (a.cuda() for a in call)
    P, R = req.shape
    S, M = compat.shape
    assign, free_out = pack.pack_existing(req, sig, compat, free)
    t0 = time.perf_counter()
    plain_assign, plain_free = pack.pack_existing_reference(req, sig, compat, free)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not (torch.equal(assign, plain_assign) and torch.equal(free_out, plain_free)):
        fail(f"pack_existing kernel differs from its plain version at P={P} M={M} R={R}")
    walked = torch.where(assign >= 0, assign + 1, torch.full_like(assign, M)).sum().item()
    kernel_ms = events_ms(lambda: pack.pack_existing(req, sig, compat, free), reps)
    return {
        "P": P, "M": M, "R": R, "S": S, "placed": int((assign >= 0).sum()), "max_abs_err": 0,
        "kernel_ms": kernel_ms, "step_us": kernel_ms * 1000.0 / max(P, 1),
        "plain_ms": plain_ms,
        **bound_row(P * (R + 1) * 4 + S * M + 2 * M * R * 4 + P * 4, walked * R),
    }


def synthetic_scan_calls(seed: int = 0) -> dict:
    """Scan calls at shapes a solve gives but phase 12's paths do not,
    from a seed, each (label, call): the stateful widths (cpu, memory and
    pods, then host-port columns holding 1 and CSI-driver volume columns
    holding 16, a pod asking for each with chance 0.05 and 0.3), which
    take B5's shared-memory rows and B6's wide register path, a width
    past what B5 prefetches (700 columns), and a cluster past 4,096 nodes,
    which takes B6's generic path."""
    import torch

    rng = np.random.RandomState(seed)

    def columns(shape, R, free_lo, free_hi):
        free = np.zeros(shape + (R,), np.int32)
        free[..., 0] = rng.randint(free_lo[0], free_hi[0], shape)
        free[..., 1] = rng.randint(free_lo[1], free_hi[1], shape)
        free[..., 2] = 110
        for r in range(3, R):
            free[..., r] = 1 if r % 2 else 16
        return free

    def pods(shape, R):
        req = np.zeros(shape + (R,), np.int32)
        req[..., 0] = rng.randint(100, 2000, shape)
        req[..., 1] = rng.randint(128, 4096, shape)
        req[..., 2] = 1
        for r in range(3, R):
            req[..., r] = rng.rand(*shape) < (0.05 if r % 2 else 0.3)
        return req

    def existing(P, M, R, S):
        compat = (rng.rand(S, M) < 0.7).astype(np.uint8) if S > 1 else np.ones((1, M), np.uint8)
        arrays = (pods((P,), R), rng.randint(0, S, P).astype(np.int32), compat,
                  columns((M,), R, (4000, 16000), (64000, 256000)))
        return tuple(torch.from_numpy(a) for a in arrays)

    def ffd_class(G, P, R):
        req = pods((G, P), R)
        req = req[np.arange(G)[:, None], np.argsort(-req[..., 0], axis=1, kind="stable")]
        return (torch.from_numpy(req), torch.from_numpy(columns((G, 3), R, (8000, 32000), (64000, 256000))),
                torch.full((G,), 110, dtype=torch.int32), 16, torch.full((G,), P, dtype=torch.int32))

    # drawn in this order, so each case keeps its data as cases are added
    width12 = ffd_class(4, 4096, 12)
    existing_calls = [("stateful width 12, 1,000 nodes", existing(10_000, 1000, 12, 1)),
                      ("5,000 nodes", existing(10_000, 5000, 3, 4))]
    # width 12 prefetches its requests and keeps the usage rows in shared
    # memory; width 700 reads its requests in place
    return {
        "ffd_pack": [("stateful width 12", width12), ("width 700, requests in place", ffd_class(4, 1024, 700))],
        "pack_existing": existing_calls,
    }


def dual_kernel_case(call, reps: int = 5) -> dict:
    """The dual-ascent kernel against its plain version on the card, bit
    for bit (t*, has_fit and w).
    The bound counts the work this data needs, not the padded shape's:
    the real signatures (count > 0), the valid types some real signature
    fits, and per iteration the routing over the pairs that fit (2R flops
    each), the projection and the update of those types (4R each) and the
    demand sums of the routed signatures (R each); the bytes read the real
    rows and the valid mask once (1 byte per type) and write the real rows
    of w, t* and has_fit once. ``iter_us``: the kernel's time over its
    iters + 1 routes."""
    import torch

    from karpenter_core_tpu_torch.solver.backends import lp

    torch.backends.cuda.matmul.allow_tf32 = False
    reqs, counts, alloc, prices, valid, w0, iters = (a.cuda() if hasattr(a, "cuda") else a for a in call)
    S, R = reqs.shape
    T = alloc.shape[0]
    plan = lp.dual_ascent_plan(S, T, R)
    w, t_star, has_fit = lp.dual_ascent(reqs, counts, alloc, prices, valid, w0, iters)
    t0 = time.perf_counter()
    pw, pt, ph = lp.dual_ascent_reference(reqs, counts, alloc, prices, valid, w0, iters)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not (torch.equal(t_star, pt) and torch.equal(has_fit, ph)):
        fail(f"dual_ascent kernel's routes differ from its plain version at S={S} T={T} R={R}")
    if not torch.equal(w, pw):
        fail(f"dual_ascent kernel's weights differ from its plain version at S={S} T={T} R={R} "
             f"(max {float((w - pw).abs().max())})")
    real = counts > 0
    fit = (reqs[:, None, :] <= alloc[None, :, :]).all(dim=-1) & valid[None, :] & real[:, None]
    s_real, t_valid = int(real.sum()), int(valid.sum())
    pairs, t_fit, s_routed = int(fit.sum()), int(fit.any(dim=0).sum()), int(fit.any(dim=1).sum())
    flops = (iters + 1) * (pairs * 2 * R + t_fit * 4 * R) + iters * (s_routed * R + t_fit * 4 * R)
    nbytes = s_real * (R + 1) * 4 + t_valid * (2 * R + 1) * 4 + T + t_valid * R * 4 + s_real * 5
    kernel_ms = events_ms(lambda: lp.dual_ascent(reqs, counts, alloc, prices, valid, w0, iters), reps)
    return {
        "S": S, "T": T, "R": R, "iters": iters, "s_real": s_real, "t_valid": t_valid, "pairs": pairs,
        "plan": plan,
        "max_abs_err": float((w - pw).abs().max()), "bit_equal": True,
        "kernel_ms": kernel_ms, "iter_us": kernel_ms * 1000.0 / (iters + 1),
        "plain_ms": plain_ms,
        **bound_row(nbytes, flops),
    }


def synthetic_dual_calls(seed: int = 0) -> list:
    """Dual-ascent calls at shapes no phase-12 path gives, from a seed,
    each (label, call), padded as ``lp.relax`` pads: a catalog past 2,048
    types (T = 4,096 × S = 64, R = 3) and a work area past shared memory
    (T = 2,048 × S = 64, R = 12, 40 iterations), which takes the
    device-memory layout."""
    import torch

    rng = np.random.RandomState(seed)

    def call(S, T, R, iters):
        s_real, t_real = S - S // 4, T - T // 40
        reqs = np.zeros((S, R), np.float32)
        reqs[:s_real] = rng.randint(1, 200, size=(s_real, R))
        counts = np.zeros(S, np.float32)
        counts[:s_real] = rng.randint(1, 50, size=s_real)
        alloc = np.zeros((T, R), np.float32)
        alloc[:t_real] = rng.randint(100, 4000, size=(t_real, R))
        prices = np.full(T, np.float32(1e12), np.float32)
        prices[:t_real] = rng.rand(t_real) * 10 + 0.5
        valid = np.arange(T) < t_real
        w0 = (1.0 / np.maximum(alloc, 1.0)).astype(np.float32)
        return tuple(torch.from_numpy(a) for a in (reqs, counts, alloc, prices, valid, w0)) + (iters,)

    return [("catalog of 4,096 types", call(64, 4096, 3, 160)),
            ("work area in device memory", call(64, 2048, 12, 40))]


def relax_split(call: dict, reps: int = 10) -> dict:
    """One captured ``lp.relax`` call (keyword arguments) on the card,
    split into its parts (pad, the six uploads, the kernel, the three
    downloads, the host's float64 bound), median ms over ``reps``, beside
    the whole call unsplit (no syncs between its parts)."""
    from karpenter_core_tpu_torch.solver.backends import lp

    parts: dict = {}
    for _ in range(reps + 1):
        got: dict = {}
        lp.relax(**call, device="cuda", timings=got)
        for k, v in got.items():
            parts.setdefault(k, []).append(v)
    t0 = time.perf_counter()
    for _ in range(reps):
        lp.relax(**call, device="cuda")
    out = {k: float(np.median(v[1:])) for k, v in parts.items()}
    out["relax_ms"] = (time.perf_counter() - t0) * 1000.0 / reps
    reqs, alloc = call["reqs"], call["alloc"]
    out.update({"S": int(reqs.shape[0]), "T": int(alloc.shape[0]), "iters": int(call["iters"])})
    return out


def device_engine_path(label: str, device: str, world, solve_kw: dict, cpu_world=None) -> tuple:
    """One device-engine path (KARPENTER_TORCH_NATIVE=0): cold and three
    warm solves on ``device`` with the pack kernels' launches counted from
    0, the kernels' captured inputs, the same world solved on the CPU
    through the plain scans (``cpu_world``: a smaller world when the
    plain scans would take too long) → (row, ffd calls, existing calls)."""
    from karpenter_core_tpu_torch.solver import TorchScheduler, pack

    pools, provider, pods = world[:3]
    with knobs(KARPENTER_TORCH_NATIVE=0):
        solver = TorchScheduler(pools, provider, device=device)
        with capture(pack, "ffd_pack_batched", 64) as ffd, capture(pack, "pack_existing", 64) as ex:
            reset_pack_launches()
            with timed(pack, "batch_pack") as scan:
                cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **solve_kw)
            kernels = pack_launches()
        # batch_pack syncs on its results: its wall time holds the scans
        row = {"path": label, **timing_row(cold, cold_ms, warm_runs, launches), "pack_kernel_launches": kernels,
               "batch_pack_ms_per_solve": scan.ms / 4}
        if device == "cuda":
            if kernels["ffd_pack"] == 0 or (solve_kw.get("state_nodes") and kernels["pack_existing"] == 0):
                fail(f"{label}: the device engine's solves launched {kernels}")
            row.update(profile_solve(solver, pods, **solve_kw))
        check = cpu_world or world
        cpu_pods = check[2]
        ref = TorchScheduler(check[0], check[1], device="cpu")
        t0 = time.perf_counter()
        cpu = ref.solve(cpu_pods, **check[3]) if cpu_world else ref.solve(pods, **solve_kw)
        row["cpu_solve_s"] = time.perf_counter() - t0
        if cpu_world is None:
            same_as_cpu(cold, cpu, label)
        else:
            res = TorchScheduler(check[0], check[1], device=device).solve(cpu_pods, **check[3])
            same_as_cpu(res, cpu, f"{label} at {len(cpu_pods)} pods")
            row["cpu_compare_pods"] = len(cpu_pods)
    return row, ffd.calls, ex.calls


def run_pack_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES,
                   cpu_pods: Optional[int] = None) -> dict:
    """Phase 12 → its rows and the kernel cases."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, calibrate
    from karpenter_core_tpu_torch.solver.backends import lp

    out: dict = {"paths": [], "launches": {}}
    # the device engine on config 3 whole and on phase 5's cluster
    small = None
    if cpu_pods is not None:
        pools, provider, pods = config3_world(cpu_pods, n_types)
        small = (pools, provider, pods, {})
    row, ffd_calls, _ = device_engine_path(
        "config3-device", device, config3_world(n_pods, n_types), {}, small
    )
    out["paths"].append(row)
    out["launches"]["config3-device"] = row["pack_kernel_launches"]
    cw = cluster_world(n_pods, n_types, n_nodes)
    small = None
    if cpu_pods is not None:
        sw = cluster_world(cpu_pods, n_types, n_nodes)
        small = (sw[0], sw[1], sw[2], dict(state_nodes=sw[3], daemonset_pods=sw[4]))
    row, cluster_ffd, ex_calls = device_engine_path(
        "cluster-device", device, cw, dict(state_nodes=cw[3], daemonset_pods=cw[4]), small
    )
    out["paths"].append(row)
    out["launches"]["cluster-device"] = row["pack_kernel_launches"]
    out["ffd_calls"], out["existing_calls"] = ffd_calls + cluster_ffd, ex_calls

    # the LP backend on bench config 10 whole: the card, then the CPU
    with capture(lp, "dual_ascent", 512) as duals, capture_kw(lp, "relax") as relax10:
        reset_pack_launches()
        rows = config10_rows(device, profile=device == "cuda")
        out["launches"]["config10"] = pack_launches()
    if device == "cuda":
        cpu_rows = config10_rows("cpu")
        for r, c in zip(rows, cpu_rows):
            if (r["ffd_sha"], r["lp_sha"]) != (c["ffd_sha"], c["lp_sha"]):
                fail(f"config10 {r['shape']}: the plans differ between cuda and cpu")
        for r in rows:
            if r["dual_ascent_launches"] == 0:
                fail(f"config10 {r['shape']}: the lp solve launched no dual ascent")
    out["config10"] = {"rows": rows, **check_config10(rows)}
    # config 10's repair packs through the device scan (lp, native off)
    with knobs(KARPENTER_TORCH_NATIVE=0):
        reset_pack_launches()
        dev_rows = config10_rows_device(device)
        out["launches"]["config10-device"] = pack_launches()
    out["config10_device"] = dev_rows

    # bench config 5 whole under ffd, lp and auto (threshold pinned), at size
    cal = calibrate.lp_calibration(device)
    emit({"lp_calibration": cal})
    nodepool, provider, pods = config5_world()
    c5 = {}
    with capture(lp, "dual_ascent", 8) as big_duals, capture_kw(lp, "relax") as relax5:
        for bk in ("ffd", "lp", "auto"):
            backends.reset_for_tests()
            with knobs(KARPENTER_TORCH_PACK_BACKEND=bk, KARPENTER_TORCH_LP_MIN_WORK=1), timed(lp, "relax") as relax:
                solver = TorchScheduler([nodepool], provider, device=device)
                reset_pack_launches()
                cold_stats = []
                real_solve = solver.solve

                def solve_and_keep_stats(*a, **kw):
                    res = real_solve(*a, **kw)
                    cold_stats.append(dict(solver.last_pack_stats))
                    return res

                solver.solve = solve_and_keep_stats
                cold, cold_ms, warm_runs, launches = solve_runs(solver, pods)
                solver.solve = real_solve
                kernels = pack_launches()
                row = {"path": f"config5-{bk}", **timing_row(cold, cold_ms, warm_runs, launches),
                       "pack_kernel_launches": kernels, "pack_stats": cold_stats[0],
                       "warm_ascent_iters": [st.get("ascent_iters", 0) for st in cold_stats[1:]],
                       "relax_ms_4_solves": relax.ms, "relax_share": relax.ms / (cold_ms + sum(m for m, _ in warm_runs)),
                       "plan_sha256": plan_sha256(cold)}
                if device == "cuda":
                    row.update(profile_solve(solver, pods))
            if (cold.node_count, round(cold.total_price, 4)) != CONFIG5_REFERENCE:
                fail(f"config5 {bk}: {cold.node_count} nodes at {cold.total_price}/hr, "
                     f"the JAX package gives {CONFIG5_REFERENCE}")
            if bk != "ffd":
                if kernels["dual_ascent"] == 0 and device == "cuda":
                    fail(f"config5 {bk}: no dual ascent launched")
                if row["pack_stats"].get("ffd_kept") != 1 or row["pack_stats"].get("lp_won") != 0:
                    fail(f"config5 {bk}: the cost guard did not keep FFD ({row['pack_stats']})")
            c5[bk] = cold
            out["paths"].append(row)
            out["launches"][f"config5-{bk}"] = kernels
    if len({plan_sha256(r) for r in c5.values()}) != 1:
        fail("config5: ffd, lp and auto give different plans")
    if device == "cuda":
        with knobs(KARPENTER_TORCH_PACK_BACKEND="lp"):
            backends.reset_for_tests()
            cpu = TorchScheduler([nodepool], provider, device="cpu").solve(pods)
        same_as_cpu(c5["lp"], cpu, "config5 lp")
    out["dual_calls"] = duals.calls + big_duals.calls
    out["relax_calls"] = {"config5": relax5.calls, "config10": relax10.calls}
    backends.reset_for_tests()
    return out


def config10_rows_device(device: str) -> list:
    """config 10 under lp with the native packer off: the FFD candidate
    and every repair pack (one-row frontiers) through the device scan; lp
    <= ffd's plan, and on the card the plans equal the CPU's."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends

    rows = []
    for name, catalog, pods in config10_shapes():
        got = {}
        for dev in (device, "cpu") if device == "cuda" else (device,):
            for bk in ("ffd", "lp"):
                backends.reset_for_tests()
                provider = FakeCloudProvider()
                provider.instance_types = list(catalog)
                pool = NodePool()
                pool.metadata.name = "default"
                with knobs(KARPENTER_TORCH_PACK_BACKEND=bk):
                    res = TorchScheduler([pool], provider, device=dev).solve(pods)
                got[(dev, bk)] = (plan_sha256(res), round(res.total_price, 4), res.pods_scheduled)
        if device == "cuda" and got[("cuda", "lp")] != got[("cpu", "lp")]:
            fail(f"config10 {name} on the device scan: the plans differ between cuda and cpu")
        if got[(device, "lp")][1] > got[(device, "ffd")][1] + 1e-6 or got[(device, "lp")][2] != got[(device, "ffd")][2]:
            fail(f"config10 {name} on the device scan: lp {got[(device, 'lp')]} against ffd {got[(device, 'ffd')]}")
        rows.append({"shape": name, "ffd": got[(device, "ffd")][1], "lp": got[(device, "lp")][1]})
    return rows


def distinct_shapes(calls) -> list:
    """The first captured call of each distinct argument shape (tensor
    shapes and scalar arguments), in capture order."""
    seen, out = set(), []
    for call in calls:
        key = tuple(tuple(a.shape) if hasattr(a, "shape") else a for a in call)
        if key not in seen:
            seen.add(key)
            out.append(call)
    return out


PACK_SOURCES = {
    "ffd_pack": ("karpenter_core_tpu_torch/csrc/ffd_pack.cu", "karpenter_core_tpu/solver/pack.py:80"),
    "pack_existing": ("karpenter_core_tpu_torch/csrc/pack_existing.cu", "karpenter_core_tpu/solver/pack.py:155"),
    "dual_ascent": ("karpenter_core_tpu_torch/csrc/dual_ascent.cu", "karpenter_core_tpu/solver/backends/lp.py:97"),
}


def pack_kernel_entry(name: str, rows: list, launches: dict, relax_rows: Optional[dict] = None) -> dict:
    """One pack kernel's entry of the kernels line: its launches on the
    phase-12 paths, and the numbers of its largest case (by kernel
    time), the other cases beside them; for B7 the ``lp.relax`` call
    around it (``wrapper_ms``: config 5's whole relax call, and each
    split)."""
    main = max((r for r in rows if "synthetic" not in r), key=lambda r: r["kernel_ms"])
    by_path = {path: counts[name] for path, counts in launches.items()}
    source, replaces = PACK_SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        # no one PyTorch call computes a sequential scan or an iterated ascent
        "library_ms": None,
        **({"step_us": main["step_us"]} if "step_us" in main else {}),
        **({"iter_us": main["iter_us"], "plan": main["plan"]} if "iter_us" in main else {}),
        **({"wrapper_ms": relax_rows["config5"]["relax_ms"], "relax_split": relax_rows} if relax_rows else {}),
        "cases": rows,
    }


# -- phase 13: the provisioner entry -----------------------------------------------

N_CONFIG2 = 10_000  # bench.py config 2: pods, RandomState(7), 480 + 20 GPU types
CONFIG2_SEED = 7
N_GUARD_NODES = 200  # phase 13c's cut: phase 9's cluster at 200 nodes and 3,000 anti pods
N_GUARD_ANTI = 3_000
STORE_CLOCK = 50_000.0  # the fixed clock of phase 13's stores, clusters and recorders


def config2_world(n_pods: int = N_CONFIG2):
    """bench.py config 2 whole (``bench.py:421-466``): ``instance_types(480)``
    plus 20 ``fake-gpu-g`` types (8(g+1) CPU, 16(g+1) Gi, 110 pods,
    min(8, g+1) ``nvidia.com/gpu``), one NodePool ``default``, ``n_pods``
    pods of RandomState(7) sizes, one in ten asking one GPU →
    ([nodepool], provider, pods)."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types, new_instance_type
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(CONFIG2_SEED)
    provider = FakeCloudProvider()
    catalog = instance_types(480)
    for g in range(20):
        catalog.append(new_instance_type(
            f"fake-gpu-{g}",
            {"cpu": str(8 * (g + 1)), "memory": f"{16 * (g + 1)}Gi", "pods": "110",
             "nvidia.com/gpu": str(min(8, g + 1))},
        ))
    provider.instance_types = catalog
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(n_pods):
        cpu = ["100m", "250m", "500m", "1", "2", "4"][rng.randint(6)]
        mem = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"][rng.randint(5)]
        pod = pending_pod(f"bench-{i}", cpu, mem)
        if rng.rand() < 0.1:
            pod.spec.containers[0].resources.requests["nvidia.com/gpu"] = parse_quantity("1")
        pods.append(pod)
    return [nodepool], provider, pods


def store_objects(pools, pods, nodes=(), bound=(), daemons=()) -> list:
    """A live cluster's objects for a store, in the order its watches
    would see them: for each existing node (``StateNode``) its launched
    NodeClaim (the node's provider id, labels and resources) and its
    Node; the ``bound`` pods; a DaemonSet per daemon pod; the NodePools;
    then the pending ``pods``."""
    from karpenter_core_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_core_tpu_torch.kube.objects import DaemonSet

    out = []
    for sn in nodes:
        nc = NodeClaim()
        nc.metadata.name = f"claim-{sn.name()}"
        nc.metadata.labels = dict(sn.node.metadata.labels)
        nc.status.provider_id = sn.provider_id()
        nc.status.capacity = dict(sn.node.status.capacity)
        nc.status.allocatable = dict(sn.node.status.allocatable)
        out += [nc, sn.node]
    out += list(bound)
    for d in daemons:
        ds = DaemonSet(pod_template_spec=copy.deepcopy(d.spec))
        ds.metadata.name, ds.metadata.namespace = d.name, d.namespace
        out.append(ds)
    return out + list(pools) + list(pods)


class Stack:
    """The port's provisioning stack over one in-memory store on a fixed
    clock: a ``KubeClient``, ``Informers`` feeding a ``Cluster``, a
    ``Recorder``, ``Metrics`` and a ``Provisioner`` on the batched path
    (``use_tpu_solver``) on ``device``. ``objects`` go into the store
    after the informers start, as a live cluster's watches deliver them."""

    def __init__(self, device: str, provider, objects):
        from karpenter_core_tpu_torch.events import Recorder
        from karpenter_core_tpu_torch.kube.client import KubeClient
        from karpenter_core_tpu_torch.metrics import Metrics
        from karpenter_core_tpu_torch.provisioning import Provisioner
        from karpenter_core_tpu_torch.state.cluster import Cluster
        from karpenter_core_tpu_torch.state.informers import Informers

        clock = lambda: STORE_CLOCK  # noqa: E731
        self.kube = KubeClient(clock=clock)
        self.cluster = Cluster(self.kube, provider, clock=clock)
        self.informers = Informers(self.kube, self.cluster)
        self.informers.start()
        for obj in objects:
            self.kube.create(obj)
        self.recorder = Recorder(self.kube, clock=clock, capacity=1 << 20)
        self.metrics = Metrics()
        self.provisioner = Provisioner(
            self.kube, provider, self.cluster, recorder=self.recorder, use_tpu_solver=True,
            metrics=self.metrics, device=device,
        )
        if not self.cluster.synced():
            fail("the cluster state is not synced with its store")

    def stop(self) -> None:
        self.informers.stop()

    def reset_claims(self) -> None:
        """Delete the claims a reconcile created, its events and its
        metric samples, so the next reconcile meets a synced cluster, a
        fresh event stream and fresh counters."""
        from karpenter_core_tpu_torch.metrics import Metrics

        for nc in self.kube.list("NodeClaim"):
            if not nc.status.provider_id:
                self.kube.delete(nc)
        self.recorder.reset()
        self.metrics = self.provisioner.metrics = Metrics()
        if self.provisioner._tpu_solver is not None:
            self.provisioner._tpu_solver[1].metrics = self.metrics
        if not self.cluster.synced():
            fail("the cluster is not synced after its new claims were deleted")


class kept_solves:
    """Every ``TorchScheduler.solve`` inside the block, kept as (pods,
    result)."""

    def __enter__(self):
        from karpenter_core_tpu_torch.solver.solver import TorchScheduler

        self.cls, self.real, self.solves = TorchScheduler, TorchScheduler.solve, []
        real, solves = self.real, self.solves

        def solve(solver, pods, *args, **kw):
            res = real(solver, pods, *args, **kw)
            solves.append((list(pods), res))
            return res

        TorchScheduler.solve = solve
        return self

    def __exit__(self, *exc):
        self.cls.solve = self.real


def all_kernels() -> dict:
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    return {"compat_allowed": ck.COMPAT_ALLOWED, **pack_kernels()}


def claim_content(stack) -> list:
    """The claims a reconcile created as a content multiset: labels,
    annotations, requirements, requests, owner references, and the pods
    their Nominated events name."""
    claims = {nc.name: nc for nc in stack.kube.list("NodeClaim") if not nc.status.provider_id}
    nominated = {name: [] for name in claims}
    for e in stack.recorder.find("Nominated"):
        target = e.message.rsplit(": ", 1)[-1]
        if target in nominated:
            nominated[target].append(e.involved_object.name)
    return sorted(
        (
            sorted(nc.metadata.labels.items()), sorted(nc.metadata.annotations.items()),
            sorted((r.key, r.operator, tuple(sorted(r.values))) for r in nc.spec.requirements),
            sorted(nc.spec.resources.requests.items()),
            [(o.kind, o.name) for o in nc.metadata.owner_references],
            sorted(nominated[nc.name]),
        )
        for nc in claims.values()
    )


def trace_split(tr) -> dict:
    """The root lane's provisioner-level spans of the reconcile's
    buffered trace, ms; fails unless it holds ``provisioner.reconcile``
    → ``snapshot_nodes``, ``pending_pods``, ``solve``,
    ``create_node_claims``."""
    if tr is None or tr.name != "provisioner.reconcile" or not tr.contains_solve:
        fail(f"the reconcile left no solve trace in the ring (last: {tr and tr.name})")
    out = {}
    for s in tr.spans:
        if s.tid == tr.root_tid and s.depth <= 1:
            out[s.name] = out.get(s.name, 0.0) + s.dur_ns / 1e6
    for name in ("provisioner.reconcile", "snapshot_nodes", "pending_pods", "solve", "create_node_claims"):
        if name not in out:
            fail(f"the reconcile's trace has no {name} span ({sorted(out)})")
    return {f"{k}_ms": v for k, v in out.items()}


def reconcile_once(stack, what: str) -> dict:
    """One ``reconcile`` with every kernel's launch counter set to 0 just
    before and read just after → its wall ms, the created names, the one
    batched solve it ran (pods, result), the solver's timings, the
    trace's span split and the launches."""
    from karpenter_core_tpu_torch.tracing import tracer

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    with kept_solves() as kept:
        t0 = time.perf_counter()
        names, reason = stack.provisioner.reconcile()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {name: k.launches for name, k in kernels.items()}
    if reason is not None or not names:
        fail(f"{what}: the reconcile created {len(names)} claims, reason {reason!r}")
    if len(kept.solves) != 1:
        fail(f"{what}: the reconcile ran {len(kept.solves)} batched solves, not one")
    pods, res = kept.solves[0]
    return {
        "wall_ms": wall_ms, "names": names, "pods": pods, "res": res,
        "timings": dict(stack.provisioner._tpu_solver[1].last_timings),
        "trace": trace_split(tracer.RING.last()), "launches": launches,
    }


def check_reconcile(stack, run, what: str) -> dict:
    """Fail unless one claim stands in the store per new plan, pinned to
    the plan's pool, type, zone and capacity type, and one per greedy
    claim; every placed pod has exactly one Nominated event, naming its
    claim or its existing node; every existing node that took pods is
    nominated in the cluster; no claim was made for an existing
    placement; and ``nodeclaims_created`` counts the claims per pool."""
    from karpenter_core_tpu_torch.apis import labels as wk

    res, pods = run["res"], run["pods"]
    claims = {nc.name: nc for nc in stack.kube.list("NodeClaim") if not nc.status.provider_id}
    greedy = res.oracle_results.new_node_claims if res.oracle_results is not None else []
    if len(claims) != len(res.node_plans) + len(greedy) or sorted(run["names"]) != sorted(claims):
        fail(f"{what}: {len(claims)} claims for {len(res.node_plans)} plans and {len(greedy)} greedy claims")
    nominated = {}
    for e in stack.recorder.find("Nominated"):
        nominated.setdefault(e.involved_object.name, []).append(e.message.rsplit(": ", 1)[-1])
    for plan in res.node_plans:
        nc = claims.get(getattr(plan, "created_claim_name", None))
        if nc is None:
            fail(f"{what}: a plan on {plan.instance_type.name} has no claim")
        req = {r.key: list(r.values) for r in nc.spec.requirements}
        got = (nc.metadata.labels[wk.NODEPOOL_LABEL_KEY], req[wk.LABEL_INSTANCE_TYPE],
               req[wk.LABEL_TOPOLOGY_ZONE], req[wk.CAPACITY_TYPE_LABEL_KEY])
        if got != (plan.nodepool_name, [plan.instance_type.name], [plan.zone], [plan.capacity_type]):
            fail(f"{what}: claim {nc.name} is {got}, its plan another")
        for i in plan.pod_indices:
            if nominated.get(pods[i].name) != [nc.name]:
                fail(f"{what}: pod {pods[i].name} is not nominated to its claim alone")
    for c in greedy:
        for p in c.pods:
            if nominated.get(p.name) != [c.created_claim_name]:
                fail(f"{what}: greedy pod {p.name} is not nominated to its claim alone")
    existing = list(res.existing_plans)
    if res.oracle_results is not None:
        existing += [e for e in res.oracle_results.existing_nodes if e.pods]
    on_existing = 0
    for e in existing:
        tensor = hasattr(e, "pod_indices")  # else a greedy ExistingNode
        name, pid = (e.state_node.name(), e.state_node.provider_id()) if tensor else (e.name(), e.provider_id())
        if not stack.cluster.is_node_nominated(pid):
            fail(f"{what}: existing node {name} took pods and is not nominated")
        members = [pods[i] for i in e.pod_indices] if tensor else list(e.pods)
        for p in members:
            if nominated.get(p.name) != [name]:
                fail(f"{what}: pod {p.name} on {name} has no Nominated event for it alone")
        on_existing += len(members)
    placed = res.pods_scheduled
    if len(nominated) != placed:
        fail(f"{what}: {len(nominated)} pods have Nominated events, {placed} were placed")
    per_pool = {}
    for nc in claims.values():
        pool = nc.metadata.labels[wk.NODEPOOL_LABEL_KEY]
        per_pool[pool] = per_pool.get(pool, 0) + 1
    for pool, n in per_pool.items():
        if stack.metrics.nodeclaims_created.get(reason="provisioning", nodepool=pool) != n:
            fail(f"{what}: nodeclaims_created{{nodepool={pool}}} is not its {n} claims")
    route = stack.metrics.solver_route_pods
    return {
        "claims": len(claims), "claims_by_pool": dict(sorted(per_pool.items())),
        "nominated_pods": len(nominated), "pods_on_existing": on_existing,
        "nominated_nodes": sum(1 for pid in stack.cluster.nodes if stack.cluster.is_node_nominated(pid)),
        "pod_errors": len(res.pod_errors),
        "route_pods": {k[0][1]: v for k, v in sorted(route.values.items())},
    }


def same_plans(run, direct, direct_pods, what: str) -> None:
    """Fail unless the reconcile's batched solve has the direct solve's
    plans, existing plans and errors (by pod index: the two batches hold
    the same pods in the same order, as distinct objects)."""
    def errors(res, pods):
        return {i: res.pod_errors[p.uid] for i, p in enumerate(pods) if p.uid in res.pod_errors}

    res = run["res"]
    if [p.name for p in run["pods"]] != [p.name for p in direct_pods]:
        fail(f"{what}: the reconcile's batch is not the direct solve's pods in order")
    if (plan_stream(res), existing_stream(res), errors(res, run["pods"])) != (
        plan_stream(direct), existing_stream(direct), errors(direct, direct_pods)
    ):
        fail(f"{what}: the reconcile's plans differ from the direct solve's")


def reconcile_row(run, check: dict) -> dict:
    t = run["timings"]
    return {
        "reconcile_ms": run["wall_ms"], "solve_ms": t["total_ms"], "solve_device_ms": t["device_ms"],
        **{f"span_{k}": v for k, v in run["trace"].items()},
        "solve_phases_ms": {k: v for k, v in t.items() if k.endswith("_ms") and k not in ("total_ms", "device_ms", "host_ms")},
        "nodes": run["res"].node_count, "pods_scheduled": run["res"].pods_scheduled,
        **check, "kernel_launches": run["launches"],
    }


def run_provisioner_config2(device: str = "cuda", n_pods: int = N_CONFIG2) -> dict:
    """Phase 13a, config2-provisioner: bench config 2 as pending pods in
    a store, one reconcile on ``device``, three more ``schedule()``
    calls, the claims against a direct solve and a CPU reconcile in a
    fresh store, the metrics and the trace; then one parity shadow."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods = config2_world(n_pods)
    stack = Stack(device, provider, store_objects(pools, pods))
    world_s = time.perf_counter() - t0
    stack.provisioner.PARITY_SAMPLE_EVERY = 0  # the shadow runs below, after the counts
    run = reconcile_once(stack, "config2-provisioner")
    if device == "cuda" and run["launches"]["compat_allowed"] == 0:
        fail("config2-provisioner: the reconcile never launched the compat kernel")
    check = check_reconcile(stack, run, "config2-provisioner")
    warm = []
    for _ in range(3):
        t1 = time.perf_counter()
        stack.provisioner.schedule()
        warm.append((time.perf_counter() - t1) * 1000.0)
    solves = sum(stack.metrics.solver_duration.totals.values())
    if solves != 4 or sum(stack.metrics.solver_device_duration.totals.values()) != 4:
        fail(f"config2-provisioner: solver_duration observed {solves} solves, not 4")
    direct_pods = config2_world(n_pods)[2]
    direct = TorchScheduler(pools, provider, device=device).solve(direct_pods)
    same_plans(run, direct, direct_pods, "config2-provisioner")
    cpu_pools, _, cpu_pods = config2_world(n_pods)
    cpu = Stack("cpu", provider, store_objects(cpu_pools, cpu_pods))
    cpu_run = reconcile_once(cpu, "config2-provisioner on the cpu")
    if claim_content(cpu) != claim_content(stack):
        fail("config2-provisioner: the claims differ between cuda and cpu")
    cpu.stop()
    # the parity shadow: the greedy scheduler and a batched solve on a
    # 500-pod subsample, on a daemon thread; it swallows its errors, so
    # its gauge is read explicitly
    stack.provisioner.PARITY_SAMPLE_EVERY = 1
    stack.provisioner.schedule()
    deadline = time.monotonic() + 120
    while stack.provisioner._parity_inflight and time.monotonic() < deadline:
        time.sleep(0.05)
    parity = stack.metrics.solver_parity.get()
    if parity is None:
        fail("config2-provisioner: the parity shadow set no solver_parity")
    stack.stop()
    row = {
        "provisioner": "config2",
        "world": f"{n_pods} pods (bench config 2, 10 % asking a GPU) x {len(provider.instance_types)} types, no existing nodes",
        "world_and_store_s": world_s,
        **reconcile_row(run, check),
        "schedule_warm_ms": statistics.median(warm), "schedule_warm_runs_ms": warm,
        "cpu_reconcile_ms": cpu_run["wall_ms"], "solver_parity": parity,
        "solver_duration_count": solves,
    }
    emit(row)
    return row


def run_provisioner_cluster(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                            n_nodes: int = N_NODES) -> dict:
    """Phase 13b, cluster-provisioner: phase 5's world as objects in a
    store (1,000 initialized nodes with their NodeClaims, the bound pods,
    three DaemonSets, pools ``reserved`` and ``default``) fed through the
    informers, then the 50,000 pending pods: a reconcile with the C++
    packer and three ``schedule()`` calls, then a reconcile with
    ``KARPENTER_TORCH_NATIVE=0`` (the device scans), each against a
    direct solve of phase 5's inputs under the same packer
    (``solve(pods, state_nodes, daemonset_pods)``), and a CPU reconcile
    with the C++ packer. The device run's CPU counterpart is phase 12's:
    its cluster-device path holds the direct device-engine solve of the
    same inputs to the plain scans on the CPU. One captured compat call,
    and one existing-node first-fit call of the device run, held against
    their plain versions."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver import solver as solver_mod
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing, kube = _cluster_world(n_pods, n_types, n_nodes, store=True)
    stack = Stack(device, provider, store_objects(pools, pods, nodes, kube.list("Pod"), daemons))
    world_s = time.perf_counter() - t0
    stack.provisioner.PARITY_SAMPLE_EVERY = 0  # no shadow solve among the counted ones
    if len(stack.cluster.nodes) != n_nodes or len(stack.cluster.bindings) != sum(len(sn.pod_requests) for sn in nodes):
        fail("cluster-provisioner: the cluster state does not hold the store's nodes and bound pods")
    rows = {}
    with capture(solver_mod, "allowed_via_kernel", 1) as compat_call:
        run = reconcile_once(stack, "cluster-provisioner")
    # the direct solves come after the first reconcile, which so meets
    # the pods unmemoized
    direct = TorchScheduler(pools, provider, device=device).solve(pods, state_nodes=nodes, daemonset_pods=daemons)
    with knobs(KARPENTER_TORCH_NATIVE=0):
        direct_dev = TorchScheduler(pools, provider, device=device).solve(
            pods, state_nodes=nodes, daemonset_pods=daemons
        )
    same_plans(run, direct, pods, "cluster-provisioner")
    if device == "cuda" and run["launches"]["compat_allowed"] == 0:
        fail("cluster-provisioner: the reconcile never launched the compat kernel")
    check = check_reconcile(stack, run, "cluster-provisioner")
    summary = check_cluster(run["res"], run["pods"], nodes, daemons, missing)
    content = claim_content(stack)
    warm = []
    for _ in range(3):
        t1 = time.perf_counter()
        stack.provisioner.schedule()
        warm.append((time.perf_counter() - t1) * 1000.0)
    rows["cluster"] = {
        "provisioner": "cluster", "world_and_store_s": world_s,
        "store_objects": len(stack.kube.list("Node")) + len(stack.kube.list("Pod")) + len(stack.kube.list("NodeClaim")),
        **reconcile_row(run, check), **summary,
        "schedule_warm_ms": statistics.median(warm), "schedule_warm_runs_ms": warm,
    }
    # the captured compat call against its plain version, bit for bit
    rows["cluster"]["captured_compat"] = compat_call_case(compat_call.calls[0])
    compat_err = rows["cluster"]["captured_compat"]["max_abs_err"]

    stack.reset_claims()
    with knobs(KARPENTER_TORCH_NATIVE=0), capture(pack, "pack_existing", 1) as ex_call:
        dev_run = reconcile_once(stack, "cluster-provisioner device engine")
    same_plans(dev_run, direct_dev, pods, "cluster-provisioner device engine")
    if device == "cuda" and (dev_run["launches"]["ffd_pack"] == 0 or dev_run["launches"]["pack_existing"] == 0
                             or dev_run["launches"]["compat_allowed"] == 0):
        fail(f"cluster-provisioner device engine: the reconcile launched {dev_run['launches']}")
    dev_check = check_reconcile(stack, dev_run, "cluster-provisioner device engine")
    check_cluster(dev_run["res"], dev_run["pods"], nodes, daemons, missing)
    rows["cluster-device"] = {"provisioner": "cluster-device", **reconcile_row(dev_run, dev_check)}
    existing_case = existing_kernel_case(ex_call.calls[0]) if device == "cuda" else None

    # the same store on the CPU with the C++ packer: a fresh solver
    stack.reset_claims()
    stack.provisioner.device = "cpu"
    stack.provisioner._tpu_solver = None
    cpu_run = reconcile_once(stack, "cluster-provisioner on the cpu")
    if claim_content(stack) != content:
        fail("cluster-provisioner: the claims differ between cuda and cpu")
    same_plans(cpu_run, direct, pods, "cluster-provisioner on the cpu")
    rows["cluster"]["cpu_reconcile_ms"] = cpu_run["wall_ms"]
    stack.stop()
    for r in rows.values():
        emit(r)
    return {"rows": rows, "existing_case": existing_case, "compat_err": compat_err}


def guard_pods(nodes) -> list:
    """Bound pods with required anti-affinity on existing nodes, each in
    the store: ``guard-redis`` on ``node-0002`` (test-zone-3) refuses the
    redis release's pods on its node; ``guard-pg`` on ``node-0001``
    (test-zone-2) refuses the ``pg-0`` release in its zone; ``guard-team``
    on ``node-0004`` refuses ``team=t-0`` pods (tensor-routed) on its
    node."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import Affinity, LabelSelector, PodAffinityTerm, PodAntiAffinity

    by_name = {sn.name(): sn for sn in nodes}
    out = []
    for name, node, key, selector in (
        ("guard-redis", "node-0002", wk.LABEL_HOSTNAME, {"app.kubernetes.io/name": "redis"}),
        ("guard-pg", "node-0001", wk.LABEL_TOPOLOGY_ZONE, {"app.kubernetes.io/instance": "pg-0"}),
        ("guard-team", "node-0004", wk.LABEL_HOSTNAME, {"team": "t-0"}),
    ):
        p = bound_anchor(name, {"role": "guard"}, node)
        p.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(required=[
            PodAffinityTerm(topology_key=key, label_selector=LabelSelector(match_labels=selector)),
        ]))
        by_name[node].update_for_pod(p)
        out.append(p)
    return out


def guard_world(n_anti: int = N_GUARD_ANTI, n_types: int = N_TYPES, n_nodes: int = N_GUARD_NODES,
                n_releases: int = N_RELEASES):
    """Phase 9's ``anti_cluster_world`` (its eight ``ext-*`` anchors on
    existing nodes) cut to ``n_nodes`` nodes and ``n_anti`` anti pods,
    the ``guard_pods``, and phase 11's Helm release pods → (pools,
    provider, pods, nodes, daemons, missing, bound pods: the workers,
    daemons, anchors and guards)."""
    pools, provider, pods, nodes, daemons, missing, kube = anti_cluster_world(n_anti, n_types, n_nodes)
    bound = kube.list("Pod") + guard_pods(nodes)
    return pools, provider, pods + release_pods(n_releases), nodes, daemons, missing, bound


def check_inverse(res, pods, kube, zones) -> dict:
    """Every bound pod of ``kube`` with required anti-affinity against
    every placement of the solve its selector matches: a hostname term
    excludes its node, a zone term its node's zone (a greedy claim may
    launch in any zone its requirements leave). Fails on a greedy
    placement in an excluded domain; counts the tensor path's (the JAX
    package's tensor path does not read the inverse anti-affinity of
    bound pods either; ROADMAP C8)."""
    from karpenter_core_tpu_torch.apis import labels as wk

    node_zone = {n.name: n.metadata.labels.get(wk.LABEL_TOPOLOGY_ZONE) for n in kube.list("Node")}
    tensor = {i: (z, node) for i, (z, node) in placements(res).items()}
    greedy = {}
    if res.oracle_results is not None:
        index = {p.uid: i for i, p in enumerate(pods)}
        for c in res.oracle_results.new_node_claims:
            allowed = set(zones)
            if c.requirements.has(wk.LABEL_TOPOLOGY_ZONE):
                req = c.requirements.get_req(wk.LABEL_TOPOLOGY_ZONE)
                allowed = allowed - req.values if req.complement else set(req.values)
            for p in c.pods:
                greedy[index[p.uid]] = (allowed, ("claim", id(c)))
        for e in res.oracle_results.existing_nodes:
            for p in e.pods:
                greedy[index[p.uid]] = ({node_zone[e.name()]}, ("existing", e.name()))
    out = {"guards": 0, "greedy_checked": 0, "tensor_violations": []}
    for g in kube.list("Pod"):
        a = g.spec.affinity
        if not g.spec.node_name or a is None or a.pod_anti_affinity is None or not a.pod_anti_affinity.required:
            continue
        out["guards"] += 1
        for t in a.pod_anti_affinity.required:
            hostname = t.topology_key == wk.LABEL_HOSTNAME
            for i, p in enumerate(pods):
                if p.namespace != g.namespace or not t.label_selector.matches(p.metadata.labels):
                    continue
                if i in greedy:
                    out["greedy_checked"] += 1
                    allowed, node = greedy[i]
                    bad = node == ("existing", g.spec.node_name) if hostname else node_zone[g.spec.node_name] in allowed
                    if bad:
                        fail(f"greedy placement of {p.name} on {node} is in a domain {g.name} excludes")
                elif i in tensor:
                    z, node = tensor[i]
                    bad = node == ("existing", g.spec.node_name) if hostname else z == node_zone[g.spec.node_name]
                    if bad:
                        out["tensor_violations"].append((p.name, g.name))
    out["tensor_violations"] = sorted(out["tensor_violations"])
    return out


def run_provisioner_guard(device: str = "cuda", n_anti: int = N_GUARD_ANTI, n_types: int = N_TYPES,
                          n_nodes: int = N_GUARD_NODES, n_releases: int = N_RELEASES) -> dict:
    """Phase 13c, anti-cluster-oracle: ``guard_world`` in a store, one
    reconcile on ``device`` and one on the CPU in a fresh store: the
    claims, the greedy fallback's claims and the inverse-anti-affinity
    check equal, ``check_anti`` and ``check_oracle`` on the card's
    solve."""
    def build(dev):
        pools, provider, pods, nodes, daemons, missing, bound = guard_world(n_anti, n_types, n_nodes, n_releases)
        stack = Stack(dev, provider, store_objects(pools, pods, nodes, bound, daemons))
        return stack, (pools, provider, pods, nodes, daemons, missing)

    t0 = time.perf_counter()
    stack, (pools, provider, pods, nodes, daemons, missing) = build(device)
    world_s = time.perf_counter() - t0
    stack.provisioner.PARITY_SAMPLE_EVERY = 0
    run = reconcile_once(stack, "anti-cluster-oracle")
    if device == "cuda" and run["launches"]["compat_allowed"] == 0:
        fail("anti-cluster-oracle: the reconcile never launched the compat kernel")
    res, batch = run["res"], run["pods"]
    check = check_reconcile(stack, run, "anti-cluster-oracle")
    route = dict(stack.provisioner._tpu_solver[1].last_route_stats)
    zones = sorted({sn.labels().get("topology.kubernetes.io/zone") for sn in nodes})
    inverse = check_inverse(res, batch, stack.kube, zones)
    if inverse["guards"] != 3 or inverse["greedy_checked"] == 0:
        fail(f"anti-cluster-oracle: the inverse check saw {inverse['guards']} guards, "
             f"{inverse['greedy_checked']} greedy placements they select")
    cpu, _ = build("cpu")
    cpu.provisioner.PARITY_SAMPLE_EVERY = 0
    cpu_run = reconcile_once(cpu, "anti-cluster-oracle on the cpu")
    if claim_content(cpu) != claim_content(stack):
        fail("anti-cluster-oracle: the claims differ between cuda and cpu")
    same_plans(cpu_run, res, batch, "anti-cluster-oracle on the cpu")
    same_oracle_as_cpu(res, batch, cpu_run["res"], cpu_run["pods"], "anti-cluster-oracle")
    if check_inverse(cpu_run["res"], cpu_run["pods"], cpu.kube, zones) != inverse:
        fail("anti-cluster-oracle: the inverse check differs between cuda and cpu")
    cpu.stop()
    row = {
        "provisioner": "anti-cluster-oracle",
        "world": (f"{len(pods)} pods ({n_anti} config 13 anti_dense + 6 quorum + {len(pods) - n_anti - N_QUORUM} "
                  f"Helm release pods) x {len(provider.instance_types)} types x {len(nodes)} existing nodes "
                  f"(phase 9's cluster cut from {N_NODES}), 8 anchors, 3 guards"),
        "world_and_store_s": world_s,
        **reconcile_row(run, check),
        "oracle": check_oracle(res, batch, len(pods) - n_anti - N_QUORUM, route),
        "anti": check_anti(res, batch, stack.kube),
        "inverse_anti": inverse,
        **check_cluster(res, batch, nodes, daemons, missing, spill=False),
        "cpu_reconcile_ms": cpu_run["wall_ms"],
    }
    stack.stop()
    emit(row)
    return row


def run_provisioner_phase(device: str = "cuda", sizes: Optional[dict] = None) -> dict:
    """Phase 13 → its three parts' rows; ``sizes`` cuts them for a
    rehearsal on the CPU (``config2``, ``cluster`` (pods, types, nodes),
    ``guard`` (anti pods, types, nodes, releases))."""
    sizes = sizes or {}
    out = {"config2": run_provisioner_config2(device, *sizes.get("config2", ()))}
    out.update(run_provisioner_cluster(device, *sizes.get("cluster", ())))
    out["guard"] = run_provisioner_guard(device, *sizes.get("guard", ()))
    return out


# -- phase 14: cross-tick warm state (bench config 7) ------------------------------

N_CONFIG7 = 10_000  # bench.py config 7 (bench.py:763-960): pods, RandomState(23)
CONFIG7_SEED = 23
CONFIG7_TEAMS = 40
CONFIG7_TYPES = 480  # plus 20 GPU types
CONFIG7_TICKS = 30
CONFIG7_CHURN = 0.05
CONFIG7_MUTATE_EVERY = 10
CONFIG7_NATIVE_OFF_TICKS = 10  # the second warm pass, on the FFD scan kernel


def compat_call_case(call, reps: int = 20) -> dict:
    """One captured ``allowed_via_kernel`` call (signature planes, device
    catalog) against its plain version on the catalog's device, bit for
    bit, and the kernel's time on the card."""
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    sig, catalog = call[:2]
    sig = sig.to(catalog.device)
    got = ck.allowed_via_kernel(sig, catalog)
    plain = ck.allowed_packed_reference(sig, catalog.planes, catalog.layout)
    err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max().item()) if got.numel() else 0
    row = {"S": int(sig.shape[1]), "T": catalog.n_types, "W": int(sig.shape[0]), "max_abs_err": err}
    if err:
        fail(f"a captured compat call differs from its plain version: {row}")
    if catalog.device.type == "cuda":
        row["kernel_ms"] = events_ms(lambda: ck.allowed_via_kernel(sig, catalog), reps)
    return row


def distinct_compat_calls(calls) -> list:
    """The first captured compat call of each (signature planes shape,
    types) pair, in capture order."""
    seen, out = set(), []
    for call in calls:
        key = (tuple(call[0].shape), call[1].n_types)
        if key not in seen:
            seen.add(key)
            out.append(call)
    return out


class Config7:
    """bench config 7's churning world on the port: ``n_pods`` pods of
    the config-2 size mix (one in ten asks one GPU) over ``teams`` team
    deployments (``bench-team`` selector and label), ``cap-{i}`` types
    ((i % 64) + 1 CPU, twice that in Gi) and 20 GPU types, one pool
    ``bench-team In t0..t{teams-1}``. ``churn_tick`` swaps about
    ``churn`` of the pods on a tenth of the teams; ``mutate`` raises the
    price of every 16th type 1 % in place, bumps the catalog generation
    and the pool's weight; ``clones`` build the restart-shaped copies of
    the current tick (fresh pods, catalog and pool objects)."""

    def __init__(self, n_pods: int = N_CONFIG7, n_types: int = CONFIG7_TYPES, teams: int = CONFIG7_TEAMS,
                 churn: float = CONFIG7_CHURN):
        from karpenter_core_tpu_torch.apis.nodepool import NodePool
        from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, new_instance_type
        from karpenter_core_tpu_torch.kube.objects import NodeSelectorRequirement

        self.new_instance_type = new_instance_type
        self.rng = np.random.RandomState(CONFIG7_SEED)
        self.teams, self.churn = teams, churn
        self.cat_specs = [
            (f"cap-{i}", {"cpu": str((i % 64) + 1), "memory": f"{2 * ((i % 64) + 1)}Gi", "pods": "110"})
            for i in range(n_types)
        ] + [
            (f"cap-gpu-{g}", {"cpu": str(8 * (g + 1)), "memory": f"{16 * (g + 1)}Gi", "pods": "110",
                              "nvidia.com/gpu": str(min(8, g + 1))})
            for g in range(20)
        ]
        self.provider = FakeCloudProvider()
        self.provider.instance_types = [new_instance_type(n, r) for n, r in self.cat_specs]
        self.provider.bump_catalog_generation()  # the caller owns catalog invalidation
        self.pool = NodePool()
        self.pool.metadata.name = "default"
        self.pool.spec.template.requirements = [
            NodeSelectorRequirement("bench-team", "In", [f"t{t}" for t in range(teams)])
        ]
        self.counter = 0
        self.pods = [self.mk(t % teams) for t in range(n_pods)]

    def _pod(self, i: int, spec: tuple):
        from karpenter_core_tpu_torch.kube.quantity import parse_quantity

        cpu, mem, gpu, team = spec
        pod = pending_pod(f"bench-{i}", cpu, mem, labels={"bench-team": f"t{team}"})
        pod.spec.node_selector = {"bench-team": f"t{team}"}
        if gpu:
            pod.spec.containers[0].resources.requests["nvidia.com/gpu"] = parse_quantity(gpu)
        pod.__dict__["_config7_spec"] = spec
        return pod

    def mk(self, team: int):
        rng = self.rng
        cpu = ["100m", "250m", "500m", "1", "2", "4"][rng.randint(6)]
        mem = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"][rng.randint(5)]
        gpu = "1" if rng.rand() < 0.1 else None
        self.counter += 1
        return self._pod(self.counter - 1, (cpu, mem, gpu, team))

    def churn_tick(self) -> None:
        rng = self.rng
        hit = rng.choice(self.teams, max(1, self.teams // 10), replace=False)
        target = int(len(self.pods) * self.churn)
        removed, keep = 0, []
        for p in self.pods:
            t = int(p.metadata.labels["bench-team"][1:])
            if t in hit and removed < target and rng.rand() < 0.5:
                removed += 1
                continue
            keep.append(p)
        self.pods = keep + [self.mk(int(hit[k % len(hit)])) for k in range(removed)]

    def mutate(self) -> None:
        types = self.provider.instance_types
        for it in types[:: max(1, len(types) // 16)]:
            for o in it.offerings:
                o.price *= 1.01
        self.provider.bump_catalog_generation()
        self.pool.spec.weight = (self.pool.spec.weight or 0) + 1

    def clones(self) -> tuple:
        """(pods, provider, pool): fresh objects of the current tick."""
        from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
        from karpenter_core_tpu_torch.cloudprovider.types import Offering

        provider = FakeCloudProvider()
        provider.instance_types = [
            self.new_instance_type(name, res, offerings=[
                Offering(o.capacity_type, o.zone, o.price, o.available) for o in live.offerings
            ])
            for (name, res), live in zip(self.cat_specs, self.provider.instance_types)
        ]
        pods = [self._pod(i, p.__dict__["_config7_spec"]) for i, p in enumerate(self.pods)]
        return pods, provider, copy.deepcopy(self.pool)


class nogc:
    """A collector-free timed region, as bench.py's ``nogc``: at this
    scale the collector owns millions of objects, and a full collection
    inside a timed solve would be measured as the solve."""

    def __enter__(self):
        gc.collect()
        self.was_enabled = gc.isenabled()
        gc.disable()
        return self

    def __exit__(self, *exc):
        if self.was_enabled:
            gc.enable()


def config7_canon(res, pods) -> tuple:
    """A tick's plans by pod position (the cold leg solves clones, so
    uids differ; the batch order is shared)."""
    index = {p.uid: i for i, p in enumerate(pods)}
    return plan_stream(res), sorted((index[uid], e) for uid, e in res.pod_errors.items())


def _pctl(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_config7_phase(device: str = "cuda", n_pods: int = N_CONFIG7, n_types: int = CONFIG7_TYPES,
                      ticks: int = CONFIG7_TICKS, native_off_ticks: int = CONFIG7_NATIVE_OFF_TICKS) -> dict:
    """Phase 14: bench config 7's ticks on ``device``. Every tick solves
    twice: the cold leg restart-shaped (fresh pods, catalog and pool, a
    fresh TorchScheduler, KARPENTER_TORCH_INCREMENTAL=0), the warm leg on
    one long-lived TorchScheduler; the plans must be identical and the
    warm leg's compat launches at most the cold leg's. Then a no-op tick
    (a replay: no compat, no FFD launch); a second warm pass with
    KARPENTER_TORCH_NATIVE=0, whose FFD scan launches are exactly one per
    (size class, width) class of the jobs the job memo missed, none on a
    tick whose jobs all hit, its plans equal to a cold solve of the tick's
    pods on the same engine; a restart: snapshot, simulated process death,
    restore into a fresh scheduler whose first solve of the last tick's
    pods is plan-identical and launches no compat kernel; and the last
    tick's plan against a cold CPU solve (the device-engine pass's last
    tick's too, through the plain scans). On the card every compat and FFD
    call the phase's solves make is captured, and each distinct shape is
    held against its plain version bit for bit. → the phase's row."""
    import tempfile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import pack, warmstore
    from karpenter_core_tpu_torch.solver import solver as solver_mod
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    compat, ffd = ck.COMPAT_ALLOWED, pack.FFD_PACK
    sections: dict = {}
    t_section = time.perf_counter()

    def section(name):
        nonlocal t_section
        now = time.perf_counter()
        sections[name] = now - t_section
        t_section = now

    world = Config7(n_pods, n_types)
    legs = {leg: {"compat": [], "ffd": [], "host_ms": [], "total_ms": [], "timings": []} for leg in ("cold", "warm")}
    identical, hit_rates = 0, []
    hits: dict = {}
    misses: dict = {}

    def solve(solver, pods, leg):
        compat.launches = ffd.launches = 0
        with nogc():
            res = solver.solve(pods)
        row = legs[leg]
        row["compat"].append(compat.launches)
        row["ffd"].append(ffd.launches)
        row["host_ms"].append(solver.last_timings["host_ms"])
        row["total_ms"].append(solver.last_timings["total_ms"])
        row["timings"].append(dict(solver.last_timings))
        return res

    def cold_leg(leg="cold"):
        pods, provider, pool = world.clones()
        with knobs(KARPENTER_TORCH_INCREMENTAL=0):
            return solve(TorchScheduler([pool], provider, device=device), pods, leg), pods

    def check_tick(tick, res, ref, ref_pods):
        nonlocal identical
        if config7_canon(res, world.pods) == config7_canon(ref, ref_pods):
            identical += 1
        else:
            fail(f"config7 tick {tick}: the warm plans differ from the cold plans")
        if legs["warm"]["compat"][-1] > legs["cold"]["compat"][-1]:
            fail(f"config7 tick {tick}: the warm leg launched more compat kernels than the cold leg")
        cs = warm.last_cache_stats or {}
        if "hit_rate" in cs:
            hit_rates.append(cs["hit_rate"])
        for name, n in cs.get("hits", {}).items():
            hits[name] = hits.get(name, 0) + n
        for name, n in cs.get("misses", {}).items():
            misses[name] = misses.get(name, 0) + n

    # as bench.py's config 7: the earlier phases' survivors frozen out of
    # every collection, each timed solve collector-free
    gc.collect()
    gc.freeze()
    section("world_s")
    warm = TorchScheduler([world.pool], world.provider, device=device)
    with capture(solver_mod, "allowed_via_kernel", 64) as compat_cap:
        for tick in range(ticks):
            if tick:
                world.churn_tick()
                if tick % CONFIG7_MUTATE_EVERY == 0:
                    world.mutate()
            ref, ref_pods = cold_leg()
            res = solve(warm, world.pods, "warm")
            check_tick(tick, res, ref, ref_pods)
    last_plan, last_pods = res, list(world.pods)
    section("main_pass_s")

    # the no-op tick: unchanged inputs replay whole
    compat.launches = ffd.launches = 0
    with nogc():
        t0 = time.perf_counter()
        noop = warm.solve(world.pods)
        noop_wall_ms = (time.perf_counter() - t0) * 1000.0
    noop_row = {
        "host_ms": warm.last_timings["host_ms"], "wall_ms": noop_wall_ms,
        "compat_launches": compat.launches, "ffd_launches": ffd.launches,
        "cache": warm.last_cache_stats,
    }
    if warm.last_cache_stats.get("hits", {}).get("warmstart") != 1:
        fail(f"config7 no-op tick did not replay: {warm.last_cache_stats}")
    if compat.launches or ffd.launches:
        fail(f"config7 no-op tick launched kernels: compat {compat.launches}, ffd {ffd.launches}")
    if plan_stream(noop) != plan_stream(last_plan):
        fail("config7 no-op tick changed the plans")
    section("noop_s")

    # the second warm pass on the device engine: FFD scan launches per
    # class of the job-memo misses. Its reference is a cold solve of the
    # tick's own objects (a fresh scheduler, the warm state off): the
    # plans are checked here, the restart-shaped timing in the first pass
    native_rows = []
    with knobs(KARPENTER_TORCH_NATIVE=0), capture(pack, "ffd_pack_batched", 64) as ffd_cap:
        for k in range(native_off_ticks):
            if k:
                world.churn_tick()
            with knobs(KARPENTER_TORCH_INCREMENTAL=0):
                ref = solve(TorchScheduler([world.pool], world.provider, device=device), world.pods, "cold")
            ref_pods = world.pods
            real = pack.batch_pack
            calls = []

            def spy(jobs, *a, **kw):
                calls.append([(pack._pad_class(j[0].shape[0]), j[0].shape[1]) for j in jobs])
                return real(jobs, *a, **kw)

            pack.batch_pack = spy
            try:
                res = solve(warm, world.pods, "warm")
            finally:
                pack.batch_pack = real
            cs = warm.last_cache_stats
            job_misses = cs.get("misses", {}).get("job", 0)
            classes = sum(len(set(c)) for c in calls)
            row = {
                "tick": k, "job_hits": cs.get("hits", {}).get("job", 0), "job_misses": job_misses,
                "jobs_packed": sum(len(c) for c in calls), "classes": classes,
                "ffd_launches": legs["warm"]["ffd"][-1], "cold_ffd_launches": legs["cold"]["ffd"][-1],
                "compat_launches": legs["warm"]["compat"][-1], "cold_compat_launches": legs["cold"]["compat"][-1],
                "host_ms": legs["warm"]["host_ms"][-1], "cold_host_ms": legs["cold"]["host_ms"][-1],
            }
            native_rows.append(row)
            if row["jobs_packed"] != job_misses:
                fail(f"config7 device engine tick {k}: {row['jobs_packed']} jobs packed, {job_misses} job misses")
            # on the CPU the scan's plain version runs: no launch to count
            expect = classes if device == "cuda" else 0
            if row["ffd_launches"] != expect or (classes == 0) != (job_misses == 0):
                fail(f"config7 device engine tick {k}: {row}")
            if config7_canon(res, world.pods) != config7_canon(ref, ref_pods):
                fail(f"config7 device engine tick {k}: the warm plans differ from the cold plans")
        # the pass's last warm plans against a cold CPU solve through the
        # plain scans
        with knobs(KARPENTER_TORCH_INCREMENTAL=0):
            cpu_scan = TorchScheduler([world.pool], world.provider, device="cpu").solve(world.pods)
        if config7_canon(res, world.pods) != config7_canon(cpu_scan, world.pods):
            fail("config7 device engine: the last warm plans differ from a cold CPU solve's")
    section("native_off_pass_s")

    # the restart: snapshot, process death, restore into a fresh scheduler
    last_pods, last_provider, last_pool = world.clones()
    compat.launches = ffd.launches = 0
    unkilled = warm.solve(world.pods)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = warm.snapshot(directory=tmp)
        snapshot_ms = (time.perf_counter() - t0) * 1000.0
        if path is None:
            fail("config7: the warm store wrote no snapshot")
        snapshot_bytes = os.path.getsize(path)
        warmstore.simulate_process_death()
        last_provider.bump_catalog_generation()
        restored = TorchScheduler([last_pool], last_provider, device=device)
        with nogc():
            t0 = time.perf_counter()
            outcome = restored.restore(path)
            restore_ms = (time.perf_counter() - t0) * 1000.0
    # memo entries of catalogs mutated away since are dropped (their
    # fingerprint witnesses no live catalog); the live catalog's restore
    restored_planes = outcome.get("restored", {})
    if outcome.get("dropped", {}).get("catalog") or not all(
        restored_planes.get(plane) for plane in ("catalog", "compat", "route", "job")
    ):
        fail(f"config7 restore: {outcome}")
    compat.launches = ffd.launches = 0
    with nogc():
        t0 = time.perf_counter()
        first = restored.solve(last_pods)
        restored_ms = (time.perf_counter() - t0) * 1000.0
    restart_row = {
        "restored": outcome["restored"], "dropped": outcome["dropped"], "restore_ms": restore_ms,
        "snapshot_ms": snapshot_ms, "snapshot_bytes": snapshot_bytes,
        "first_solve_ms": restored_ms, "first_solve_host_ms": restored.last_timings["host_ms"],
        "compat_launches": compat.launches, "ffd_launches": ffd.launches,
        "cache": restored.last_cache_stats,
    }
    if config7_canon(first, last_pods) != config7_canon(unkilled, world.pods):
        fail("config7: the restored scheduler's first solve differs from the un-killed scheduler's")
    if compat.launches:
        fail(f"config7: the restored first solve launched {compat.launches} compat kernels")
    section("restart_s")

    # the last tick's plan against a cold solve on the CPU
    with knobs(KARPENTER_TORCH_INCREMENTAL=0):
        cpu = TorchScheduler([world.pool], world.provider, device="cpu").solve(world.pods)
    if plan_sha256(cpu) != plan_sha256(first):
        fail("config7: the last tick's plan differs from the cold CPU solve's")
    section("cpu_check_s")

    # every distinct compat and FFD shape the phase's solves gave, against
    # the plain versions on the card (these launches are not counted)
    kernel_cases = {"compat_allowed": [], "ffd_pack": []}
    if device == "cuda":
        kernel_cases["compat_allowed"] = [compat_call_case(c) for c in distinct_compat_calls(compat_cap.calls)]
        kernel_cases["ffd_pack"] = [ffd_kernel_case(c) for c in distinct_shapes(ffd_cap.calls)]
        if not kernel_cases["compat_allowed"] or not kernel_cases["ffd_pack"]:
            fail(f"config7: no compat or FFD call was captured: {len(compat_cap.calls)}, {len(ffd_cap.calls)}")
    section("kernel_cases_s")

    gc.unfreeze()
    cold_p50, warm_p50 = _pctl(legs["cold"]["host_ms"][:ticks], 50), _pctl(legs["warm"]["host_ms"][:ticks], 50)
    return {
        "ticks": ticks,
        "plan_identical_ticks": identical,
        "native_off_plan_identical_ticks": len(native_rows),
        "cold_tick_host_ms_p50": cold_p50,
        "cold_tick_host_ms_p99": _pctl(legs["cold"]["host_ms"][:ticks], 99),
        "warm_tick_host_ms_p50": warm_p50,
        "warm_tick_host_ms_p99": _pctl(legs["warm"]["host_ms"][:ticks], 99),
        "cold_over_warm_p50": cold_p50 / warm_p50 if warm_p50 else None,
        "warm_tick_wall_ms_p50": _pctl(legs["warm"]["total_ms"][:ticks], 50),
        # each leg's solve phases (last_timings), median over the ticks
        **{
            f"{leg}_tick_phases_ms_p50": {
                k: _pctl([t[k] for t in legs[leg]["timings"][:ticks]], 50)
                for k in legs[leg]["timings"][0] if k.endswith("_ms")
            }
            for leg in ("cold", "warm")
        },
        "noop_tick_host_ms": noop_row["host_ms"],
        "noop": noop_row,
        "mean_hit_rate": float(np.mean(hit_rates)) if hit_rates else 0.0,
        "hits": hits,
        "misses": misses,
        "launches": {
            "cold": {"compat": sum(legs["cold"]["compat"][:ticks]), "ffd": sum(legs["cold"]["ffd"][:ticks])},
            "warm": {"compat": sum(legs["warm"]["compat"][:ticks]), "ffd": sum(legs["warm"]["ffd"][:ticks])},
            "noop": {"compat": noop_row["compat_launches"], "ffd": noop_row["ffd_launches"]},
            "native-off-cold": {"compat": sum(r["cold_compat_launches"] for r in native_rows),
                                "ffd": sum(r["cold_ffd_launches"] for r in native_rows)},
            "native-off-warm": {"compat": sum(r["compat_launches"] for r in native_rows),
                                "ffd": sum(r["ffd_launches"] for r in native_rows)},
            "restored": {"compat": restart_row["compat_launches"], "ffd": restart_row["ffd_launches"]},
        },
        "compat_launches_by_tick": {"cold": legs["cold"]["compat"][:ticks], "warm": legs["warm"]["compat"][:ticks]},
        "native_off": native_rows,
        "restart": restart_row,
        "kernel_cases": kernel_cases,
        "sections_s": sections,
        "last_plan_sha256": plan_sha256(first),
        "nodes": len(first.node_plans),
        "total_price": first.total_price,
        # the JAX package's 3x warm/cold gate is a TPU number: recorded here, never asserted
        "tpu_gate_3x_met": bool(warm_p50 and cold_p50 / warm_p50 >= 3.0),
    }


# -- phase 15: disruption (bench configs 4 and 9, the controller) ------------------

N_CONFIG4 = 5_000  # bench.py config 4 (bench.py:552-602): initialized fake-it-4 nodes, one pod each
N_CONFIG9_NODES = 500  # bench.py config 9 (bench.py:1150-1460): dx-host nodes
CONFIG9_PODS_PER_NODE = 100
CONFIG9_SEED = 9  # scenario_spot_storm's seed
CONFIG9_TEAMS = 20
CONFIG9_STEADY = 5  # phase A's steady decisions
N_CONTROLLER_NODES = 40  # phase 15c's store world
CONTROLLER_SEED = 15
DISRUPT_CLOCK = 10_000.0  # tests/helpers.py Env's clock at start
SCREEN_REPLACES = {
    "prefix": "karpenter_core_tpu/disruption/tpu_repack.py:40",
    "subsets": "karpenter_core_tpu/disruption/tpu_repack.py:69",
    "singles": "karpenter_core_tpu/disruption/tpu_repack.py:102",
}


def disrupt_launches() -> dict:
    """Every kernel phase 15's paths launch, by name: the three screen
    entries (B8), the existing-node first-fit (B6), the FFD scan (B5)
    and the compat kernel."""
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    return {**{f"disrupt_screen.{k}": v.launches for k, v in sk.KERNELS.items()},
            **{k: v.launches for k, v in all_kernels().items()}}


def reset_disrupt_launches() -> None:
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    for k in [*sk.KERNELS.values(), *all_kernels().values()]:
        k.launches = 0


class same_identities:
    """Generated names, claim hostnames and uids restart inside the block
    (a counter stands in for uuid4), so two runs of one world on two
    devices give their objects the same identities: the greedy queue
    breaks ties by uid."""

    def __enter__(self):
        import itertools
        import uuid

        from karpenter_core_tpu_torch.kube import objects
        from karpenter_core_tpu_torch.scheduler import nodeclaim

        objects._sequence = itertools.count(1)
        nodeclaim._hostname_counter = itertools.count(1)
        ids = itertools.count(1)
        self.uuid4, uuid.uuid4 = uuid.uuid4, lambda: uuid.UUID(int=next(ids))
        return self

    def __exit__(self, *exc):
        import uuid

        uuid.uuid4 = self.uuid4


class DisruptWorld:
    """tests/helpers.py's ``Env`` on the port, the batched solve's and
    the screens' device ``device``: an in-memory store, the fake
    provider (``instance_types(10)``), ``Informers`` feeding a
    ``Cluster``, a ``Recorder``, a ``Provisioner`` and a
    ``DisruptionController`` (no validation wait), one NodePool
    ``default`` (consolidate when underutilized, at once, budget 100 %),
    all on a clock the world moves (``now``)."""

    def __init__(self, device: str):
        from karpenter_core_tpu_torch.apis.nodepool import CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
        from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_core_tpu_torch.disruption import DisruptionController
        from karpenter_core_tpu_torch.events import Recorder
        from karpenter_core_tpu_torch.kube.client import KubeClient
        from karpenter_core_tpu_torch.provisioning import Provisioner
        from karpenter_core_tpu_torch.state.cluster import Cluster
        from karpenter_core_tpu_torch.state.informers import Informers

        self.now = DISRUPT_CLOCK
        self.kube = KubeClient()
        self.provider = FakeCloudProvider()
        self.provider.instance_types = instance_types(10)
        self.cluster = Cluster(self.kube, self.provider, clock=self.clock)
        self.informers = Informers(self.kube, self.cluster)
        self.informers.start()
        self.recorder = Recorder()
        self.provisioner = Provisioner(self.kube, self.provider, self.cluster, recorder=self.recorder, device=device)
        self.nodepool = self.pool("default", CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED)
        self.controller = DisruptionController(
            self.kube, self.cluster, self.provisioner, self.provider, recorder=self.recorder,
            clock=self.clock, validation_sleep=lambda t: None,
        )

    def clock(self) -> float:
        return self.now

    def pool(self, name: str, policy: str):
        from karpenter_core_tpu_torch.apis.nodepool import Budget, NodePool

        np_ = NodePool()
        np_.metadata.name = name
        np_.spec.disruption.budgets = [Budget(nodes="100%")]
        np_.spec.disruption.consolidation_policy = policy
        np_.spec.disruption.consolidate_after = 0.0
        self.kube.create(np_)
        return np_

    def make_initialized_node(self, instance_type_name: str = "fake-it-4", zone: str = "test-zone-1",
                              capacity_type: str = "on-demand", pods=(), nodepool=None):
        """An initialized Node and NodeClaim of ``nodepool`` (the
        world's own by default), the ``pods`` bound to it and running."""
        from karpenter_core_tpu_torch.apis import labels as wk
        from karpenter_core_tpu_torch.apis.nodeclaim import COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED, NodeClaim
        from karpenter_core_tpu_torch.kube.objects import Node, next_name

        pool = nodepool or self.nodepool
        it = next(i for i in self.provider.get_instance_types(pool) if i.name == instance_type_name)
        provider_id = f"fake:///node-{len(self.kube.list('Node'))}"
        nc = NodeClaim()
        nc.metadata.name = f"claim-{len(self.kube.list('NodeClaim'))}"
        nc.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: pool.name, wk.LABEL_INSTANCE_TYPE: instance_type_name,
            wk.LABEL_TOPOLOGY_ZONE: zone, wk.CAPACITY_TYPE_LABEL_KEY: capacity_type,
        }
        nc.metadata.annotations = {wk.NODEPOOL_HASH_ANNOTATION_KEY: pool.static_hash()}
        nc.status.provider_id = provider_id
        nc.status.capacity = dict(it.capacity)
        nc.status.allocatable = it.allocatable()
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            nc.set_condition(cond, "True")
        self.kube.create(nc)
        self.provider.created_node_claims[provider_id] = nc
        node = Node()
        node.metadata.name = next_name("node")
        node.metadata.labels = {**nc.metadata.labels, wk.LABEL_HOSTNAME: node.metadata.name,
                                wk.NODE_REGISTERED_LABEL_KEY: "true", wk.NODE_INITIALIZED_LABEL_KEY: "true"}
        node.spec.provider_id = provider_id
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = it.allocatable()
        node.metadata.creation_timestamp = self.now - 100
        self.kube.create(node)
        for pod in pods:
            pod.spec.node_name = node.name
            pod.status.phase = "Running"
            pod.status.conditions = []
            self.kube.create(pod)
        return node, nc

    def stop(self) -> None:
        self.informers.stop()


def bound_pod(name: str, cpu: str = "100m", mem: Optional[str] = "128Mi", labels=None):
    """A pod of one container requesting ``cpu`` (and ``mem``), to be
    bound by ``make_initialized_node``."""
    from karpenter_core_tpu_torch.kube.objects import Container, Pod, PodSpec, ResourceRequirements
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    pod = Pod()
    pod.metadata.name = name
    pod.metadata.labels = dict(labels or {})
    requests = {"cpu": parse_quantity(cpu)}
    if mem is not None:
        requests["memory"] = parse_quantity(mem)
    pod.spec = PodSpec(containers=[Container(name="c", resources=ResourceRequirements(requests=requests))])
    return pod


def disrupt_cmd_key(cmd) -> tuple:
    """bench.py's ``_disrupt_cmd_key``: action, disrupted nodes,
    replacement types."""
    reps = tuple(tuple(sorted(it.name for it in r.instance_type_options)) for r in (cmd.replacements or []))
    return (cmd.action(), tuple(sorted(c.name() for c in cmd.candidates)), reps)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def config4_world(device: str, n_nodes: int = N_CONFIG4) -> DisruptWorld:
    """bench config 4's world: ``n_nodes`` initialized ``fake-it-4``
    nodes, each running one 100m / 128Mi pod, an hour on the clock."""
    w = DisruptWorld(device)
    for i in range(n_nodes):
        w.make_initialized_node("fake-it-4", pods=[bound_pod(f"r-{i}")])
    w.now += 3600.0
    if not w.cluster.synced():
        fail("config4: the cluster is not synced with its store")
    return w


def run_config4(device: str, n_nodes: int = N_CONFIG4) -> dict:
    """Phase 15a: bench config 4 whole on ``device``: ``get_candidates``
    then ``MultiNodeConsolidation.compute_command`` (the batched engine;
    the simulations on the greedy scheduler, as the bench's provisioner
    has no batched path), launches counted from 0 just before."""
    from karpenter_core_tpu_torch.disruption.helpers import get_candidates
    from karpenter_core_tpu_torch.disruption.methods import MultiNodeConsolidation

    with same_identities():
        w = config4_world(device, n_nodes)
        try:
            method = MultiNodeConsolidation(w.controller.ctx)
            reset_disrupt_launches()
            with nogc():
                t0 = time.perf_counter()
                candidates = get_candidates(w.cluster, w.kube, w.recorder, w.clock, w.provider, method.should_disrupt)
                cmd = method.compute_command(candidates)
                _sync(device)
                elapsed = time.perf_counter() - t0
            launches = disrupt_launches()
        finally:
            w.stop()
    stats = method.last_decision_stats or {}
    if cmd.action() == "no-op":
        fail("config4: 5,000 underutilized nodes and no consolidation")
    return {
        "candidates": len(candidates), "candidates_per_s": len(candidates) / elapsed,
        "disrupted": len(cmd.candidates), "action": cmd.action(), "elapsed_ms": elapsed * 1000.0,
        "decision_ms": stats.get("decision_ms"),
        "engine": {k: stats.get(k) for k in ("screen_upper_k", "repack_lower_k", "subsets_screened",
                                             "screen_feasible_subsets", "subsets_verified", "family_capped")},
        "key": disrupt_cmd_key(cmd), "kernel_launches": launches,
    }


def config9_fleet(device: str, n_nodes: int = N_CONFIG9_NODES, pods_per_node: int = CONFIG9_PODS_PER_NODE,
                  seed: int = CONFIG9_SEED):
    """bench config 9's fleet (``bench.py:disrupt_fleet``): ``n_nodes``
    initialized ``dx-host`` nodes (160 CPU, 320Gi, ``pods_per_node``
    pods; three in ten spot, two zones) under one pool with the batched
    solver and a 5 % budget, the catalog ``dx-host`` and ``dx-half``
    with spot at 0.4 of on-demand; ``scenario_spot_storm(scale=n_nodes *
    pods_per_node, teams=20, seed)`` as the stream. A pod binds first-fit
    from a start node given by its name (CRC-32, where the bench takes
    Python's per-process string hash) under 155 CPU and the pods cap →
    (world, scenario, bind_step, mutate_catalog)."""
    import zlib

    from karpenter_core_tpu_torch.apis.nodepool import Budget
    from karpenter_core_tpu_torch.cloudprovider.fake import new_instance_type, price_from_resources
    from karpenter_core_tpu_torch.cloudprovider.types import Offering
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    def catalog(price_factor: float = 1.0):
        out = []
        for name, cpu, mem, pods in (("dx-host", "160", "320Gi", str(pods_per_node)),
                                     ("dx-half", "80", "160Gi", str(max(1, pods_per_node // 2)))):
            res = {"cpu": cpu, "memory": mem, "pods": pods}
            price = price_from_resources({k: parse_quantity(v) for k, v in res.items()}) * price_factor
            out.append(new_instance_type(name, res, offerings=[
                Offering(ct, z, price * (0.4 if ct == "spot" else 1.0))
                for ct in ("spot", "on-demand") for z in ("test-zone-1", "test-zone-2")
            ]))
        return out

    w = DisruptWorld(device)
    w.provider.set_instance_types(catalog())
    w.provisioner.use_tpu_solver = True
    w.nodepool.spec.disruption.budgets = [Budget(nodes="5%")]
    w.kube.apply(w.nodepool)
    nodes = [
        w.make_initialized_node("dx-host", zone=f"test-zone-{1 + i % 2}",
                                capacity_type="spot" if i % 10 < 3 else "on-demand")[0]
        for i in range(n_nodes)
    ]
    cpu_cap_m = 155_000
    used = {n.name: [0, 0] for n in nodes}
    by_name: dict = {}

    def bind(spec) -> bool:
        cpu_m = int(str(spec.cpu)[:-1])
        start = zlib.crc32(spec.name.encode()) % n_nodes
        for j in range(n_nodes):
            node = nodes[(start + j) % n_nodes]
            u = used[node.name]
            if u[0] + cpu_m <= cpu_cap_m and u[1] < pods_per_node:
                pod = bound_pod(spec.name, spec.cpu, spec.mem, labels={"team": f"t{spec.team}"})
                pod.spec.node_name = node.name
                pod.status.phase = "Running"
                w.kube.create(pod)
                u[0] += cpu_m
                u[1] += 1
                by_name[spec.name] = (pod, node.name, cpu_m)
                return True
        return False

    def bind_step(step, create_fraction: float = 1.0) -> dict:
        removed = 0
        for name in list(step.evicts) + list(step.deletes):
            ent = by_name.pop(name, None)
            if ent is None:
                continue
            pod, node_name, cpu_m = ent
            w.kube.delete(pod)
            used[node_name][0] -= cpu_m
            used[node_name][1] -= 1
            removed += 1
        creates = step.creates[: int(len(step.creates) * create_fraction)]
        bound = sum(1 for spec in creates if bind(spec))
        return {"bound": bound, "dropped": len(creates) - bound, "removed": removed}

    storms = [0]

    def mutate_catalog() -> None:
        storms[0] += 1
        w.provider.set_instance_types(catalog(1.0 + 0.1 * (storms[0] % 3)))

    scenario = tg.scenario_spot_storm(scale=n_nodes * pods_per_node, teams=CONFIG9_TEAMS, seed=seed)
    return w, scenario, bind_step, mutate_catalog


def disrupt_decide(w: DisruptWorld, mode: str, device: str, single: bool = False):
    """bench.py's ``disrupt_decide``: one consolidation decision under
    ``mode`` (batched | sequential), a fresh method on the world's
    controller-shared engine → (command, ms, engine stats, candidates)."""
    from karpenter_core_tpu_torch.disruption.budgets import build_disruption_budgets
    from karpenter_core_tpu_torch.disruption.helpers import get_candidates
    from karpenter_core_tpu_torch.disruption.methods import MultiNodeConsolidation, SingleNodeConsolidation

    with knobs(KARPENTER_TORCH_DISRUPT_ENGINE=mode):
        ctx = w.controller.ctx
        ctx.budgets = build_disruption_budgets(w.cluster, w.kube, w.clock, w.controller.queue)
        method = (SingleNodeConsolidation if single else MultiNodeConsolidation)(ctx)
        candidates = get_candidates(w.cluster, w.kube, w.recorder, w.clock, w.provider, method.should_disrupt,
                                    w.controller.queue)
        t0 = time.perf_counter()
        cmd = method.compute_command(candidates)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1000.0
    return cmd, ms, dict(method.last_decision_stats or {}), len(candidates)


ENGINE_STAT_KEYS = ("candidates", "screen_upper_k", "repack_lower_k", "subsets_screened",
                    "screen_feasible_subsets", "subsets_verified", "family_capped")


def run_config9(device: str, n_nodes: int = N_CONFIG9_NODES, pods_per_node: int = CONFIG9_PODS_PER_NODE,
                steady: int = CONFIG9_STEADY, sequential: bool = True, churn_only: bool = False) -> dict:
    """Phase 15b: bench config 9 on ``device``. Phase A on the pods-full
    fleet (a screen-proven no-op, then ``steady`` steady decisions), phase
    B the stream's churn steps (the storm recovering at 70 %, a price
    storm after the second step), then the single-node decision. Every
    decision runs batched and, with ``sequential``, sequential; their
    command keys must be equal. ``churn_only`` skips the steady decisions
    and the single-node decision. Launches are counted from 0 just before
    the first decision. → the row, with every batched key in order
    (``keys``)."""
    with same_identities():
        t0 = time.perf_counter()
        w, scenario, bind_step, mutate_catalog = config9_fleet(device, n_nodes, pods_per_node)
        try:
            base = bind_step(scenario.steps[0])
            w.now += 3600.0
            if not w.cluster.synced():
                fail("config9: the cluster is not synced with its store")
            build_s = time.perf_counter() - t0
            keys, steps, steady_ms, churn_ms, seq_churn_ms = [], [], [], [], []

            def decide(label, single=False):
                cmd_b, ms_b, st, n = disrupt_decide(w, "batched", device, single)
                row = {"step": label, "batched_ms": ms_b, "action": cmd_b.action(),
                       "disrupted": len(cmd_b.candidates), "candidates": n,
                       **{k: st.get(k) for k in ENGINE_STAT_KEYS}, "cache": st.get("cache")}
                if sequential:
                    cmd_s, ms_s, _, _ = disrupt_decide(w, "sequential", device, single)
                    row["sequential_ms"] = ms_s
                    if disrupt_cmd_key(cmd_s) != disrupt_cmd_key(cmd_b):
                        fail(f"config9 {label}: batched {disrupt_cmd_key(cmd_b)} != sequential {disrupt_cmd_key(cmd_s)}")
                keys.append(disrupt_cmd_key(cmd_b))
                steps.append(row)
                return row

            reset_disrupt_launches()
            with nogc():
                first = decide("A0")
                if not churn_only:
                    for i in range(steady):
                        cmd, ms, st, _ = disrupt_decide(w, "batched", device)
                        steady_ms.append(ms)
                        if disrupt_cmd_key(cmd) != keys[0]:
                            fail("config9: a steady decision differs from the first")
                for i, step in enumerate(scenario.steps[1:]):
                    storm = len(step.evicts) > n_nodes * pods_per_node * 0.1
                    bind_step(step, create_fraction=0.7 if storm else 1.0)
                    if i == 1:
                        mutate_catalog()
                    w.now += 60.0
                    row = decide(f"B{i + 1}")
                    churn_ms.append(row["batched_ms"])
                    if sequential:
                        seq_churn_ms.append(row["sequential_ms"])
                if not churn_only:
                    decide("single", single=True)
            launches = disrupt_launches()
        finally:
            w.stop()
    return {
        "pods": base["bound"], "dropped": base["dropped"], "nodes": n_nodes, "steps": steps, "keys": keys,
        "build_s": build_s, "kernel_launches": launches,
        # bench config 9's steady no-op on the pods-full fleet, decided by the screen alone
        "steady_noop_screen_proven": first["action"] == "no-op" and first["screen_upper_k"] == 0,
        "steady_decision_ms": {"p50": _pctl(steady_ms, 50), "p99": _pctl(steady_ms, 99)} if steady_ms else None,
        "churn_decision_ms": {"p50": _pctl(churn_ms, 50), "p99": _pctl(churn_ms, 99)},
        "churn_sequential_ms": ({"p50": _pctl(seq_churn_ms, 50), "p99": _pctl(seq_churn_ms, 99)}
                                if seq_churn_ms else None),
    }


def controller_world(device: str, n_nodes: int = N_CONTROLLER_NODES, seed: int = CONTROLLER_SEED) -> DisruptWorld:
    """Phase 15c's store world: ``n_nodes`` nodes of ``fake-it-2`` ..
    ``fake-it-8`` across two zones, three in ten spot, carrying 0-5 bound
    pods (100m to 900m) in three pools: ``default`` (underutilized:
    consolidation; one claim's pool hash stale: drift), ``spare``
    (``expire_after`` 30 min: expiration) and ``empty`` (consolidate when
    empty, two empty nodes: emptiness); the provider reports no drift of
    its own; an hour on the clock."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import CONSOLIDATION_POLICY_WHEN_EMPTY, CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED

    rng = np.random.RandomState(seed)
    w = DisruptWorld(device)
    w.provider.drifted = ""
    spare = w.pool("spare", CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED)
    spare.spec.disruption.expire_after = 1800.0
    w.kube.apply(spare)
    empty = w.pool("empty", CONSOLIDATION_POLICY_WHEN_EMPTY)
    for i in range(n_nodes):
        pool = spare if rng.rand() < 0.2 else w.nodepool
        pods = [bound_pod(f"p-{i}-{j}", f"{int(rng.choice([100, 200, 400, 900]))}m", None)
                for j in range(int(rng.randint(0, 6)))]
        w.make_initialized_node(f"fake-it-{int(rng.randint(2, 9))}", zone=f"test-zone-{1 + int(rng.randint(2))}",
                                capacity_type="spot" if rng.rand() < 0.3 else "on-demand", pods=pods,
                                nodepool=pool)
    for _ in range(2):
        w.make_initialized_node("fake-it-3", nodepool=empty)
    claims = sorted((nc for nc in w.kube.list("NodeClaim") if nc.metadata.labels[wk.NODEPOOL_LABEL_KEY] == "default"),
                    key=lambda nc: nc.metadata.name)
    stale = claims[int(rng.randint(len(claims)))]
    stale.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = "stale"
    w.kube.apply(stale)
    for pool in w.kube.list("NodePool"):
        pool.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = pool.static_hash()
        w.kube.apply(pool)
    w.now += 3600.0
    if not w.cluster.synced():
        fail("controller-e2e: the cluster is not synced with its store")
    return w


def run_controller_e2e(device: str, n_nodes: int = N_CONTROLLER_NODES) -> dict:
    """Phase 15c: ``NodeClaimDisruptionController.reconcile_all``, then
    ``DisruptionController.reconcile`` until it returns nothing, then
    ``OrchestrationQueue.reconcile``, on the batched solver → the
    executed methods and the store: conditions, taints, claims, deletion
    marks, events, the disruption metric samples; launches counted from 0
    just before the first reconcile."""
    from karpenter_core_tpu_torch.apis.nodeclaim import COND_EMPTY
    from karpenter_core_tpu_torch.disruption import NodeClaimDisruptionController
    from karpenter_core_tpu_torch.metrics import Metrics

    with same_identities():
        w = controller_world(device, n_nodes)
        try:
            w.provisioner.use_tpu_solver = True
            metrics = Metrics()
            w.controller.metrics = w.controller.queue.metrics = metrics
            reset_disrupt_launches()
            t0 = time.perf_counter()
            NodeClaimDisruptionController(w.kube, w.provider, w.cluster, clock=w.clock).reconcile_all()
            for nc in w.kube.list("NodeClaim"):
                # conditions carry wall-clock stamps; the world runs on its own clock
                cond = nc.get_condition(COND_EMPTY)
                if cond is not None:
                    cond.last_transition_time = w.now - 60.0
            passes = []
            for _ in range(3 * n_nodes):
                done = w.controller.reconcile()
                passes.append(done)
                if done is None:
                    break
            w.controller.queue.reconcile()
            _sync(device)
            elapsed = time.perf_counter() - t0
            launches = disrupt_launches()
            store = {
                "passes": passes,
                "conditions": sorted((nc.metadata.name, sorted((c.type, c.status) for c in nc.status.conditions))
                                     for nc in w.kube.list("NodeClaim")),
                "taints": sorted((n.metadata.name, sorted((t.key, t.value, t.effect) for t in n.spec.taints))
                                 for n in w.kube.list("Node")),
                "claims": sorted((nc.metadata.name, sorted(nc.metadata.labels.items()),
                                  sorted((r.key, r.operator, tuple(sorted(r.values))) for r in nc.spec.requirements),
                                  nc.metadata.deletion_timestamp is not None)
                                 for nc in w.kube.list("NodeClaim")),
                "marked": sorted(pid for pid, n in w.cluster.nodes.items() if n.marked_for_deletion),
                "events": sorted((e.type, e.reason, getattr(e.involved_object, "name", ""), e.message)
                                 for e in w.recorder.events),
                "actions": sorted(metrics.disruption_actions.values.items()),
                "eligible": sorted(metrics.eligible_nodes.values.items()),
                "subsets": sorted(metrics.disruption_subsets.values.items()),
                "disrupted": sorted(metrics.nodeclaims_disrupted.values.items()),
            }
        finally:
            w.stop()
    methods = {m for m in passes if m}
    if not {"expiration", "drift", "emptiness", "consolidation"} <= methods:
        fail(f"controller-e2e: the passes {passes} miss a method")
    return {"store": store, "elapsed_ms": elapsed * 1000.0, "kernel_launches": launches,
            "passes": passes, "actions": store["actions"]}


def _screen_formula_library(kind: str, args):
    """The reference's formula as one PyTorch expression on the card
    (``torch.cumsum`` / ``masks.float() @ loads.float()``): the yardstick
    of ``library_ms``, never called on the port's path."""
    import torch

    if kind == "subsets":
        masks, loads, free, fleet, cap = args
        m = masks.float()
        return (m @ loads.float() <= fleet.float()[None] + (1.0 - m) @ free.float() + cap.float()[None]).all(-1)
    loads, free, fleet, cap = args
    lf, ff = loads.float(), free.float()
    if kind == "prefix":
        surv = ff.sum(0)[None] - torch.cumsum(ff, 0)
        return (torch.cumsum(lf, 0) <= fleet.float()[None] + surv + cap.float()[None]).all(-1)
    return (lf <= fleet.float()[None] + (ff.sum(0)[None] - ff) + cap.float()[None]).all(-1)


def screen_chain_adds(kind: str, N: int, R: int) -> int:
    """The longest chain of dependent float32 adds one screen call runs in
    disrupt_screen.cu: a subset row walks the N candidates once for each
    chunk of 8 columns, the prefix pass and a single row's total walk
    them once (the prefix twice past one tile of shared memory, which no
    shape here reaches)."""
    return N * max(1, -(-R // 8)) if kind == "subsets" else N


def screen_kernel_case(kind: str, call, path: str, sm_mhz: float, reps: int = 20) -> dict:
    """One screen call against its plain version on the card, bit for bit,
    with the kernel's time, the plain version's, the reference formula's
    as one PyTorch expression (and whether it agrees), the bound, the
    chain (``chain_ms``: ``screen_chain_adds`` dependent float32 adds at
    FADD_CYCLES cycles each, at the maximum SM clock ``sm_mhz``; an
    assumption, not a measurement), and the largest float32 partial sum
    of the inputs (above 2^24 the order of the additions can move a
    verdict). ``path``: where the call was captured, or "synthetic"."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    args = tuple(a.cuda() for a in call)
    fn = {"prefix": sk.screen_prefix, "subsets": sk.screen_subsets, "singles": sk.screen_singles}[kind]
    plain = {"prefix": sk.prefix_screen_reference, "subsets": sk.subset_screen_reference,
             "singles": sk.single_screen_reference}[kind]
    before = sk.KERNELS[kind].launches
    got = fn(*args)
    t0 = time.perf_counter()
    want = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not torch.equal(got, want):
        fail(f"disrupt_screen {kind} differs from its plain version at {[tuple(a.shape) for a in args]}")
    kernel_ms = events_ms(lambda: fn(*args), reps)
    library_ms = events_ms(lambda: _screen_formula_library(kind, args), reps)
    library_agrees = bool(torch.equal(_screen_formula_library(kind, args), got))
    sk.KERNELS[kind].launches = before  # the comparison's launches are not the path's
    loads, free = args[-4], args[-3]
    N, R = loads.shape
    rows = args[0].shape[0] if kind == "subsets" else N
    bytes_moved = 2 * N * R * 4 + 2 * R * 4 + rows + (rows * N if kind == "subsets" else 0)
    ops = {"prefix": 6 * N * R, "singles": 5 * N * R, "subsets": 4 * rows * N * R}[kind]
    max_sum = float(max(loads.double().sum(0).max().item(), free.double().sum(0).max().item())) if N else 0.0
    chain = screen_chain_adds(kind, N, R)
    return {
        "entry": kind, "captured": path, "rows": rows, "N": N, "R": R, "max_abs_err": 0,
        "true_rows": int(got.sum()), "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_agrees": library_agrees, "max_partial_sum": max_sum, "above_2_24": max_sum >= 2.0**24,
        "chain_adds": chain, "chain_ms": chain * FADD_CYCLES / (sm_mhz * 1e3),
        **bound_row(bytes_moved, ops),
    }


SYNTHETIC_SCREENS = (("subsets", 8193, 1000, 3), ("subsets", 999, 1000, 8), ("prefix", 0, 1000, 8),
                     ("prefix", 0, 4097, 3))


def synthetic_screen_calls(seed: int = 14) -> list:
    """Screen calls past the captured shapes, on the CPU: the subset family
    at its cap (``FAMILY_MAX`` + 1 = 8,193 rows × 1,000 candidates, its
    first 999 rows prefixes as the engine's family begins), 8 columns at
    config 4's 999 × 1,000, and the prefix at 1,000 × 8 and 4,097 × 3;
    loads and free below 2^29 (a quantized memory column), so partial sums
    pass 2^24. → [(kind, call)]."""
    import torch

    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = []
    for kind, S, N, R in SYNTHETIC_SCREENS:
        loads = rng.randint(0, 1 << 29, (N, R)).astype(np.int32)
        free = rng.randint(0, 1 << 29, (N, R)).astype(np.int32)
        fleet = rng.randint(0, 1 << 30, R).astype(np.int32)
        cap = rng.randint(0, 1 << 30, R).astype(np.int32)
        if kind == "prefix":
            out.append((kind, (t(loads), t(free), t(fleet), t(cap))))
            continue
        masks = (rng.rand(S, N) < 0.5).astype(np.uint8)
        masks[: N - 1] = np.tril(np.ones((N, N), dtype=np.uint8))[1:]
        out.append((kind, (t(masks), t(loads), t(free), t(fleet), t(cap))))
    return out


class capture_screens:
    """Capture every screen call (the three wrappers' tensors, on the CPU)
    inside the block, by entry."""

    def __enter__(self):
        from karpenter_core_tpu_torch.disruption import screen_kernels as sk

        self.caps = {kind: capture(sk, f"screen_{kind}") for kind in ("prefix", "subsets", "singles")}
        for c in self.caps.values():
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in self.caps.values():
            c.__exit__(*exc)

    def calls(self) -> dict:
        return {kind: c.calls for kind, c in self.caps.items()}


def run_disruption_phase(device: str = "cuda", sizes: Optional[dict] = None, sm_mhz: float = 0.0) -> dict:
    """Phase 15 on ``device`` with the warm state on: 15a bench config 4
    (also with ``KARPENTER_TORCH_NATIVE=0``: the repack bound on B6),
    15b bench config 9 (batched against sequential every decision; the
    churn steps again with ``KARPENTER_TORCH_NATIVE=0``: B6 and the FFD
    scan), 15c the controller end to end; each against a CPU run of the
    same world (15b's CPU leg batched only, its steady decisions left
    out). On the card, 15d holds every distinct captured screen call and
    the synthetic ones (``synthetic_screen_calls``) against its plain
    version; ``sm_mhz``, the maximum SM clock, prices their chains.
    ``sizes``: {"config4": n_nodes, "config9": (n_nodes, pods_per_node),
    "controller": n_nodes} → the phase's row."""
    sizes = {"config4": N_CONFIG4, "config9": (N_CONFIG9_NODES, CONFIG9_PODS_PER_NODE),
             "controller": N_CONTROLLER_NODES, **(sizes or {})}
    sections: dict = {}
    t_section = time.perf_counter()

    def section(name):
        nonlocal t_section
        now = time.perf_counter()
        sections[name] = now - t_section
        t_section = now

    n9, ppn = sizes["config9"]
    with capture_screens() as screens:
        config4 = run_config4(device, sizes["config4"])
        with knobs(KARPENTER_TORCH_NATIVE=0):
            config4_native_off = run_config4(device, sizes["config4"])
        section("config4_s")
        config9 = run_config9(device, n9, ppn)
        section("config9_s")
        with knobs(KARPENTER_TORCH_NATIVE=0):
            config9_native_off = run_config9(device, n9, ppn, churn_only=True)
        section("config9_native_off_s")
        controller = run_controller_e2e(device, sizes["controller"])
        section("controller_s")
    # the same worlds on the CPU (the C++ packer; the card's native-off
    # legs are held to the same commands)
    cpu4 = run_config4("cpu", sizes["config4"])
    for label, row in (("config4", config4), ("config4-native-off", config4_native_off)):
        if (row["key"], row["engine"]) != (cpu4["key"], cpu4["engine"]):
            fail(f"{label}: the card's command {row['key'][:1]} {row['engine']} differs from the CPU's "
                 f"{cpu4['key'][:1]} {cpu4['engine']}")
    section("cpu_config4_s")
    cpu9 = run_config9("cpu", n9, ppn, steady=0, sequential=False)
    if cpu9["keys"] != config9["keys"]:
        fail(f"config9: the card's commands {config9['keys']} differ from the CPU's {cpu9['keys']}")
    churn_keys = config9["keys"][:-1]
    if config9_native_off["keys"] != churn_keys:
        fail(f"config9 native off: {config9_native_off['keys']} differ from the C++ packer's {churn_keys}")
    section("cpu_config9_s")
    cpu_ctrl = run_controller_e2e("cpu", sizes["controller"])
    if cpu_ctrl["store"] != controller["store"]:
        diff = [k for k in controller["store"] if controller["store"][k] != cpu_ctrl["store"][k]]
        fail(f"controller-e2e: the card's effects differ from the CPU's in {diff}")
    section("cpu_controller_s")
    # 15d: every distinct captured screen shape against its plain version
    cases = []
    if device == "cuda":
        if sm_mhz <= 0:
            fail("phase 15d needs the card's maximum SM clock to price the screens' chains")
        for kind, calls in screens.calls().items():
            for call in distinct_shapes(calls):
                cases.append(screen_kernel_case(kind, call, "phase15", sm_mhz))
        if {c["entry"] for c in cases} != {"prefix", "subsets", "singles"}:
            fail(f"phase 15 captured no call of some screen entry: {sorted({c['entry'] for c in cases})}")
        for kind, call in synthetic_screen_calls():
            cases.append(screen_kernel_case(kind, call, "synthetic", sm_mhz))
    section("kernel_cases_s")
    return {
        "config4": config4, "config4_native_off": config4_native_off, "config9": config9,
        "config9_native_off": config9_native_off, "controller": controller, "screen_cases": cases,
        "sections_s": sections,
        "launches": {
            "config4": config4["kernel_launches"], "config4-native-off": config4_native_off["kernel_launches"],
            "config9": config9["kernel_launches"], "config9-native-off": config9_native_off["kernel_launches"],
            "controller-e2e": controller["kernel_launches"],
        },
    }


def screen_kernel_entry(cases: list, launches: dict) -> dict:
    """B8's entry of the kernels line: its launches on phase 15's paths,
    by path and by entry point, and the numbers of its largest captured
    subset case (bench config 4's family), each entry's largest captured
    case beside them; the synthetic cases in ``cases``."""
    kinds = ("prefix", "subsets", "singles")
    keys = ("rows", "N", "R", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "chain_ms")
    by_path = {path: sum(n[f"disrupt_screen.{k}"] for k in kinds) for path, n in launches.items()}
    captured = [c for c in cases if c["captured"] != "synthetic"]
    entries = {}
    for kind in kinds:
        rows = [c for c in captured if c["entry"] == kind]
        big = max(rows, key=lambda r: r["rows"] * r["N"])
        entries[kind] = {
            "replaces": SCREEN_REPLACES[kind],
            "launches": sum(n[f"disrupt_screen.{kind}"] for n in launches.values()),
            **{k: big[k] for k in keys},
            "synthetic": [{k: c[k] for k in keys} for c in cases if c["captured"] == "synthetic" and c["entry"] == kind],
        }
    main = max((c for c in captured if c["entry"] == "subsets"), key=lambda r: r["rows"] * r["N"])
    return {
        "name": "disrupt_screen", "route": "cuda", "source": "karpenter_core_tpu_torch/csrc/disrupt_screen.cu",
        "replaces": SCREEN_REPLACES["subsets"], "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "chain_ms": main["chain_ms"], "entries": entries, "cases": cases,
    }


def main() -> None:
    import torch

    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        from karpenter_core_tpu_torch import native
        from karpenter_core_tpu_torch.disruption import screen_kernels as sk
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
    with ThreadPoolExecutor(max_workers=6) as pool:
        kernel_build = pool.submit(ck.COMPAT_ALLOWED.build)
        packer_build = pool.submit(native.build)
        pack_builds = {name: pool.submit(k.build) for name, k in pack_kernels().items()}
        # the three screen entry points share one source and one library
        pack_builds["disrupt_screen"] = pool.submit(sk.SCREEN_SUBSETS.build)
        (kernel_lib, kernel_log), (packer_lib, _) = kernel_build.result(), packer_build.result()
        pack_libs = {name: f.result() for name, f in pack_builds.items()}
    build_s = time.perf_counter() - t0
    emit({"build_s": build_s, "kernel_lib": kernel_lib, "packer_lib": packer_lib,
          "kernel_libs": {name: lib for name, (lib, _) in pack_libs.items()}})
    for line in kernel_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    usage = ptxas_usage(kernel_log)
    emit({"ptxas": usage})
    if len(usage) != 2:
        fail(f"ptxas reported {sorted(usage)}, not both tile instantiations")
    for name, (_, log) in pack_libs.items():
        emit({"ptxas_" + name: [
            line.strip() for line in log.splitlines()
            if "entry function" in line or "registers" in line or "spill" in line
        ]})

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
    probe_catalog = ck.catalog_to_device(
        sp["tm"], sp["th"], sp["tn"], sp["keys"], sp["avail"], torch.device("cuda")
    )
    emit({"profiler_probe": profiler_probe(
        probe_catalog, ck.signature_side(sp["sig"], sp["zone_ok"], sp["ct_ok"], probe_catalog)
    )})
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
    # the compat shapes of phases 8 and 9, from their own worlds
    affinity_rows = [
        kernel_case(
            "config6 7k x 400", slice_planes(*config6_world()), reps=200, plain_reps=20,
            sm_mhz=sm_mhz, profiled=True,
        ),
        kernel_case(
            "anti-dense 10k x 200", slice_planes(*anti_dense_world()[:3]), reps=200,
            plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ),
        kernel_case(
            "anti-cluster 10k x 2000", slice_planes(*anti_cluster_world()[:3]), reps=200,
            plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ),
    ]
    # the compat shapes of phase 10, from their own worlds, claims pinned
    stateful_rows = []
    for label, world in (
        ("stateful-dense 10k x 200", stateful_dense_world),
        ("spread-skew 10k x 200", spread_skew_world),
        ("stateful-cluster 10.25k x 2000", stateful_cluster_world),
    ):
        w = world()
        stateful_rows.append(kernel_case(
            label, slice_planes(*w[:3], kube=w[6]), reps=200, plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ))
    # the compat shapes of phase 11's tensor passes, from their own worlds
    relax_rows = []
    for label, world in (
        ("oracle-mix 7.34k x 400", oracle_mix_world),
        ("oracle-cluster 7.34k x 2000", oracle_cluster_world),
        ("relax-cluster 50k x 2000", relax_cluster_world),
    ):
        w = world()
        relax_rows.append(kernel_case(
            label, slice_planes(*w[:3], kube=w[6]), reps=200, plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ))
    # the compat shapes of phase 14: bench config 7's world whole, and the
    # signatures of four of its teams alone (a warm tick's missing subset)
    c7 = Config7()
    c7_subset = [p for p in c7.pods if p.metadata.labels["bench-team"] in ("t0", "t1", "t2", "t3")]
    config7_rows = [
        kernel_case(
            label, slice_planes([c7.pool], c7.provider, c7_pods), reps=200, plain_reps=20,
            sm_mhz=sm_mhz, profiled=True,
        )
        for label, c7_pods in (("config7 10k x 500", c7.pods), ("config7 4-team subset x 500", c7_subset))
    ]
    del c7, c7_subset
    big_row = kernel_case(
        "S=8192 x T=2048",
        random_planes(np.random.RandomState(1), 8192, 2048, widths), reps=20, plain_reps=5,
        sm_mhz=sm_mhz, profiled=True, clock_launches=2000,
    )

    emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 3"})
    # phases 4-13 measure the cold pipeline: the warm state off, so their
    # repeated solves of one batch stay pipeline solves (phase 14 runs it)
    with knobs(KARPENTER_TORCH_INCREMENTAL=0):
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

        # 8. bench config 6 whole; 9. config 13's anti_dense and a zone
        # quorum against the cluster and its kube store
        config6 = run_config6_phase("cuda")
        anti_dense, anti_cluster = run_anti_phase("cuda")

        # 10. config 13's stateful_dense and spread_skew, and the stateful
        # cluster: host ports, CSI limits and zone-pinned claims
        stateful_dense, spread_skew, stateful_cluster = run_stateful_phase("cuda")

        # 11. the greedy scheduler alone (bench config 1, host only), the
        # greedy fallback beside the tensor path (config 6 and Helm releases
        # with the soft anti-affinity preset, as built and against the
        # cluster), preference relaxation against the cluster under a zone
        # drought, and packing parity against the greedy scheduler
        config1 = run_config1_phase()
        oracle_mix, oracle_cluster = run_oracle_phase("cuda")
        relax_cluster = run_relax_phase("cuda")
        parity6, parity1 = run_parity_phase("cuda")
        emit({"phase11": {
            "config1_pods_per_s": config1["pods_per_s"],
            "packing_parity_vs_oracle": {
                "config6_subsample": parity6["packing_parity_vs_oracle"],
                "config1": parity1["packing_parity_vs_oracle"],
            },
            "card": card,
        }})

        emit({"elapsed_s": time.perf_counter() - t_start, "before": "phase 12"})
        # 12. the pack engines on the card: the device FFD scan and the
        # existing-node first-fit (native packer off) on config 3 whole and on
        # phase 5's cluster, the LP backend on bench config 10 whole and on
        # config 5 whole (one relaxation over 2,000 types)
        pack = run_pack_phase("cuda")
        emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 12 paths"})
        for r in pack["paths"]:
            emit({"phase12": r["path"], **{k: v for k, v in r.items() if k != "path"}, "card": card})
        emit({"phase12": "config10", **{k: v for k, v in pack["config10"].items() if k != "rows"}, "card": card})
        for r in pack["config10"]["rows"]:
            emit({"phase12_config10_shape": r["shape"], **{k: v for k, v in r.items() if k != "shape"}})
        emit({"phase12": "config10-device-scan", "rows": pack["config10_device"]})
        cases = {"ffd_pack": [], "pack_existing": [], "dual_ascent": []}
        for call in distinct_shapes(pack["ffd_calls"]):
            cases["ffd_pack"].append(ffd_kernel_case(call))
        for call in distinct_shapes(pack["existing_calls"]):
            cases["pack_existing"].append(existing_kernel_case(call))
        for call in distinct_shapes(pack["dual_calls"]):
            cases["dual_ascent"].append(dual_kernel_case(call))
        for name, rows in cases.items():
            if not rows:
                fail(f"no {name} call was captured on the main paths")
        scan_case = {"ffd_pack": ffd_kernel_case, "pack_existing": existing_kernel_case}
        for name, calls in synthetic_scan_calls().items():
            cases[name] += [{"synthetic": label, **scan_case[name](call)} for label, call in calls]
        cases["dual_ascent"] += [{"synthetic": label, **dual_kernel_case(call)} for label, call in synthetic_dual_calls()]
        for name, rows in cases.items():
            for row in rows:
                emit({"pack_kernel_case": name, **row, "card": card})
        # lp.relax around the kernel: uploads, kernel, downloads, host bound
        relax_splits = {}
        for label, calls in pack["relax_calls"].items():
            if not calls:
                fail(f"no lp.relax call was captured on the {label} path")
            relax_splits[label] = relax_split(calls[0])
            emit({"relax_split": label, **relax_splits[label], "card": card})
        emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 12"})

        # 13. the provisioner entry: Provisioner.reconcile over a live store on
        # bench config 2, phase 5's cluster (C++ packer and device scans) and
        # the anti-affinity / greedy-fallback world
        prov = run_provisioner_phase("cuda")
        prov_rows = {"provisioner-config2": prov["config2"], **{
            f"provisioner-{k}": v for k, v in prov["rows"].items()
        }, "provisioner-anti-cluster-oracle": prov["guard"]}
        for path, row in prov_rows.items():
            pack["launches"][path] = {name: row["kernel_launches"][name] for name in cases}
        cases["pack_existing"].append({"captured": "provisioner-cluster-device", **prov["existing_case"]})
        emit({"pack_kernel_case": "pack_existing", **cases["pack_existing"][-1], "card": card})
        emit({"phase13": {path: {k: row[k] for k in (
            "reconcile_ms", "solve_ms", "span_snapshot_nodes_ms", "span_pending_pods_ms", "span_solve_ms",
            "span_create_node_claims_ms", "claims", "nominated_pods", "kernel_launches",
        )} for path, row in prov_rows.items()}, "card": card})
        emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 13"})

    # 14. bench config 7's ticks: the cross-tick warm state on the card
    config7 = run_config7_phase("cuda")
    emit({"phase14": "config7-ticks", **{k: v for k, v in config7.items() if k not in ("native_off", "kernel_cases")},
          "card": card})
    for r in config7["native_off"]:
        emit({"phase14_native_off_tick": r["tick"], **r, "card": card})
    for r in config7["kernel_cases"]["compat_allowed"]:
        emit({"compat_case": "config7-captured", **r, "card": card})
    for r in config7["kernel_cases"]["ffd_pack"]:
        cases["ffd_pack"].append({"captured": "config7-native-off", **r})
        emit({"pack_kernel_case": "ffd_pack", **cases["ffd_pack"][-1], "card": card})
    emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 14"})

    # 15. disruption on the card, the warm state on: bench config 4 and
    # config 9 whole, the controller end to end, every screen shape
    disrupt = run_disruption_phase("cuda", sm_mhz=sm_mhz)
    c4, c9 = disrupt["config4"], disrupt["config9"]
    emit({"phase15": "config4-consolidation", **{k: v for k, v in c4.items() if k != "key"},
          "native_off_kernel_launches": disrupt["config4_native_off"]["kernel_launches"], "card": card})
    emit({"phase15": "config9-disruption", **{k: v for k, v in c9.items() if k not in ("keys", "steps")},
          "identical_decisions": len(c9["keys"]), "card": card})
    for row in c9["steps"]:
        emit({"phase15_config9_step": row["step"], **row, "card": card})
    emit({"phase15": "config9-native-off", **{k: v for k, v in disrupt["config9_native_off"].items()
                                               if k not in ("keys", "steps")}, "card": card})
    for row in disrupt["config9_native_off"]["steps"]:
        emit({"phase15_config9_native_off_step": row["step"], **row, "card": card})
    emit({"phase15": "controller-e2e", **{k: v for k, v in disrupt["controller"].items() if k != "store"},
          "card": card})
    for r in disrupt["screen_cases"]:
        emit({"screen_case": r["entry"], **r, "card": card})
    emit({"phase15_sections_s": disrupt["sections_s"]})
    # every kernel a phase-15 path runs was launched on it
    for path, want in (("config4", ("disrupt_screen.prefix", "disrupt_screen.subsets")),
                       ("config4-native-off", ("disrupt_screen.subsets", "pack_existing")),
                       ("config9", ("disrupt_screen.prefix", "disrupt_screen.subsets", "disrupt_screen.singles",
                                    "compat_allowed")),
                       ("config9-native-off", ("disrupt_screen.subsets", "pack_existing", "compat_allowed")),
                       ("controller-e2e", ("disrupt_screen.prefix", "disrupt_screen.subsets",
                                           "disrupt_screen.singles", "compat_allowed"))):
        missing = [k for k in want if not disrupt["launches"][path][k]]
        if missing:
            fail(f"phase 15 {path}: {missing} never launched ({disrupt['launches'][path]})")
    for path, n in disrupt["launches"].items():
        pack["launches"][f"phase15-{path}"] = {name: n[name] for name in ("ffd_pack", "pack_existing", "dual_ascent")}
    emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 15"})

    # the kernels line, then the last line
    paths = {
        "slice": slice_launches, "cluster": cluster["kernel_launches"],
        "config3": config3["kernel_launches"], "cluster-spread": cluster_spread["kernel_launches"],
        "config6": config6["kernel_launches"], "anti-dense": anti_dense["kernel_launches"],
        "anti-cluster": anti_cluster["kernel_launches"],
        "stateful-dense": stateful_dense["kernel_launches"], "spread-skew": spread_skew["kernel_launches"],
        "stateful-cluster": stateful_cluster["kernel_launches"],
        "oracle-mix": oracle_mix["kernel_launches"], "oracle-cluster": oracle_cluster["kernel_launches"],
        "relax-cluster": relax_cluster["kernel_launches"],
        "parity-config6": parity6["kernel_launches"], "parity-config1": parity1["kernel_launches"],
        **{path: row["kernel_launches"]["compat_allowed"] for path, row in prov_rows.items()},
        **{f"config7-{leg}": n["compat"] for leg, n in config7["launches"].items()},
        **{f"phase15-{path}": n["compat_allowed"] for path, n in disrupt["launches"].items()},
    }
    for leg, n in config7["launches"].items():
        pack["launches"][f"config7-{leg}"] = {"ffd_pack": n["ffd"], "pack_existing": 0, "dual_ascent": 0}
    path_keys = (
        "shape", "S", "T", "W", "kernel_ms", "profiled_kernel_ms", "wrapper_ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by", "max_abs_err",
    )
    emit(
        {
            "kernels": [
                {
                    "name": "compat_allowed",
                    "route": "cuda",
                    "source": "karpenter_core_tpu_torch/csrc/compat_allowed.cu",
                    "replaces": "karpenter_core_tpu/solver/pallas_kernels.py:118",
                    "launches": sum(paths.values()),
                    "launches_by_path": paths,
                    "max_abs_err": max(
                        [row["max_abs_err"] for row in [
                            slice_row, big_row, *spread_rows, *affinity_rows, *stateful_rows, *relax_rows,
                            *config7_rows, *config7["kernel_cases"]["compat_allowed"],
                        ]] + [prov["compat_err"]]
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
                    "at_spread_paths": [{k: row[k] for k in path_keys} for row in spread_rows],
                    "at_affinity_paths": [{k: row[k] for k in path_keys} for row in affinity_rows],
                    "at_stateful_paths": [{k: row[k] for k in path_keys} for row in stateful_rows],
                    "at_relax_paths": [{k: row[k] for k in path_keys} for row in relax_rows],
                    "at_config7_paths": [{k: row[k] for k in path_keys} for row in config7_rows],
                    "config7_captured": config7["kernel_cases"]["compat_allowed"],
                    "compat_route": slice_row["compat_route"],
                    "ptxas": usage,
                },
                *[pack_kernel_entry(name, cases[name], pack["launches"],
                                    relax_splits if name == "dual_ascent" else None) for name in cases],
                screen_kernel_entry(disrupt["screen_cases"], {
                    f"phase15-{path}": n for path, n in disrupt["launches"].items()
                }),
            ]
        }
    )
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--log"] and len(sys.argv) == 3:
        LOG_PATH = sys.argv[2]
        os.makedirs(os.path.dirname(os.path.abspath(LOG_PATH)), exist_ok=True)
    elif sys.argv[1:]:
        fail(f"usage: {sys.argv[0]} [--log PATH]")
    main()
