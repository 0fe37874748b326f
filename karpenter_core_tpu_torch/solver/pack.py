"""Bin-packing: K-open first-fit-decreasing, on the C++ packer or the card.

Counterpart of ``karpenter_core_tpu/solver/pack.py``. The oracle packs
each pod into the open claim with the fewest pods that still fits
(scheduler.go:247-254), where "fits" means *some* instance type can hold
the claim's accumulated requests. A claim's viable type set is fully
determined by its accumulated usage, so per-node state collapses to a
usage vector checked against the Pareto frontier of the viable
allocatable vectors.

Two engines, chosen as the JAX package chooses them (``engine=``):

- ``native``: the port's C++ packer (``native/pack.cc``) at K = min(1024,
  P) open slots, and its existing-node first-fit. ``auto`` takes it
  unless ``KARPENTER_TORCH_NATIVE=0``.
- ``device``: the scans on the scheduler's device at the reference's
  K = 16 (``ffd_pack_batched``, ``pack_existing``): on a CUDA tensor the
  Hopper kernels ``csrc/ffd_pack.cu`` and ``csrc/pack_existing.cu``, on a
  CPU tensor their plain PyTorch versions (``ffd_pack_reference``,
  ``pack_existing_reference``). K = 16 evicts slots the native K = 1024
  keeps open, so the two engines' plans differ, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import buildlib, native
from ..tracing import deviceplane
from . import devicetime
from .backend import resolve_device
from .contracts import contract

INT_INF = np.int32(2**31 - 1)
# open slots of the device scan: the JAX package's ffd_pack default
K_OPEN = 16

# open-slot bound of the native packer — the JAX package's
# KARPENTER_TPU_K_OPEN default (pack.py:43-46): K=1024 reproduces the
# oracle's keep-everything-open greedy, and the fit scan exits early
NATIVE_K_OPEN = 1024


@contract("T R", out="F R", eval_shape=False)
def pareto_frontier(allocatable: np.ndarray) -> np.ndarray:
    """Maximal points of the viable types' allocatable vectors (F, R).
    A usage vector fits some type iff it fits some frontier point."""
    if len(allocatable) == 0:
        return np.zeros((1, allocatable.shape[1] if allocatable.ndim == 2 else 0), dtype=np.int32)
    pts = np.unique(allocatable, axis=0)  # unique also sorts — ties deduped
    # incremental scan sorted by total size desc: each point only needs a
    # dominance check against the (small) kept frontier; the frontier
    # lives in a doubling buffer
    order = np.argsort(-pts.sum(axis=1, dtype=np.int64))
    buf = np.empty((8, pts.shape[1]), dtype=pts.dtype)
    n = 0
    for i in order:
        p = pts[i]
        if n and bool(np.any(np.all(buf[:n] >= p, axis=1))):
            continue  # dominated (strictness guaranteed: duplicates removed)
        if n == len(buf):
            buf = np.concatenate([buf, np.empty_like(buf)])
        buf[n] = p
        n += 1
    return buf[:n].astype(np.int32)


def pad_for_pack(requests: np.ndarray, frontier: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad pod and frontier counts to power-of-two buckets. Padding pods
    get requests larger than any frontier point → they emit node_id=-1
    without touching pack state; padding frontier rows are all-zero →
    never fit (requests include pods ≥ 1)."""
    P, R = requests.shape
    P_pad = max(128, 1 << (P - 1).bit_length())
    F_pad = 1 << (len(frontier) - 1).bit_length() if len(frontier) > 1 else 1
    fmax = frontier.max(axis=0)
    if P_pad > P:
        sentinel = np.broadcast_to(fmax + 1, (P_pad - P, R)).astype(np.int32)
        requests = np.concatenate([requests, sentinel])
    if F_pad > len(frontier):
        frontier = np.concatenate(
            [frontier, np.zeros((F_pad - len(frontier), R), dtype=np.int32)]
        )
    return requests, frontier, P


@contract("P R", "P", "()", out="N R", eval_shape=False)
def node_usage_from_assignment(
    requests: np.ndarray, node_ids: np.ndarray, node_count: int
) -> np.ndarray:
    """Segment-sum pod requests by assigned node → (N, R) int32."""
    usage = np.zeros((node_count, requests.shape[1]), dtype=np.int64)
    valid = node_ids >= 0
    np.add.at(usage, node_ids[valid], requests[valid])
    return usage.astype(np.int32)


@contract("N R", "T R", "T", out="N", eval_shape=False)
def assign_cheapest_types(
    node_usage: np.ndarray,  # (N, R) int32 summed requests per node
    allocatable: np.ndarray,  # (T, R) int32 (viable types only)
    prices: np.ndarray,  # (T,) f64
) -> np.ndarray:
    """Per node, the cheapest viable type that holds its load — the launch
    decision the fake provider makes (fake/cloudprovider.go:105-110).
    → (N,) int32 index into the viable-type axis, -1 if none fits. On the
    C++ packer when it is on, else numpy over blocks of nodes sized so
    the (n, T, R) transient stays near 32M elements."""
    N = node_usage.shape[0]
    if N == 0 or allocatable.shape[0] == 0:
        return np.full(N, -1, dtype=np.int32)
    if native.available():
        return native.cheapest_types_native(node_usage, allocatable, prices)
    T_, R_ = allocatable.shape
    step = max(1, min(1024, 32_000_000 // max(1, T_ * R_)))
    best = np.empty(N, dtype=np.int32)
    for s in range(0, N, step):
        blk = node_usage[s : s + step]
        fits = np.all(blk[:, None, :] <= allocatable[None, :, :], axis=-1)  # (n, T)
        priced = np.where(fits, prices[None, :], np.inf)
        b = np.argmin(priced, axis=1).astype(np.int32)
        b[~fits.any(axis=1)] = -1
        best[s : s + step] = b
    return best


# -- the device FFD scan ---------------------------------------------------------

FFD_PACK = buildlib.CudaKernel(
    "ffd_pack.cu", "ffd_pack_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 4,
    helpers={"ffd_pack_scratch_ints": (ctypes.c_int64, [ctypes.c_int64] * 3)},
    name="pack.ffd_pack_batched",
)


def ffd_pack_reference(
    requests: torch.Tensor,  # (G, P, R) int32, each job sorted descending by primary
    frontiers: torch.Tensor,  # (G, F, R) int32
    caps: torch.Tensor,  # (G,) int32 per-node pod caps
    k_open: int = K_OPEN,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the device scan, all jobs side by side,
    one pod step at a time on the tensors' device: the JAX package's
    ``ffd_pack`` step, in int32 and, for the slot key, float32.
    → (node_ids (G, P) int32, -1 ⇒ unschedulable; node counts (G,))."""
    G, P, R = requests.shape
    dev = requests.device
    rows = torch.arange(G, device=dev)
    usage = torch.full((G, k_open, R), int(INT_INF), dtype=torch.int32, device=dev)
    count = torch.zeros((G, k_open), dtype=torch.int32, device=dev)
    node_id = torch.full((G, k_open), -1, dtype=torch.int32, device=dev)
    next_id = torch.zeros(G, dtype=torch.int32, device=dev)
    out = torch.full((G, P), -1, dtype=torch.int32, device=dev)
    caps = caps.to(torch.int32)[:, None]
    fmax0 = frontiers.max(dim=1).values[:, 0]
    tiny = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    int_inf = torch.tensor(int(INT_INF), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    minus_one = -one
    for p in range(P):
        req = requests[:, p]  # (G, R)
        active = node_id >= 0
        # usage <= frontier - req: no int32 overflow on the INT_INF rows
        remaining = frontiers - req[:, None, :]
        fit = (usage[:, :, None, :] <= remaining[:, None, :, :]).all(-1).any(-1)
        fit = fit & active & (count < caps)
        fresh = (req[:, None, :] <= frontiers).all(-1).any(-1)
        # fewest pods first, ties to the oldest node, in float32
        key = torch.where(fit, count.to(torch.float32) + node_id.to(torch.float32) * tiny, inf)
        k_star = key.argmin(dim=1)
        any_fit = fit[rows, k_star]
        headroom = torch.where(active, fmax0[:, None] - usage[:, :, 0], int_inf)
        k_evict = headroom.argmin(dim=1)
        k_closed = (~active).to(torch.uint8).argmax(dim=1)
        k_new = torch.where(active.all(dim=1), k_evict, k_closed)
        k_sel = torch.where(any_fit, k_star, k_new)
        open_new = ~any_fit & fresh
        do_update = any_fit | open_new
        sel_usage = usage[rows, k_sel]
        new_usage = torch.where(any_fit[:, None], sel_usage + req, req)
        new_count = torch.where(any_fit, count[rows, k_sel] + one, one)
        new_id = torch.where(any_fit, node_id[rows, k_sel], next_id)
        usage[rows, k_sel] = torch.where(do_update[:, None], new_usage, sel_usage)
        count[rows, k_sel] = torch.where(do_update, new_count, count[rows, k_sel])
        node_id[rows, k_sel] = torch.where(do_update, new_id, node_id[rows, k_sel])
        next_id = next_id + open_new.to(torch.int32)
        out[:, p] = torch.where(do_update, new_id, minus_one)
    return out, next_id


def _sorted_requests(rng, shape) -> np.ndarray:
    """Seeded pod requests in [1, 16), each job sorted descending by its
    primary then secondary resource, as the scans take them."""
    reqs = rng.randint(1, 16, size=shape).astype(np.int32)
    flat = reqs.reshape(-1, shape[-2], shape[-1])
    for job in flat:
        job[:] = job[np.lexsort((-job[:, 1], -job[:, 0]))]
    return reqs


def _ffd_batched_example(dims, rng, device):
    """The shape-contract pass's inputs for ``ffd_pack_batched``: G jobs
    of P sorted pods over F frontier rows of width R, caps in [1, 16)."""
    G, P, R, F = dims("G"), dims("P"), dims("R"), dims("F")
    reqs = _sorted_requests(rng, (G, P, R))
    fronts = rng.randint(4, 40, size=(G, F, R)).astype(np.int32)
    caps = rng.randint(1, 16, size=G).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (reqs, fronts, caps)), {}


def _ffd_example(dims, rng, device):
    """``ffd_pack``'s: one job of P sorted pods, its cap a Python int."""
    P, R, F = dims("P"), dims("R"), dims("F")
    reqs = _sorted_requests(rng, (P, R))
    front = rng.randint(4, 40, size=(F, R)).astype(np.int32)
    cap = int(rng.randint(1, 16))
    return (torch.from_numpy(reqs).to(device), torch.from_numpy(front).to(device), cap), {}


@deviceplane.observe("pack.ffd_pack_batched", static_names=("k_open",))
@contract("G P R", "G F R", "G", out=("G P", "G"), example=_ffd_batched_example, static={"k_open": K_OPEN})
def ffd_pack_batched(
    requests: torch.Tensor,  # (G, P, R) int32
    frontiers: torch.Tensor,  # (G, F, R) int32
    caps: torch.Tensor,  # (G,) int32
    k_open: int = K_OPEN,
    n_pods: Optional[torch.Tensor] = None,  # (G,) int32 real pods per job
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``ffd_pack_batched``: every job's scan, one launch
    of ``csrc/ffd_pack.cu`` on a CUDA tensor (or a raise), the plain
    version on a CPU tensor. ``n_pods`` are the jobs' real pod counts:
    the pods past them must be padding (requests above the frontier
    max), which the reference scans and the kernel skips."""
    G, P, R = requests.shape
    dev = requests.device
    if n_pods is None:
        n_pods = torch.full((G,), P, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        n = int(n_pods.max()) if G else 0
        ids, counts = ffd_pack_reference(requests[:, :n], frontiers, caps, k_open)
        return torch.nn.functional.pad(ids, (0, P - n), value=-1), counts
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    F = frontiers.shape[1]
    buildlib.check_tensor("requests", requests, torch.int32, (G, P, R), dev)
    buildlib.check_tensor("frontiers", frontiers, torch.int32, (G, F, R), dev)
    buildlib.check_tensor("caps", caps, torch.int32, (G,), dev)
    buildlib.check_tensor("n_pods", n_pods, torch.int32, (G,), dev)
    node_ids = torch.empty((G, P), dtype=torch.int32, device=dev)
    counts = torch.empty(G, dtype=torch.int32, device=dev)
    if G:
        # past what one warp's shared block holds, the slots' usage rows
        # live in device memory: K * R int32 a job
        n_scratch = FFD_PACK.lib().ffd_pack_scratch_ints(F, R, k_open)
        scratch = torch.empty(G * n_scratch, dtype=torch.int32, device=dev) if n_scratch > 0 else None
        FFD_PACK.launch(
            requests.data_ptr(), frontiers.data_ptr(), caps.data_ptr(), n_pods.data_ptr(),
            G, P, F, R, k_open, None if scratch is None else scratch.data_ptr(),
            node_ids.data_ptr(), counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, device=dev,
        )
    return node_ids, counts


@contract("P R", "F R", "()", out=("P", "()"), example=_ffd_example, static={"k_open": K_OPEN})
def ffd_pack(
    requests: torch.Tensor,  # (P, R) int32, sorted descending by primary
    frontier: torch.Tensor,  # (F, R) int32
    max_pods_per_node: int,
    k_open: int = K_OPEN,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One job's scan → (node_ids (P,) int32, node count ())."""
    cap = torch.tensor([max_pods_per_node], dtype=torch.int32, device=requests.device)
    ids, counts = ffd_pack_batched(requests[None], frontier[None], cap, k_open)
    return ids[0], counts[0]


def _pad_class(p: int) -> int:
    """Scan-length size classes: powers of two up to 4096, then 4096
    multiples — a small job never inherits the biggest job's scan length."""
    if p <= 4096:
        return max(128, 1 << (p - 1).bit_length())
    return -(-p // 4096) * 4096


def batch_pack(jobs: List[tuple], engine: str = "auto", device=None, mesh=None) -> List[Tuple[np.ndarray, int]]:
    """Pack every (requests, frontier, max_per_node) job → [(node_ids,
    node_count)] aligned with ``jobs``.

    ``auto`` takes the C++ packer at K = min(1024, P) unless
    ``KARPENTER_TORCH_NATIVE=0`` turns it off, then the device scan;
    ``native`` requires the C++ packer; ``device`` runs the scan at K =
    16 on ``device`` (None: the card), one launch per (size class, width)
    class: stateful jobs carry host-port columns, so one solve can hold
    jobs of several widths. Each job's padding pods exceed its own
    frontier max, so they emit -1 without touching state.

    With a ``mesh`` (``sharding.active_mesh``: D shards over its
    placements), a job at or past ``sharding.shard_min_pods()`` pods
    chunks its pod axis over the shards (``sharding.sharded_pod_pack``),
    whatever the engine, so the partition depends only on the shard
    count, the threshold and the shard engine (job-memo key material);
    the device scan of the other jobs runs group-sharded over the mesh's
    placements (``_scan_classes``) where ``device`` is asked for or the
    C++ packer is off."""
    if not jobs:
        return []
    if mesh is not None:
        from . import sharding

        min_pods = sharding.shard_min_pods()
        mega = [g for g, j in enumerate(jobs) if j[0].shape[0] >= min_pods]
        if mega:
            results: list = [None] * len(jobs)
            for g in mega:
                reqs, frontier, cap = jobs[g]
                results[g] = sharding.sharded_pod_pack(mesh, reqs, frontier, cap)
            rest = [g for g in range(len(jobs)) if results[g] is None]
            if rest:
                for g, r in zip(rest, batch_pack([jobs[g] for g in rest], engine, device, mesh)):
                    results[g] = r
            return results
        if engine == "device":
            return _scan_classes(jobs, None, "shard", mesh)
    if engine in ("auto", "native"):
        if native.available():
            return [
                native.ffd_pack_native(
                    reqs, frontier, int(cap), k_open=max(1, min(NATIVE_K_OPEN, reqs.shape[0]))
                )
                for reqs, frontier, cap in jobs
            ]
        if engine == "native":
            raise RuntimeError("native packer requested but KARPENTER_TORCH_NATIVE=0")
    elif engine != "device":
        raise ValueError(f"unknown pack engine {engine!r} (auto | native | device)")
    if mesh is not None:
        return _scan_classes(jobs, None, "shard", mesh)
    return _scan_classes(jobs, resolve_device(device), "pack")


def _scan_classes(jobs: List[tuple], dev: Optional[torch.device], phase: str, mesh=None) -> List[Tuple[np.ndarray, int]]:
    """The device scan at K = 16 on ``dev``, one launch per (size class,
    width) class, its transfers at the ``phase`` boundary. With ``mesh``
    (``dev`` unused) a class's group count is padded to a multiple of
    the shards (a padding group has no pods and a zero frontier: count
    0) and goes through ``sharding.sharded_batch_pack``, which uploads
    each placement's block of groups to its own card."""
    F_pad = 1 << max((max(len(j[1]) for j in jobs) - 1).bit_length(), 0)
    classes: dict = {}
    for g, job in enumerate(jobs):
        classes.setdefault((_pad_class(job[0].shape[0]), job[0].shape[1]), []).append(g)
    results: list = [None] * len(jobs)
    for (p_pad, R), members in classes.items():
        G = len(members) if mesh is None else -(-len(members) // mesh.size) * mesh.size
        requests = np.ones((G, p_pad, R), dtype=np.int32)
        frontiers = np.zeros((G, F_pad, R), dtype=np.int32)
        caps = np.zeros(G, dtype=np.int32)
        n_pods = np.zeros(G, dtype=np.int32)
        for slot, g in enumerate(members):
            reqs, frontier, cap = jobs[g]
            requests[slot, :, :] = frontier.max(axis=0) + 1  # padding: unschedulable
            requests[slot, : reqs.shape[0]] = reqs
            frontiers[slot, : len(frontier)] = frontier
            caps[slot] = min(int(cap), int(INT_INF))
            n_pods[slot] = reqs.shape[0]
        deviceplane.record_footprint(deviceplane.nbytes_of(requests, frontiers, caps, n_pods))
        with devicetime.track(phase=phase, devices=None if mesh is None else mesh.cards):
            devicetime.transfer("h2d", requests, frontiers, caps, n_pods, phase=phase)
            if mesh is None:
                args = [torch.from_numpy(a).to(dev) for a in (requests, frontiers, caps, n_pods)]
                node_ids, counts = ffd_pack_batched(args[0], args[1], args[2], K_OPEN, args[3])
            else:
                from . import sharding

                args = [torch.from_numpy(a) for a in (requests, frontiers, caps, n_pods)]
                node_ids, counts, _fleet = sharding.sharded_batch_pack(mesh, *args)
            # analysis: allow-host-sync(the one download of a class launch: its plans are host arrays)
            node_ids, counts = node_ids.cpu().numpy(), counts.cpu().numpy()
        devicetime.transfer("d2h", node_ids, counts, phase=phase)
        for slot, g in enumerate(members):
            results[g] = (node_ids[slot, : jobs[g][0].shape[0]], int(counts[slot]))
    return results


# -- the existing-node first-fit -------------------------------------------------

PACK_EXISTING = buildlib.CudaKernel(
    "pack_existing.cu", "pack_existing_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 3,
    name="pack.pack_existing",
)


def pack_existing_reference(
    requests: torch.Tensor,  # (P, R) int32
    sig_ids: torch.Tensor,  # (P,) int
    compat: torch.Tensor,  # (S, M) bool/uint8
    free: torch.Tensor,  # (M, R) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the existing-node first-fit on the
    tensors' device, one pod at a time and without a host sync: each pod
    takes the first admissible node whose free capacity holds it.
    → (assign (P,) int32 node index or -1, remaining free (M, R))."""
    P = requests.shape[0]
    free = free.to(torch.int32).clone()
    assign = torch.full((P,), -1, dtype=torch.int32, device=free.device)
    if P == 0 or free.shape[0] == 0:
        return assign, free
    requests = requests.to(device=free.device, dtype=torch.int32)
    rows = compat.to(device=free.device, dtype=torch.bool)[sig_ids.to(free.device).long()]
    minus_one = torch.tensor(-1, dtype=torch.int32, device=free.device)
    for p in range(P):
        req = requests[p]
        fits = rows[p] & (free >= req).all(dim=1)
        m = fits.to(torch.uint8).argmax()  # the first admissible node
        found = fits.any()
        free.index_add_(0, m.view(1), (-req * found).view(1, -1))
        assign[p] = torch.where(found, m.to(torch.int32), minus_one)
    return assign, free


def _pack_existing_example(dims, rng, device):
    """``pack_existing``'s: P sorted pods of S signatures onto M nodes,
    each signature admitting a seeded half of the nodes."""
    P, R, S, M = dims("P"), dims("R"), dims("S"), dims("M")
    reqs = _sorted_requests(rng, (P, R))
    sig_ids = rng.randint(0, S, size=P).astype(np.int32)
    compat = (rng.rand(S, M) < 0.5).astype(np.uint8)
    free = rng.randint(0, 40, size=(M, R)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (reqs, sig_ids, compat, free)), {}


@deviceplane.observe("pack.pack_existing")
@contract("P R", "P", "S M", "M R", out=("P", "M R"), example=_pack_existing_example)
def pack_existing(
    requests: torch.Tensor,  # (P, R) int32, sorted descending by primary
    sig_ids: torch.Tensor,  # (P,) int32
    compat: torch.Tensor,  # (S, M) uint8
    free: torch.Tensor,  # (M, R) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``pack_existing``: one launch of
    ``csrc/pack_existing.cu`` on CUDA tensors (or a raise), the plain
    version on CPU tensors → (assign (P,) int32, remaining free (M, R))."""
    dev = free.device
    if dev.type == "cpu":
        return pack_existing_reference(requests, sig_ids, compat, free)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    P, R = requests.shape
    S, M = compat.shape
    buildlib.check_tensor("requests", requests, torch.int32, (P, R), dev)
    buildlib.check_tensor("sig_ids", sig_ids, torch.int32, (P,), dev)
    buildlib.check_tensor("compat", compat, torch.uint8, (S, M), dev)
    buildlib.check_tensor("free", free, torch.int32, (M, R), dev)
    assign = torch.empty(P, dtype=torch.int32, device=dev)
    free_out = torch.empty((M, R), dtype=torch.int32, device=dev)
    if P == 0 or M == 0:
        assign.fill_(-1)
        free_out.copy_(free)
        return assign, free_out
    PACK_EXISTING.launch(
        requests.data_ptr(), sig_ids.data_ptr(), compat.data_ptr(), free.data_ptr(),
        P, R, S, M, free_out.data_ptr(), assign.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, device=dev,
    )
    return assign, free_out


def run_pack_existing(
    requests: np.ndarray,  # (P, R) int32, sorted descending by primary
    sig_ids: np.ndarray,  # (P,) int32
    compat: np.ndarray,  # (S, M) uint8/bool signature x node admissibility
    free: np.ndarray,  # (M, R) int32 free capacity, nodes in try order
    engine: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """First-fit pods onto existing nodes in fixed node order (the
    reference tries in-flight/real nodes before any new claim,
    scheduler.go:241-246) → (assign (P,) int32 node index or -1,
    remaining free (M, R)). ``free`` is not modified. Engines as in
    ``batch_pack``."""
    if requests.shape[0] == 0 or free.shape[0] == 0:
        return np.full(requests.shape[0], -1, dtype=np.int32), free
    if engine in ("auto", "native"):
        if native.available():
            free = np.array(free, dtype=np.int32, order="C")
            assign, _ = native.pack_existing_native(requests, sig_ids, compat, free)
            return assign, free
        if engine == "native":
            raise RuntimeError("native packer requested but KARPENTER_TORCH_NATIVE=0")
    elif engine != "device":
        raise ValueError(f"unknown pack engine {engine!r} (auto | native | device)")
    dev = resolve_device(device)
    S = compat.shape[0]
    sig_ids = np.ascontiguousarray(sig_ids, dtype=np.int32)
    if sig_ids.size and (sig_ids.min() < 0 or sig_ids.max() >= S):
        raise ValueError(f"sig_ids out of range for {S} signatures")
    inputs = (
        np.ascontiguousarray(requests, dtype=np.int32), sig_ids,
        np.ascontiguousarray(compat, dtype=np.uint8), np.ascontiguousarray(free, dtype=np.int32),
    )
    with devicetime.track(phase="existing"):
        devicetime.transfer("h2d", *inputs, phase="existing")
        assign, free_out = pack_existing(*(torch.from_numpy(a).to(dev) for a in inputs))
        # analysis: allow-host-sync(the one download of the first-fit: the solver reads host arrays)
        assign, free_out = assign.cpu().numpy(), free_out.cpu().numpy()
    devicetime.transfer("d2h", assign, free_out, phase="existing")
    return assign, free_out
