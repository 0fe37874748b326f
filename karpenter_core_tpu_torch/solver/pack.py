"""Bin-packing, host part: K-open first-fit-decreasing on the C++ packer.

Counterpart of the host half of ``karpenter_core_tpu/solver/pack.py``.
The oracle packs each pod into the open claim with the fewest pods that
still fits (scheduler.go:247-254), where "fits" means *some* instance
type can hold the claim's accumulated requests. A claim's viable type
set is fully determined by its accumulated usage, so per-node state
collapses to a usage vector checked against the Pareto frontier of the
viable allocatable vectors.

The JAX package's default route (``engine="auto"`` with the native
library present) packs every job with its C++ packer at K=1024 open
slots, and first-fits pods onto existing nodes with the same library;
that is the route taken here. Its ``lax.scan`` device scans
(``ffd_pack``/``ffd_pack_batched`` and ``pack_existing``) are not on
this path: ``pack_existing_reference`` is the plain PyTorch version of
the existing-node scan, for tests and the card check.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import native

INT_INF = np.int32(2**31 - 1)

# open-slot bound of the native packer — the JAX package's
# KARPENTER_TPU_K_OPEN default (pack.py:43-46): K=1024 reproduces the
# oracle's keep-everything-open greedy, and the fit scan exits early
NATIVE_K_OPEN = 1024


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


def node_usage_from_assignment(
    requests: np.ndarray, node_ids: np.ndarray, node_count: int
) -> np.ndarray:
    """Segment-sum pod requests by assigned node → (N, R) int32."""
    usage = np.zeros((node_count, requests.shape[1]), dtype=np.int64)
    valid = node_ids >= 0
    np.add.at(usage, node_ids[valid], requests[valid])
    return usage.astype(np.int32)


def assign_cheapest_types(
    node_usage: np.ndarray,  # (N, R) int32 summed requests per node
    allocatable: np.ndarray,  # (T, R) int32 (viable types only)
    prices: np.ndarray,  # (T,) f64
) -> np.ndarray:
    """Per node, the cheapest viable type that holds its load — the launch
    decision the fake provider makes (fake/cloudprovider.go:105-110).
    → (N,) int32 index into the viable-type axis, -1 if none fits."""
    N = node_usage.shape[0]
    if N == 0 or allocatable.shape[0] == 0:
        return np.full(N, -1, dtype=np.int32)
    return native.cheapest_types_native(node_usage, allocatable, prices)


def batch_pack(jobs: List[tuple]) -> List[Tuple[np.ndarray, int]]:
    """Pack every (requests, frontier, max_per_node) job with the native
    packer at K = min(NATIVE_K_OPEN, P) → [(node_ids, node_count)]
    aligned with ``jobs``."""
    return [
        native.ffd_pack_native(
            reqs, frontier, int(cap), k_open=max(1, min(NATIVE_K_OPEN, reqs.shape[0]))
        )
        for reqs, frontier, cap in jobs
    ]


def run_pack_existing(
    requests: np.ndarray,  # (P, R) int32, sorted descending by primary
    sig_ids: np.ndarray,  # (P,) int32
    compat: np.ndarray,  # (S, M) uint8/bool signature x node admissibility
    free: np.ndarray,  # (M, R) int32 free capacity, nodes in try order
) -> Tuple[np.ndarray, np.ndarray]:
    """First-fit pods onto existing nodes in fixed node order on the
    native packer (the reference tries in-flight/real nodes before any
    new claim, scheduler.go:241-246) → (assign (P,) int32 node index or
    -1, remaining free (M, R)). ``free`` is not modified."""
    if requests.shape[0] == 0 or free.shape[0] == 0:
        return np.full(requests.shape[0], -1, dtype=np.int32), free
    free = np.array(free, dtype=np.int32, order="C")
    assign, _ = native.pack_existing_native(requests, sig_ids, compat, free)
    return assign, free


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
