"""Consolidation screens and the batched repack bound.

Counterpart of ``karpenter_core_tpu/disruption/tpu_repack.py``. The
reference binary-searches prefix sizes, paying a full scheduler
simulation per probe (multinodeconsolidation.go:77-137, O(log N) solves,
1-minute budget). This module computes a **capacity feasibility
screen** for all prefixes (or any family of candidate subsets, or every
single candidate) in one kernel launch:

  feasible[k] = the pods of candidates[0..k] fit into
                (free capacity of the surviving fleet) + (one new node)

The screens are the hand-written Hopper kernel ``csrc/disrupt_screen.cu``
(``screen_kernels``), which fixes the float32 summation order so the
card and the CPU agree bit for bit. The screened k is then verified with
the scheduling simulation (same role as the reference's Validation
re-solve); capacity screening is necessary but not sufficient
(constraints can still reject), so the caller walks down on verification
failure. ``repack_feasible`` is the matching lower bound: a true
first-fit of the displaced pods, on the C++ packer or, with
``KARPENTER_TORCH_NATIVE=0``, the existing-node first-fit kernel
(``csrc/pack_existing.cu``) on the card.

The screens and the repack run on the provisioner's device
(``screen_device``): ``None`` is the card, tests pass ``"cpu"``.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from ..scheduling import resources
from ..solver import devicetime
from ..solver.backend import resolve_device
from ..solver.encode import build_resource_axis, extend_axis, quantize_capacity, quantize_requests
from . import screen_kernels
from .types import Candidate


def screen_device(ctx) -> torch.device:
    """The device of the screens and the repack bound: the provisioner's
    (``None``: the card)."""
    return resolve_device(getattr(getattr(ctx, "provisioner", None), "device", None))


def _run_screen(fn, ctx, *arrays) -> np.ndarray:
    """One screen launch on the ctx's device → host bool array."""
    dev = screen_device(ctx)
    with devicetime.track(phase="screen"):
        tensors = [
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8 if a.dtype == np.uint8 else np.int32)).to(dev)
            for a in arrays
        ]
        devicetime.transfer("h2d", *tensors, phase="screen")
        out = fn(*tensors).cpu().numpy()
    devicetime.transfer("d2h", out, phase="screen")
    return out


def _encode_candidates(candidates: List[Candidate]):
    """Shared screen encoding: (names, axis, loads, free). Loads count
    ONLY reschedulable pods — daemonset/node-owned pods die with the
    node and the oracle simulation doesn't reschedule them
    (helpers.py simulate_scheduling / utils.pod.is_reschedulable);
    counting them would make the screens falsely reject."""
    from ..utils import pod as podutils

    candidate_names = {c.name() for c in candidates}
    all_requests = [
        resources.requests_for_pods(*(p for p in c.pods if podutils.is_reschedulable(p)))
        if c.pods
        else {}
        for c in candidates
    ]
    instance_types = [c.instance_type for c in candidates]
    axis = build_resource_axis(all_requests, instance_types)
    loads = np.stack([quantize_requests(r, axis) for r in all_requests])
    free = np.stack(
        [quantize_capacity(c.state_node.available(), axis) for c in candidates]
    )
    return candidate_names, axis, loads, free


def _stateful_screen_inputs(ctx, candidates, candidate_names, loads, free):
    """Append the stateful axes (host-port feature columns,
    CSI-driver attach columns) to the screen matrices, and return the
    matching fleet/new-node extension builders. Soundness direction is
    preserved (loads under-approximate, capacities over-approximate —
    see solver/constraint_tensors.py), so k_hi == 0 still proves the
    no-op. No-op (zero extra columns) for port/volume-free fleets."""
    from ..solver.constraint_tensors import (
        screen_axes_for_candidates,
        screen_axes_for_fleet,
    )

    feats, drivers, s_loads, s_free, s_new = screen_axes_for_candidates(
        candidates, getattr(ctx, "kube_client", None)
    )
    if s_new.size == 0:
        return loads, free, None, None
    loads = np.hstack([loads, s_loads])
    free = np.hstack([free, s_free])

    def fleet_ext() -> np.ndarray:
        nodes = [
            n
            for n in ctx.cluster.deep_copy_nodes()
            if not n.marked_for_deletion
            and n.name() not in candidate_names
            and n.initialized()
        ]
        return screen_axes_for_fleet(feats, drivers, nodes)

    return loads, free, fleet_ext, s_new


def screen_singles(ctx, candidates: List[Candidate]) -> np.ndarray:
    """(N,) bool feasibility screen for single-candidate consolidation.
    Screen-infeasible candidates cannot consolidate (capacity is a
    necessary condition); feasible ones still go through the oracle
    simulation."""
    if not candidates:
        return np.zeros(0, dtype=bool)
    candidate_names, axis, loads, free = _encode_candidates(candidates)
    fleet_free = _fleet_free(ctx, axis, candidate_names)
    new_node_cap = _largest_launchable(ctx, axis)
    loads, free, fleet_ext, s_new = _stateful_screen_inputs(
        ctx, candidates, candidate_names, loads, free
    )
    if s_new is not None:
        fleet_free = np.concatenate([fleet_free, fleet_ext()])
        new_node_cap = np.concatenate([new_node_cap, s_new])
    return _run_screen(screen_kernels.screen_singles, ctx, loads, free, fleet_free, new_node_cap)


def screen_subsets(ctx, candidates: List[Candidate], masks: np.ndarray) -> np.ndarray:
    """(S,) bool capacity screen for arbitrary candidate subsets.
    ``masks`` is (S, N) membership over ``candidates``; one kernel
    launch evaluates every subset (``screen_kernels.screen_subsets``)."""
    masks = np.asarray(masks)
    if not len(candidates) or masks.size == 0:
        return np.zeros(masks.shape[0] if masks.ndim == 2 else 0, dtype=bool)
    candidate_names, axis, loads, free = _encode_candidates(candidates)
    fleet_free = _fleet_free(ctx, axis, candidate_names)
    new_node_cap = _largest_launchable(ctx, axis)
    loads, free, fleet_ext, s_new = _stateful_screen_inputs(
        ctx, candidates, candidate_names, loads, free
    )
    if s_new is not None:
        fleet_free = np.concatenate([fleet_free, fleet_ext()])
        new_node_cap = np.concatenate([new_node_cap, s_new])
    # the masks go to the card as bytes (the engine's masks are bool)
    return _run_screen(
        screen_kernels.screen_subsets, ctx, masks.astype(np.uint8), loads, free, fleet_free, new_node_cap
    )


def _fleet_free(ctx, axis, candidate_names) -> np.ndarray:
    fleet_free = np.zeros(axis.count, dtype=np.int64)
    for node in ctx.cluster.deep_copy_nodes():
        if node.marked_for_deletion or node.name() in candidate_names:
            continue
        if not node.initialized():
            continue
        fleet_free += quantize_capacity(node.available(), axis)
    return np.minimum(fleet_free, 2**30).astype(np.int32)


def _largest_launchable(ctx, axis) -> np.ndarray:
    new_node_cap = np.zeros(axis.count, dtype=np.int32)
    for np_ in ctx.kube_client.list("NodePool"):
        try:
            for it in ctx.cloud_provider.get_instance_types(np_):
                new_node_cap = np.maximum(new_node_cap, quantize_capacity(it.allocatable(), axis))
        except Exception as e:  # noqa: BLE001 — one bad pool must not stop the repack
            logging.getLogger("karpenter.disruption").debug(
                "skipping nodepool %s: instance-type fetch failed: %s", np_.name, e
            )
            continue
    return new_node_cap


def repack_prefixes(ctx, candidates: List[Candidate]) -> int:
    """Largest prefix size whose displaced pods actually pack (see
    repack_feasible; 0 when none does)."""
    feasible = repack_feasible(ctx, candidates)
    if not feasible.any():
        return 0
    return int(np.max(np.flatnonzero(feasible))) + 1


def repack_feasible(ctx, candidates: List[Candidate]) -> np.ndarray:
    """(N,) bool — per-prefix repack feasibility: entry k-1 is True when
    prefix k's displaced pods actually PACK — a true first-fit against
    per-node free capacity and label/taint admissibility, not a
    capacity sum — onto the non-candidate fleet plus one replacement
    node (SURVEY §7.7's "evaluate candidate prefixes in one batched
    solve"). Called with a reordered candidate list this prices every
    prefix of ANY sort order in one pack — the batched-repack lower
    bound the disruption engine uses per family order.

    One pack (the C++ packer, or the first-fit kernel) prices every
    prefix at once: pods are packed
    in candidate order, bins only ever fill, so prefix k's pack state is
    a prefix of the single pack sequence. Surviving candidates' free
    space is deliberately excluded (a placement there would be invalid
    for any larger prefix that removes the host), which makes the result
    a LOWER bound on the consolidatable prefix — the optimistic capacity
    screen (screen_prefixes) is the upper bound, and the oracle verifies
    whichever prefix is attempted."""
    from ..solver.encode import group_pods
    from ..solver.pack import run_pack_existing
    from ..solver.solver import existing_node_compat
    from ..utils import pod as podutils

    if len(candidates) < 2:
        return np.zeros(len(candidates), dtype=bool)
    candidate_names = {c.name() for c in candidates}
    pods_per_candidate = [
        [p for p in (c.pods or []) if podutils.is_reschedulable(p)] for c in candidates
    ]
    flat_pods = [p for ps in pods_per_candidate for p in ps]
    owner = np.array(
        [ci for ci, ps in enumerate(pods_per_candidate) for _ in ps], dtype=np.int64
    )

    fleet_nodes = [
        n
        for n in ctx.cluster.deep_copy_nodes()
        if not n.marked_for_deletion
        and n.name() not in candidate_names
        and n.initialized()
    ]
    all_requests = [resources.requests_for_pods(p) for p in flat_pods]
    axis = extend_axis(
        build_resource_axis([], [c.instance_type for c in candidates]), all_requests
    )
    new_node_cap = _largest_launchable(ctx, axis)

    N = len(candidates)
    if flat_pods:
        reqs = np.stack([quantize_requests(r, axis) for r in all_requests])
        # candidate-major order (prefix monotonicity), descending within
        # each candidate (queue.go:76 ordering inside the unit)
        order = np.lexsort((-reqs[:, 1], -reqs[:, 0], owner))
        reqs, owner = reqs[order], owner[order]
        flat_sorted = [flat_pods[i] for i in order]

        assign = np.full(len(flat_sorted), -1, dtype=np.int32)
        if fleet_nodes:
            groups = group_pods(flat_sorted)
            sig_of = np.zeros(len(flat_sorted), dtype=np.int32)
            for s, g in enumerate(groups):
                sig_of[np.asarray(g.pod_indices, dtype=np.int64)] = s
            compat = existing_node_compat(groups, fleet_nodes)
            free = np.zeros((len(fleet_nodes), axis.count), dtype=np.int32)
            for m, node in enumerate(fleet_nodes):
                avail = node.available()
                if not any(v < 0 for v in avail.values()):
                    free[m] = quantize_capacity(avail, axis)
            # displaced host-port pods ride as feature columns
            # (conflicts with fleet reservations AND between displaced
            # pods are native to the scan); volume-limited nodes mask
            # out per signature. Both only REMOVE placements, so the
            # repack stays a valid lower bound.
            from ..solver.constraint_tensors import (
                PortFeatures,
                node_reserved_ports,
                volume_admit_matrix,
                resolve_group_volumes,
            )

            sig_ports = [g.host_ports() for g in groups]
            if any(sig_ports):
                feats = PortFeatures(sig_ports)
                if feats.count:
                    sig_loads = feats.load_matrix(sig_ports)
                    reqs = np.ascontiguousarray(
                        np.hstack([reqs, sig_loads[sig_of]]), dtype=np.int32
                    )
                    free = np.ascontiguousarray(
                        np.hstack(
                            [
                                free,
                                feats.free_matrix(
                                    [node_reserved_ports(n) for n in fleet_nodes]
                                ),
                            ]
                        ),
                        dtype=np.int32,
                    )
            kc = getattr(ctx, "kube_client", None)
            if kc is not None and any(g.has_volumes for g in groups):
                gvs = [resolve_group_volumes(kc, g) for g in groups]
                compat = compat.astype(bool) & volume_admit_matrix(gvs, fleet_nodes)
            if compat.any():
                assign, _ = run_pack_existing(reqs, sig_of, compat, free, device=screen_device(ctx))

        # leftovers must fit ONE replacement node: cumulative load per
        # prefix ≤ the largest launchable allocatable, and every leftover
        # pod must individually fit it
        left = assign < 0
        leftover_load = np.zeros((N, axis.count), dtype=np.int64)
        pod_fits_new = np.ones(N, dtype=bool)
        reqs_res = reqs[:, : axis.count]  # resource slice (port columns
        # are per-node state, meaningless on the one-replacement bound)
        for j in np.flatnonzero(left):
            ci = owner[j]
            leftover_load[ci] += reqs_res[j].astype(np.int64)
            if np.any(reqs_res[j] > new_node_cap):
                pod_fits_new[ci] = False
        cum = np.cumsum(leftover_load, axis=0)
        feasible = np.all(cum <= new_node_cap.astype(np.int64)[None, :], axis=1)
        feasible &= np.cumprod(pod_fits_new)[: N].astype(bool)
    else:
        feasible = np.ones(N, dtype=bool)  # nothing displaced: all delete

    return feasible


def screen_prefixes(ctx, candidates: List[Candidate]) -> int:
    """Largest prefix size (≥0) that passes the capacity screen."""
    if len(candidates) < 2:
        return 0
    candidate_names, axis, loads, free = _encode_candidates(candidates)

    fleet_free = _fleet_free(ctx, axis, candidate_names)
    # the largest instance a replacement could be (upper bound; the oracle
    # verification enforces the real price/compat constraints)
    new_node_cap = _largest_launchable(ctx, axis)
    loads, free, fleet_ext, s_new = _stateful_screen_inputs(
        ctx, candidates, candidate_names, loads, free
    )
    if s_new is not None:
        fleet_free = np.concatenate([fleet_free, fleet_ext()])
        new_node_cap = np.concatenate([new_node_cap, s_new])

    feasible = _run_screen(screen_kernels.screen_prefix, ctx, loads, free, fleet_free, new_node_cap)
    if not feasible.any():
        return 0
    # prefix sizes are 1-indexed; find the largest feasible prefix
    return int(np.max(np.flatnonzero(feasible))) + 1
