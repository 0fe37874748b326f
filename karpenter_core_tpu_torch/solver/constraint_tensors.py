"""Host ports and CSI volume attach limits in array form (host numpy).

Counterpart of ``karpenter_core_tpu/solver/constraint_tensors.py``
without its disruption-screen axes (``screen_axes_for_candidates``,
``screen_axes_for_fleet``), which belong to consolidation. Host ports
and CSI attach limits are the reference's per-node *stateful*
scheduling constraints (hostportusage.go, volumeusage.go); this module
turns both into columns the C++ packer enforces without a per-pod host
walk:

Host ports → pseudo-resource columns
    ``HostPort.matches`` (same proto+port; IPs conflict when equal or
    either is unspecified) has an exact additive encoding over two
    feature families per (proto, port) pair:

    - the *pair* axis with capacity ``PORT_K``: a wildcard-IP port loads
      the full ``PORT_K``, a specific-IP port loads 1. Two wildcards
      (2K > K), or a wildcard next to any specific IP (K+1 > K), exceed
      the capacity; distinct specific IPs coexist (m ≤ K).
    - one *exact-IP* axis per specific IP with capacity 1: two pods (or
      a pod and a node reservation) on the same (proto, port, ip)
      collide.

    Appended to a pack job's request matrix and frontier (or to the
    existing-node free matrix), these columns make the first-fit-
    decreasing and existing-node first-fit enforce port conflicts
    natively, between a dispatch's own placements too.

Volumes → per-node admissibility masks + ephemeral driver axes
    A signature group's claim-backed PVCs are one *shared* id set (the
    claim names ride the signature), so any number of its pods charge a
    node's per-driver counters once: a boolean (group, node) mask over
    the union check, the placement charging the overlay a single time.
    Generic-ephemeral volumes mint one PVC per pod, so their per-driver
    counts are exactly additive and become driver columns in the free
    matrix.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..scheduling.hostports import UNSPECIFIED, HostPort
from ..scheduling.volumes import Volumes, _default_storage_class, _resolve_driver

# capacity of a (proto, port) pair axis; must exceed any realistic
# specific-IP count per node AND stay far below the int32 pack
# saturation (2^30) so sums never overflow
PORT_K = np.int32(1 << 20)


# ---------------------------------------------------------------------------
# canonical port forms


def canonical_ports(pod) -> Tuple[Tuple[str, int, str], ...]:
    """Sorted (protocol, port, ip) triples of a pod's host ports. Empty
    host_ip defaults to 0.0.0.0 (hostportusage.go:93)."""
    out = set()
    spec = pod.spec
    for c in list(spec.containers) + list(spec.init_containers):
        for p in c.ports:
            if p.host_port:
                out.add((p.protocol or "TCP", int(p.host_port), p.host_ip or "0.0.0.0"))
    return tuple(sorted(out))


def ports_from_triples(triples: Sequence[Tuple[str, int, str]]) -> List[HostPort]:
    return [HostPort(ip=ip, port=port, protocol=proto) for proto, port, ip in triples]


def ports_conflict(a: Sequence[Tuple[str, int, str]], b: Sequence[Tuple[str, int, str]]) -> bool:
    """Any pair across the two canonical triple sets conflicts — the
    scalar predicate (HostPort.matches) the merge pass's pairwise guard
    uses, where sets are tiny."""
    if not a or not b:
        return False
    pa, pb = ports_from_triples(a), ports_from_triples(b)
    return any(x.matches(y) for x in pa for y in pb)


# ---------------------------------------------------------------------------
# port feature axes


class PortFeatures:
    """Feature-axis layout for a universe of canonical port triples.

    ``features`` lists the axes in a stable sorted order: the
    (proto, port, None) pair axis first, then one (proto, port, ip)
    axis per specific IP observed. ``caps`` is the per-axis fresh-node
    capacity (PORT_K for pair axes, 1 for exact-IP axes)."""

    __slots__ = ("features", "index", "caps")

    def __init__(self, triple_sets: Sequence[Sequence[Tuple[str, int, str]]]):
        feats = set()
        for triples in triple_sets:
            for proto, port, ip in triples:
                feats.add((proto, port, None))
                if ip not in UNSPECIFIED:
                    feats.add((proto, port, ip))
        self.features: List[tuple] = sorted(
            feats, key=lambda f: (f[0], f[1], f[2] is not None, f[2] or "")
        )
        self.index = {f: i for i, f in enumerate(self.features)}
        self.caps = np.array(
            [1 if f[2] is not None else int(PORT_K) for f in self.features], dtype=np.int32
        )

    @property
    def count(self) -> int:
        return len(self.features)

    def load_row(self, triples: Sequence[Tuple[str, int, str]]) -> np.ndarray:
        """(F,) int32 load vector of one pod's canonical ports. A pod's
        own ports never conflict with each other (the scalar check skips
        the pod's own reservation entry), so per pair axis the load
        saturates at PORT_K: any wildcard ⇒ exactly K, else one unit per
        distinct specific IP."""
        row = np.zeros(self.count, dtype=np.int64)
        wild_pairs = set()
        for proto, port, ip in triples:
            if ip in UNSPECIFIED:
                wild_pairs.add((proto, port))
            else:
                row[self.index[(proto, port, None)]] += 1
                row[self.index[(proto, port, ip)]] = 1
        for pair in wild_pairs:
            row[self.index[pair + (None,)]] = int(PORT_K)
        return np.minimum(row, np.int64(2**30)).astype(np.int32)

    def load_matrix(self, triple_sets: Sequence[Sequence[Tuple[str, int, str]]]) -> np.ndarray:
        """(G, F) int32 — one row per port set."""
        if not self.count:
            return np.zeros((len(triple_sets), 0), dtype=np.int32)
        return np.stack([self.load_row(t) for t in triple_sets])

    def free_row(self, reserved: Sequence[HostPort]) -> np.ndarray:
        """(F,) int32 remaining capacity of a node already reserving
        ``reserved``: a wildcard reservation zeroes its pair axis (and
        every exact-IP axis of the pair); a specific reservation takes
        one pair unit and its exact axis."""
        free = self.caps.astype(np.int64).copy()
        for hp in reserved:
            pi = self.index.get((hp.protocol, hp.port, None))
            if pi is None:
                continue  # a port outside the batch's universe: never probed
            if hp.ip in UNSPECIFIED:
                free[pi] = 0
                for f, fi in self.index.items():
                    if f[2] is not None and f[0] == hp.protocol and f[1] == hp.port:
                        free[fi] = 0
            else:
                free[pi] -= 1
                ei = self.index.get((hp.protocol, hp.port, hp.ip))
                if ei is not None:
                    free[ei] -= 1
        return np.maximum(free, 0).astype(np.int32)

    def free_matrix(self, reserved_per_node: Sequence[Sequence[HostPort]]) -> np.ndarray:
        """(M, F) int32 — one row per node's reserved port list."""
        if not self.count:
            return np.zeros((len(reserved_per_node), 0), dtype=np.int32)
        return np.stack([self.free_row(r) for r in reserved_per_node])


def node_reserved_ports(state_node) -> List[HostPort]:
    """Flattened HostPort reservations of a StateNode (its
    HostPortUsage map), the free_matrix input."""
    out: List[HostPort] = []
    for entries in state_node.host_port_usage.reserved.values():
        out.extend(entries)
    return out


def port_conflict_matrix(
    group_triples: Sequence[Sequence[Tuple[str, int, str]]],
    reserved_per_node: Sequence[Sequence[HostPort]],
) -> np.ndarray:
    """(G, M) bool — group g's port set conflicts with node m's existing
    reservations (≥1 matching pair): ``HostPortUsage.conflicts`` per
    (group, node), vectorized."""
    feats = PortFeatures(group_triples)
    G, M = len(group_triples), len(reserved_per_node)
    if not feats.count or not G or not M:
        return np.zeros((G, M), dtype=bool)
    loads = feats.load_matrix(group_triples).astype(np.int64)  # (G, F)
    free = feats.free_matrix(reserved_per_node).astype(np.int64)  # (M, F)
    return (loads[:, None, :] > free[None, :, :]).any(axis=2)


# ---------------------------------------------------------------------------
# volumes


class GroupVolumes:
    """One signature group's resolved volume demand.

    ``shared``: driver → set of pvc ids the whole group mounts (claim-
    backed volumes: every pod names the same claims, so a node is
    charged once no matter how many of the group's pods land on it).
    ``eph_counts``: driver → per-pod count of generic-ephemeral PVCs
    (ids embed the pod name → exactly additive per pod).
    ``unresolved``: a referenced PVC was missing — the reference's
    existing-node add() fails for every node, so every existing node is
    inadmissible. New nodes carry no volume check (as the reference's
    SchedulingNodeClaim): no per-node CSI limit is known before a node
    exists."""

    __slots__ = ("shared", "eph_counts", "unresolved")

    def __init__(self) -> None:
        self.shared = Volumes()
        self.eph_counts: Dict[str, int] = {}
        self.unresolved = False

    @property
    def empty(self) -> bool:
        return not self.shared and not self.eph_counts and not self.unresolved

    def drivers(self) -> set:
        return set(self.shared) | set(self.eph_counts)


def resolve_group_volumes(kube_client, group) -> GroupVolumes:
    """Resolve one group's volumes through the PVC → StorageClass → CSI
    driver chain (``scheduling.volumes.get_volumes`` semantics, once per
    signature instead of per pod)."""
    gv = GroupVolumes()
    pod = group.exemplar
    if kube_client is None:
        return gv  # no store to resolve against: no volume checks
    default_sc = None
    have_default = False
    for volume in pod.spec.volumes:
        if volume.persistent_volume_claim:
            pvc = kube_client.get(
                "PersistentVolumeClaim", volume.persistent_volume_claim, namespace=pod.namespace
            )
            if pvc is None:
                gv.unresolved = True
                continue
            if pvc.storage_class_name is None and not have_default:
                default_sc, have_default = _default_storage_class(kube_client), True
            driver = _resolve_driver(
                kube_client, pvc.volume_name, pvc.storage_class_name or default_sc
            )
            if driver:
                gv.shared.add(driver, f"{pod.namespace}/{volume.persistent_volume_claim}")
        elif volume.ephemeral:
            if not have_default:
                default_sc, have_default = _default_storage_class(kube_client), True
            driver = _resolve_driver(kube_client, "", default_sc)
            if driver:
                gv.eph_counts[driver] = gv.eph_counts.get(driver, 0) + 1
    return gv


def volume_admit_row(gv: GroupVolumes, node_volumes: Volumes, csi_limits: Dict[str, int]) -> bool:
    """Would mounting the group's shared set plus ONE pod's ephemeral
    PVCs keep every driver under the node's limit? (The per-pod
    ephemeral tail is charged additively by the pack columns; this is
    the ≥1-pod admissibility gate.)"""
    if gv.unresolved:
        return False
    # every driver of the would-be union, drivers only the node mounts
    # included (an over-limit node rejects any volume-bearing pod, as
    # exceeds_limits' union walk does)
    for driver in gv.drivers() | set(node_volumes):
        limit = csi_limits.get(driver)
        if limit is None:
            continue
        mounted = set(node_volumes.get(driver, ()))
        would = len(mounted | set(gv.shared.get(driver, ()))) + gv.eph_counts.get(driver, 0)
        if would > limit:
            return False
    return True


def volume_admit_matrix(group_vols: Sequence[GroupVolumes], nodes: Sequence) -> np.ndarray:
    """(G, M) bool — group g may place ≥1 pod on state node m under the
    node's CSI attach limits: ``VolumeUsage.exceeds_limits`` per (group,
    node)."""
    G, M = len(group_vols), len(nodes)
    out = np.ones((G, M), dtype=bool)
    for m, n in enumerate(nodes):
        vu = n.volume_usage
        for g, gv in enumerate(group_vols):
            out[g, m] = volume_admit_row(gv, vu.volumes, vu.csi_limits)
    return out


def eph_free_columns(
    drivers: Sequence[str], nodes: Sequence, overlays: Optional[Dict[int, Volumes]] = None
) -> np.ndarray:
    """(M, D) int32 remaining attach slots per node per driver, for the
    ephemeral-volume pack columns: limit − |mounted ∪ overlay|
    (saturating at the int32 pack ceiling for unlimited drivers)."""
    M = len(nodes)
    out = np.full((M, len(drivers)), 2**30 - 1, dtype=np.int64)
    for m, n in enumerate(nodes):
        vu = n.volume_usage
        over = overlays.get(m) if overlays else None
        for d, driver in enumerate(drivers):
            limit = vu.csi_limits.get(driver)
            if limit is None:
                continue
            mounted = set(vu.volumes.get(driver, ()))
            if over:
                mounted |= set(over.get(driver, ()))
            out[m, d] = max(int(limit) - len(mounted), 0)
    return out.astype(np.int32)
