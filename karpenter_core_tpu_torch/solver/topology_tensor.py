"""Tensor-path topology spread: seeded domain counters + closed-form
min-skew water-fill (host numpy), the counterpart of
``karpenter_core_tpu/solver/topology_tensor.py`` without its spans.

The oracle walks pods one at a time, each picking the min-count domain
within ``max_skew`` of the global min (scheduler/topology.py
``_next_domain_spread``; ref topologygroup.go:163-212). For a whole
signature group at once that greedy walk has a closed form:

- Let A be the placement domains (viable offerings / admitting existing
  nodes), D the pod-supported domains (merged requirements ∩ domain
  universe), C the seeded per-domain counts.
- The greedy walk always fills the argmin of A, so final counts are a
  water-fill of P pods over C[A] — except that domains in D \\ A pin
  the global min: once every A domain reaches ``ext = min C[D \\ A]``,
  eligibility caps each A domain at ``ext + max_skew``
  (count+1-min ≤ max_skew, topologygroup.go:177).
- ``min_domains`` (DoNotSchedule only): with fewer than min_domains
  pod-supported domains the global min is treated as 0
  (topologygroup.go:209), i.e. the cap is just ``max_skew``.
- Hostname topologies always see min = 0 (a new node is a new domain,
  topologygroup.go:193-196) — those stay on the per-node-cap path
  (solver.py max_per_node), not here.

So one (Z,)-vector computation replaces P sequential domain picks, and
the remaining per-pod work is a vectorized interleave of pods into
their assigned domains.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scheduler.topology import (
    TOPOLOGY_TYPE_POD_AFFINITY,
    TOPOLOGY_TYPE_SPREAD,
    TopologyGroup,
    count_matching_pods_by_domain,
)


def _fill_unbounded(counts: np.ndarray, pods: int) -> np.ndarray:
    """Exact integer water-fill: pour ``pods`` units lowest-first onto
    ``counts`` with no ceiling. Final counts equal the oracle's
    repeated-argmin walk. → per-bin quotas."""
    Z = len(counts)
    order = np.argsort(counts, kind="stable")
    cs = counts[order].astype(np.int64)
    prefix = np.cumsum(cs)
    # number of bins k the water reaches: largest k where raising the
    # first k bins to cs[k] costs ≤ pods
    k = Z
    for j in range(1, Z):
        if cs[j] * j - prefix[j - 1] > pods:
            k = j
            break
    level, rem = divmod(int(prefix[k - 1]) + pods, k)
    q_sorted = np.zeros(Z, dtype=np.int64)
    q_sorted[:k] = level - cs[:k]
    q_sorted[:rem] += 1  # sub-level remainder: one extra on the lowest bins
    quotas = np.zeros(Z, dtype=np.int64)
    quotas[order] = q_sorted
    return quotas


def water_fill(
    counts: np.ndarray, pods: int, ceiling: Optional[int]
) -> Tuple[np.ndarray, int]:
    """Fill ``pods`` units onto ``counts`` lowest-first, never raising a
    bin above ``ceiling`` (None = unbounded). → (quota per bin,
    unplaceable count)."""
    Z = len(counts)
    if Z == 0 or pods <= 0:
        return np.zeros(Z, dtype=np.int64), max(pods, 0)
    c = counts.astype(np.int64)
    if ceiling is None:
        return _fill_unbounded(c, pods), 0
    room = np.clip(int(ceiling) - c, 0, None)
    placeable = int(room.sum())
    if pods >= placeable:
        return room, pods - placeable
    # pods < placeable: unbounded fill, then clamp over-ceiling bins and
    # re-pour their excess onto the rest (≤ Z iterations, each clamps ≥ 1)
    q = _fill_unbounded(c, pods)
    for _ in range(Z):
        over = q > room
        if not over.any():
            break
        excess = int((q - room)[over].sum())
        q[over] = room[over]
        free = ~over & (q < room)
        sub = _fill_unbounded((c + q)[free], excess)
        qf = q[free]
        qf += sub
        q[free] = qf
    return q, pods - int(q.sum())


def spread_quotas(
    place_counts: np.ndarray,  # (Z_A,) seeded counts of placement domains
    ext_min: Optional[int],  # min count over pod-supported \ placement; None if D ⊆ A
    max_skew: int,
    min_domains: Optional[int],
    n_supported: int,  # |D|: pod-supported domains in the universe
    pods: int,
) -> Tuple[np.ndarray, int]:
    """Per-placement-domain quotas for one signature group → (quotas,
    unplaceable). Mirrors topologygroup.go:163-212 (see module
    docstring for the derivation)."""
    if min_domains is not None and n_supported < min_domains:
        ceiling: Optional[int] = max_skew  # global min treated as 0
    elif ext_min is not None:
        ceiling = ext_min + max_skew
    else:
        ceiling = None  # argmin filling alone keeps skew ≤ max_skew
    return water_fill(place_counts, pods, ceiling)


def interleave_by_quota(sorted_idx: np.ndarray, quotas: np.ndarray) -> List[np.ndarray]:
    """Split descending-sorted pod indices into per-domain arrays of the
    given sizes, interleaving ranks across domains (each domain gets a
    similar big/small mix so per-zone packing stays balanced).
    → list of index arrays, aligned with quotas."""
    Z = len(quotas)
    total = int(quotas.sum())
    if total == 0:
        return [sorted_idx[:0] for _ in range(Z)]
    # rank r of the assigned prefix goes to the domain whose (intra-domain
    # slot, domain) pair sorts r-th — a quota-aware round-robin
    zone_of = np.repeat(np.arange(Z), quotas)
    intra = np.concatenate([np.arange(int(q)) for q in quotas])
    assigned_zone = zone_of[np.lexsort((zone_of, intra))]
    prefix = sorted_idx[:total]
    return [prefix[assigned_zone == z] for z in range(Z)]


def seed_counts_for_selector(
    kube_client,
    exemplar,
    topology_key: str,
    label_selector,
    excluded_uids,
) -> Dict[str, int]:
    """Existing matching-pod counts per domain for a pod-affinity /
    anti-affinity term (no node filter — affinity counts every node,
    topologygroup.go:70-76 nil filter)."""
    if kube_client is None:
        return {}
    tg = TopologyGroup(
        TOPOLOGY_TYPE_POD_AFFINITY,
        topology_key,
        None,
        {exemplar.namespace},
        label_selector,
        0,
        None,
        set(),
    )
    return count_matching_pods_by_domain(kube_client, tg, excluded_uids)


def seed_counts_for_constraint(
    kube_client,
    exemplar,
    constraint,
    excluded_uids,
) -> Dict[str, int]:
    """Existing matching-pod counts per domain for one spread constraint
    (ref topology.go:238 countDomains): the constraint's selector, the
    exemplar's namespace and its node filter."""
    if kube_client is None:
        return {}
    tg = TopologyGroup(
        TOPOLOGY_TYPE_SPREAD,
        constraint.topology_key,
        exemplar,
        {exemplar.namespace},
        constraint.label_selector,
        constraint.max_skew,
        constraint.min_domains,
        set(),
    )
    return count_matching_pods_by_domain(kube_client, tg, excluded_uids)
