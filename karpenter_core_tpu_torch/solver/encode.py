"""Batch tensorization: pods / nodepools / instance types → mask and
resource tensors.

Key architectural move vs the reference: pods are deduplicated into
**constraint signatures** first (a deployment's pods share nodeSelector/
affinity/tolerations — only resource sizes differ), so all host-side
set algebra is per-signature (S « P) and everything per-pod is a flat
numeric array. The reference re-runs its set algebra per pod per node
candidate (nodeclaim.go:65-119); we run it S×pools times, then the
pods×types math is pure tensor ops.

Resources are quantized per-resource to int32 (ceil for requests,
floor for allocatable) so packing sums are exact and never overpack.

Host-side numpy, as in the JAX package's ``solver/encode.py``; only the
compat kernel's inputs leave the host (solver/compat_kernels.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..apis import labels as wk
from ..apis.nodepool import NodePool
from ..cloudprovider.types import InstanceType
from ..kube.objects import OP_DOES_NOT_EXIST, OP_NOT_IN, Pod
from ..scheduling import Requirement, Requirements, Taints
from .constraint_tensors import canonical_ports
from .stablehash import stable_hash
from ..scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    pod_requirements,
)
from .vocab import Vocab
from .contracts import contract

# canonical resource axis order; extras appended sorted
BASE_RESOURCES = ["cpu", "memory", "pods"]


def _is_neg(req: Requirement) -> bool:
    """Operator ∈ {NotIn, DoesNotExist} — the Intersects carve-out
    polarity (requirements.go:248-251)."""
    return req.operator() in (OP_NOT_IN, OP_DOES_NOT_EXIST)


@dataclass
class ResourceAxis:
    names: List[str]
    divisors: np.ndarray  # (R,) int64 per-resource quantization divisor

    @property
    def count(self) -> int:
        return len(self.names)

    def index(self, name: str) -> Optional[int]:
        try:
            return self.names.index(name)
        except ValueError:
            return None


def build_axis_from_capacities(capacities: Sequence[Dict[str, int]]) -> ResourceAxis:
    """Resource axis over arbitrary capacity dicts (instance types or
    existing nodes)."""
    names: Set[str] = set(BASE_RESOURCES)
    for cap in capacities:
        names.update(cap.keys())
    ordered = BASE_RESOURCES + sorted(names - set(BASE_RESOURCES))
    # per-resource divisor: keep the max value under 2^30 after division
    idx = {n: i for i, n in enumerate(ordered)}
    maxima = np.zeros(len(ordered), dtype=np.float64)
    for cap in capacities:
        for k, v in cap.items():
            i = idx[k]
            if v > maxima[i]:
                maxima[i] = v
    # divisors are 10^6 · 2^k (k ≥ 0): the quantized unit is a power-of-two
    # multiple of 1 milli, so whole-milli requests and capacities quantize
    # EXACTLY (ceil/floor agree with infinite precision) and exact-fit
    # packings survive quantization
    divisors = np.full(len(ordered), 10**6, dtype=np.int64)
    for i, m in enumerate(maxima):
        d = 10**6
        while m / d >= 2**30:
            d *= 2
        divisors[i] = d
    return ResourceAxis(ordered, divisors)


def build_catalog_axis(instance_types: Sequence[InstanceType]) -> ResourceAxis:
    """Resource axis determined by the catalog ALONE — stable across pod
    batches, which is what lets the encoded catalog be cached solve over
    solve. Pod-only extended resources are appended by ``extend_axis``;
    pod request magnitudes are handled by clamping (quantized requests
    saturate at 2^30, far above any capacity, so an oversized pod still
    reads as unschedulable)."""
    return build_axis_from_capacities([it.capacity for it in instance_types])


def extend_axis(
    axis: ResourceAxis, pods_requests: Sequence[Dict[str, int]]
) -> ResourceAxis:
    """Append pod-only resource names after the catalog columns (cached
    catalog tensors keep their column positions; their missing columns
    read as zero capacity, i.e. unschedulable — the reference's fits
    semantics for unregistered extended resources)."""
    known = set(axis.names)
    extra: Set[str] = set()
    for r in pods_requests:
        for k in r.keys():
            if k not in known:
                extra.add(k)
    if not extra:
        return axis
    return ResourceAxis(
        axis.names + sorted(extra),
        np.concatenate([axis.divisors, np.full(len(extra), 10**6, dtype=np.int64)]),
    )


def build_resource_axis(
    pods_requests: Sequence[Dict[str, int]], instance_types: Sequence[InstanceType]
) -> ResourceAxis:
    """The catalog axis of ``instance_types`` extended by the pods' own
    resource names (the consolidation screens' axis)."""
    return extend_axis(build_catalog_axis(instance_types), pods_requests)


@contract(None, None, out="P R", eval_shape=False)
def build_requests_matrix(all_requests: Sequence[Dict[str, int]], axis: ResourceAxis) -> np.ndarray:
    """(P, R) int32 ceil-quantized request matrix — one python pass to a
    milli-unit float64 matrix (exact: values < 2^53), then vectorized
    power-of-two ceil-division. Sub-milli request precision is floored
    (harmless: real requests are whole milli-units)."""
    P = len(all_requests)
    name_to_idx = {n: i for i, n in enumerate(axis.names)}
    milli = np.zeros((P, axis.count), dtype=np.float64)
    for p, requests in enumerate(all_requests):
        row = milli[p]
        for k, v in requests.items():
            i = name_to_idx.get(k)
            if i is not None:
                row[i] = -(-v // 10**6)  # ceil: never let a pod look smaller
    # axis divisors are nano-scale powers of two ≥ 2^20 in the large case;
    # convert to milli-scale (may drop below 1 → clamp). Quantized values
    # saturate at 2^30: beyond every capacity, so still unschedulable.
    div = np.maximum(axis.divisors.astype(np.float64) / 10**6, 1.0)
    return np.minimum(np.ceil(milli / div[None, :]), 2.0**30).astype(np.int32)


@contract("P", None, None, out="P R", eval_shape=False)
def build_requests_matrix_ids(
    req_ids: np.ndarray, axis: ResourceAxis, id_to_req: Dict[int, Dict[str, int]]
) -> np.ndarray:
    """(P, R) int32 request matrix from interned request ids (podcache):
    quantize each *unique* request shape once, then gather — the 50k-pod
    batch usually has a few dozen distinct request rows. ``id_to_req``
    is the batch's own id→dict view (from its memos), so a concurrent
    intern-table reset cannot orphan this batch's ids."""
    if req_ids.size == 0:
        return np.zeros((0, axis.count), dtype=np.int32)
    uniq, inv = np.unique(req_ids, return_inverse=True)
    rows = build_requests_matrix([id_to_req[int(u)] for u in uniq], axis)
    return rows[inv]


def unique_requests(
    req_ids: np.ndarray, id_to_req: Dict[int, Dict[str, int]]
) -> List[Dict[str, int]]:
    """The distinct request dicts behind a batch's interned ids."""
    return [id_to_req[int(u)] for u in np.unique(req_ids)]


@contract(None, None, out="R", eval_shape=False)
def quantize_requests(requests: Dict[str, int], axis: ResourceAxis) -> np.ndarray:
    """ceil-quantize a request ResourceList → int32 vector (conservative:
    never lets a pod look smaller)."""
    out = np.zeros(axis.count, dtype=np.int64)
    for k, v in requests.items():
        i = axis.index(k)
        if i is not None:
            # python-int division: nanos can exceed int64 after ×; saturate
            # at 2^30 (beyond every capacity) so the result fits int32
            out[i] = min(-(-int(v) // int(axis.divisors[i])), 2**30)
    return out.astype(np.int32)


@contract(None, None, out="R", eval_shape=False)
def quantize_capacity(capacity: Dict[str, int], axis: ResourceAxis) -> np.ndarray:
    """floor-quantize an allocatable ResourceList (conservative: never lets
    a node look bigger). Saturates at 2^30 - 1: an axis built from a
    smaller capacity population (e.g. the consolidation repack's
    candidate-only axis) can meet a larger fleet node, and a bare int32
    cast would wrap its capacity negative — silently zeroing it. One
    below the request-side clamp so a saturated REQUEST (2^30, 'beyond
    every capacity') still never fits a saturated capacity."""
    out = np.zeros(axis.count, dtype=np.int64)
    for k, v in capacity.items():
        i = axis.index(k)
        if i is not None:
            out[i] = min(max(int(v), 0) // int(axis.divisors[i]), 2**30 - 1)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# instance-type encoding


@dataclass
class EncodedInstanceTypes:
    """Per-NodePool tensor view of the catalog."""

    instance_types: List[InstanceType]
    axis: ResourceAxis
    allocatable: np.ndarray  # (T, R) int32, quantized
    prices: np.ndarray  # (T,) f64 — cheapest available offering price
    # per-key requirement masks, ragged over keys:
    key_masks: Dict[str, np.ndarray]  # key → (T, Vk) bool
    key_has: Dict[str, np.ndarray]  # key → (T,) bool
    key_neg: Dict[str, np.ndarray]  # key → (T,) bool
    # offering availability: (T, Z, C) bool over zone/capacity-type vocabs
    zones: List[str]
    capacity_types: List[str]
    offering_avail: np.ndarray
    offering_price: np.ndarray  # (T, Z, C) f64 (inf where unavailable)
    # per key, the (type index, Requirement) pairs behind key_masks — kept
    # so cached masks can be re-extended when the vocab grows (see
    # extend_encoded_masks)
    key_reqs: Dict[str, list] = field(default_factory=dict)
    # cross-solve derived-tensor caches (pareto frontiers, daemon-adjusted
    # allocatable) — they live and die with the encoding, so cached
    # catalog entries keep them warm across solves
    runtime_caches: Dict[tuple, np.ndarray] = field(default_factory=dict)


def encode_instance_types(instance_types: List[InstanceType], axis: ResourceAxis, vocab: Vocab) -> EncodedInstanceTypes:
    """Tensorize one catalog (cold path: cached across solves by
    solver._catalog_entry; traced because a catalog-generation bump
    re-pays it inside a live solve)."""
    return _encode_instance_types(instance_types, axis, vocab)


def _encode_instance_types(instance_types: List[InstanceType], axis: ResourceAxis, vocab: Vocab) -> EncodedInstanceTypes:
    T = len(instance_types)
    # observe all values first so vocab widths are final
    for it in instance_types:
        for req in it.requirements.values():
            vocab.observe_requirement(req)
    zones = sorted({o.zone for it in instance_types for o in it.offerings})
    capacity_types = sorted({o.capacity_type for it in instance_types for o in it.offerings})
    z_index = {z: i for i, z in enumerate(zones)}
    c_index = {c: i for i, c in enumerate(capacity_types)}

    allocatable = np.zeros((T, axis.count), dtype=np.int32)
    prices = np.full(T, np.inf)
    offering_avail = np.zeros((T, len(zones), len(capacity_types)), dtype=bool)
    offering_price = np.full((T, len(zones), len(capacity_types)), np.inf)
    keys = sorted({req.key for it in instance_types for req in it.requirements.values()})
    key_masks = {k: np.zeros((T, vocab.key_vocab(k).size), dtype=bool) for k in keys}
    key_has = {k: np.zeros(T, dtype=bool) for k in keys}
    key_neg = {k: np.zeros(T, dtype=bool) for k in keys}

    key_reqs: Dict[str, list] = {k: [] for k in keys}
    for t, it in enumerate(instance_types):
        allocatable[t] = quantize_capacity(it.allocatable(), axis)
        for o in it.offerings:
            if o.available:
                zi, ci = z_index[o.zone], c_index[o.capacity_type]
                offering_avail[t, zi, ci] = True
                offering_price[t, zi, ci] = o.price
                prices[t] = min(prices[t], o.price)
        for key, req in it.requirements.items():
            kv = vocab.key_vocab(key)
            key_masks[key][t] = vocab.encode_mask(req, kv.size)
            key_has[key][t] = True
            key_neg[key][t] = _is_neg(req)
            key_reqs[key].append((t, req))

    return EncodedInstanceTypes(
        instance_types=instance_types,
        axis=axis,
        allocatable=allocatable,
        prices=prices,
        key_masks=key_masks,
        key_has=key_has,
        key_neg=key_neg,
        zones=zones,
        capacity_types=capacity_types,
        offering_avail=offering_avail,
        offering_price=offering_price,
        key_reqs=key_reqs,
    )


def extend_encoded_masks(enc: EncodedInstanceTypes, vocab: Vocab) -> None:
    """Grow a cached encoding's masks to the vocab's current widths.

    New slots stand for values interned after the encoding was built
    (by later pod batches): an In-requirement never listed them (they
    would have been interned at build time) so its mask extends with
    False; complement requirements re-evaluate ``req.has`` so Gt/Lt
    bounds stay exact. OTHER sits at slot 0, so existing slots never
    move (vocab.py invariant)."""
    for key, mask in enc.key_masks.items():
        kv = vocab.key_vocab(key)
        new = kv.size
        old = mask.shape[1]
        if new <= old:
            continue
        padded = np.zeros((mask.shape[0], new), dtype=bool)
        padded[:, :old] = mask
        new_values = kv.values[old - 1 :]  # slot i (i≥1) ↔ values[i-1]
        for t, req in enc.key_reqs.get(key, ()):
            if req.complement:
                for j, v in enumerate(new_values):
                    padded[t, old + j] = req.has(v)
        enc.key_masks[key] = padded


# ---------------------------------------------------------------------------
# pod signatures


def _toleration_key(t) -> tuple:
    return (t.key, t.operator, t.value, t.effect)


def _selector_key(sel) -> tuple:
    if sel is None:
        return ()
    return sel.key()


def pod_signature(pod: Pod, relevant_label_keys: Optional[Set[str]] = None) -> tuple:
    """Constraint identity: pods with equal signatures are interchangeable
    for compat + topology purposes (resource sizes excluded). Only labels
    some selector in the batch can match participate — otherwise identical
    pods from different deployments would never share a node."""
    if relevant_label_keys is None:
        labels_key = tuple(sorted(pod.metadata.labels.items()))
    else:
        labels_key = tuple(
            sorted((k, v) for k, v in pod.metadata.labels.items() if k in relevant_label_keys)
        )
    # host ports and PVC-backed volumes are per-node stateful constraints
    # (hostportusage.go:70-90, volumeusage.go:79-178) — they join the
    # signature so port/volume-bearing pods never silently share a group
    # with unconstrained ones
    spec = pod.spec
    ports_key = tuple(
        sorted(
            (p.host_ip or "", p.host_port, p.protocol or "TCP")
            for c in spec.containers + spec.init_containers
            for p in c.ports
            if p.host_port
        )
    )
    volumes_key = tuple(
        sorted(
            (v.name, v.persistent_volume_claim or "", bool(v.ephemeral))
            for v in spec.volumes
            if v.persistent_volume_claim is not None or v.ephemeral
        )
    )
    # fast path: fully unconstrained pod (the common case at 50k scale)
    if (
        spec.affinity is None
        and not spec.node_selector
        and not spec.tolerations
        and not spec.topology_spread_constraints
        and not ports_key
        and not volumes_key
    ):
        return (pod.namespace, labels_key, (), (), (), (), (), ())
    spreads = tuple(
        (c.topology_key, c.max_skew, c.when_unsatisfiable, _selector_key(c.label_selector), c.min_domains)
        for c in pod.spec.topology_spread_constraints
    )
    aff = pod.spec.affinity
    node_aff_key: tuple = ()
    pod_aff_key: tuple = ()
    anti_aff_key: tuple = ()
    if aff is not None:
        if aff.node_affinity is not None:
            na = aff.node_affinity
            req_terms = (
                tuple(
                    tuple((e.key, e.operator, tuple(e.values)) for e in term.match_expressions)
                    for term in na.required.node_selector_terms
                )
                if na.required
                else ()
            )
            pref_terms = tuple(
                (p.weight, tuple((e.key, e.operator, tuple(e.values)) for e in p.preference.match_expressions))
                for p in na.preferred
            )
            node_aff_key = (req_terms, pref_terms)
        if aff.pod_affinity is not None:
            pod_aff_key = tuple(
                (t.topology_key, _selector_key(t.label_selector), tuple(t.namespaces))
                for t in aff.pod_affinity.required
            ) + tuple(
                (w.weight, w.pod_affinity_term.topology_key, _selector_key(w.pod_affinity_term.label_selector))
                for w in aff.pod_affinity.preferred
            )
        if aff.pod_anti_affinity is not None:
            anti_aff_key = tuple(
                (t.topology_key, _selector_key(t.label_selector), tuple(t.namespaces))
                for t in aff.pod_anti_affinity.required
            ) + tuple(
                (w.weight, w.pod_affinity_term.topology_key, _selector_key(w.pod_affinity_term.label_selector))
                for w in aff.pod_anti_affinity.preferred
            )
    return (
        pod.namespace,
        labels_key,
        tuple(sorted(pod.spec.node_selector.items())),
        tuple(sorted(_toleration_key(t) for t in pod.spec.tolerations)),
        spreads,
        node_aff_key,
        pod_aff_key,
        anti_aff_key,
        ports_key,
        volumes_key,
    )


@dataclass
class SignatureGroup:
    """Pods sharing one constraint signature."""

    signature: tuple
    exemplar: Pod
    pod_indices: List[int] = field(default_factory=list)  # into the batch array
    # interned signature id (podcache.intern_sig)
    sig_id: Optional[int] = None

    # -- topology predicates: which constraint shapes the group carries
    # and whether they tensorize (the JAX package's routing inputs)

    def _is_inns_term(self, term) -> bool:
        """Term scoped to the pod's own namespace (no namespace selector,
        namespaces empty or the pod's own)."""
        if term.namespace_selector is not None:
            return False
        ns = list(term.namespaces)
        return not ns or ns == [self.exemplar.namespace]

    def _is_self_term(self, term) -> bool:
        """The term's selector matches the exemplar's own labels in its
        own namespace (the per-deployment co-location/isolation pattern)."""
        sel = term.label_selector
        if sel is None or not sel.matches(self.exemplar.metadata.labels):
            return False
        return self._is_inns_term(term)

    def tensor_affinity_terms(self) -> Optional[list]:
        """The group's required pod-affinity terms when the whole set has
        the tensorizable shape: every term on zone/hostname, in-namespace,
        selector present, at most one hostname term, no preferred terms,
        no anti-affinity or spread mix — else None."""
        a = self.exemplar.spec.affinity
        if a is None or a.pod_affinity is None:
            return None
        if a.pod_anti_affinity is not None:
            return None
        if self.exemplar.spec.topology_spread_constraints:
            return None
        if a.pod_affinity.preferred or not a.pod_affinity.required:
            return None
        hostname_terms = 0
        for term in a.pod_affinity.required:
            if term.topology_key not in (wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME):
                return None
            if term.topology_key == wk.LABEL_HOSTNAME:
                hostname_terms += 1
            if term.label_selector is None:
                return None
            if not self._is_inns_term(term):
                return None
        if hostname_terms > 1:
            return None
        return list(a.pod_affinity.required)

    def tensor_pod_affinity(self) -> Optional[str]:
        """Primary topology key of the tensorizable required affinity
        terms (hostname when any term is host-scoped, else zone); None
        when the shape is not tensorizable."""
        terms = self.tensor_affinity_terms()
        if terms is None:
            return None
        if any(t.topology_key == wk.LABEL_HOSTNAME for t in terms):
            return wk.LABEL_HOSTNAME
        return wk.LABEL_TOPOLOGY_ZONE

    def affinity_terms(self) -> list:
        """The required pod-affinity terms behind tensor_pod_affinity
        (call only when it returned a key)."""
        return list(self.exemplar.spec.affinity.pod_affinity.required)

    def affinity_term(self):
        """First required pod-affinity term (single-term callers)."""
        return self.exemplar.spec.affinity.pod_affinity.required[0]

    def affinity_self_selecting(self) -> bool:
        """Whether the group's pods match every one of their own affinity
        selectors — gates the bootstrap-one-domain rule
        (topologygroup.go:226-232: only self-selecting pods may seed an
        empty domain)."""
        return all(
            t.label_selector is None or t.label_selector.matches(self.exemplar.metadata.labels)
            for t in self.affinity_terms()
        )

    def self_pod_affinity(self) -> Optional[str]:
        """Topology key of a single self-selecting required pod-affinity
        term on zone/hostname, when that is the group's only affinity
        shape — else None."""
        key = self.tensor_pod_affinity()
        if key is None or not self._is_self_term(self.affinity_term()):
            return None
        return key

    @property
    def zone_anti_isolated(self) -> bool:
        """Required self-anti-affinity on zone: at most one pod of the
        group per zone."""
        a = self.exemplar.spec.affinity
        if a is None or a.pod_anti_affinity is None:
            return False
        return any(
            term.topology_key == wk.LABEL_TOPOLOGY_ZONE and self._is_self_term(term)
            for term in a.pod_anti_affinity.required
        )

    def tensor_anti_terms(self) -> Optional[list]:
        """The group's required anti-affinity terms when the whole set
        tensorizes: every term on zone/hostname and in-namespace, no
        preferred terms, no pod-affinity mix; mixed with spread only when
        every selector-bearing term is a hostname self term. Else None."""
        a = self.exemplar.spec.affinity
        if a is None or a.pod_anti_affinity is None:
            return None
        if a.pod_anti_affinity.preferred:
            return None
        if a.pod_affinity is not None:
            return None
        req = list(a.pod_anti_affinity.required)
        if not req:
            return None
        for term in req:
            if term.topology_key not in (wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME):
                return None
            if term.label_selector is not None and not self._is_inns_term(term):
                return None
        if self.exemplar.spec.topology_spread_constraints and not all(
            t.topology_key == wk.LABEL_HOSTNAME and self._is_self_term(t)
            for t in req
            if t.label_selector is not None
        ):
            return None
        return req

    def anti_exclusion_terms(self) -> list:
        """Non-self tensor anti terms (the selector anchors to other
        pods); empty when none tensorize."""
        terms = self.tensor_anti_terms()
        if terms is None:
            return []
        return [t for t in terms if t.label_selector is not None and not self._is_self_term(t)]

    @property
    def has_relational(self) -> bool:
        """Pod affinity or anti-affinity of a shape that does not
        tensorize (needs the oracle's per-pod walk)."""
        a = self.exemplar.spec.affinity
        if a is None:
            return False
        if a.pod_affinity is not None and (a.pod_affinity.required or a.pod_affinity.preferred):
            if self.tensor_affinity_terms() is None:
                return True
        if a.pod_anti_affinity is not None:
            if self.tensor_anti_terms() is None:
                return True
        return False

    @property
    def has_stateful_node_constraints(self) -> bool:
        """Host ports or PVC volumes: per-node conflict state
        (hostportusage.go:70, volumeusage.go:79)."""
        spec = self.exemplar.spec
        if any(p.host_port for c in spec.containers + spec.init_containers for p in c.ports):
            return True
        return any(v.persistent_volume_claim is not None or v.ephemeral for v in spec.volumes)

    @property
    def tensor_stateful(self) -> bool:
        """Stateful group without pod affinity, anti-affinity or spread
        (the shape the JAX package folds into its pack scan)."""
        if not self.has_stateful_node_constraints:
            return False
        spec = self.exemplar.spec
        if spec.topology_spread_constraints:
            return False
        a = spec.affinity
        return a is None or (a.pod_affinity is None and a.pod_anti_affinity is None)

    def host_ports(self) -> tuple:
        """Canonical (protocol, port, ip) triples of the group's host
        ports (identical across members: ports ride the signature)."""
        return canonical_ports(self.exemplar)

    @property
    def has_volumes(self) -> bool:
        return any(
            v.persistent_volume_claim is not None or v.ephemeral for v in self.exemplar.spec.volumes
        )

    @property
    def hostname_isolated(self) -> bool:
        """Required self-anti-affinity on hostname: one pod per node."""
        a = self.exemplar.spec.affinity
        if a is None or a.pod_anti_affinity is None:
            return False
        return any(
            term.topology_key == wk.LABEL_HOSTNAME and self._is_self_term(term)
            for term in a.pod_anti_affinity.required
        )

    def zone_spread(self):
        """The zone topology-spread constraint, if any."""
        for c in self.exemplar.spec.topology_spread_constraints:
            if c.topology_key == wk.LABEL_TOPOLOGY_ZONE:
                return c
        return None

    def hostname_spread(self):
        """The hostname topology-spread constraint, if any."""
        for c in self.exemplar.spec.topology_spread_constraints:
            if c.topology_key == wk.LABEL_HOSTNAME:
                return c
        return None


def group_pods(pods: List[Pod], memos=None) -> List[SignatureGroup]:
    """Signature-group the batch. Signatures are memoized per pod
    (podcache), revalidated against the batch's relevant-label-key set:
    two batches with different selector populations filter different
    label subsets into the signature, so the memo carries the
    fingerprint it was computed under."""
    from . import podcache

    if memos is None:
        memos = podcache.get_memos(pods)
    relevant: Set[str] = set()
    for m in memos:
        if m.selector_keys:
            relevant.update(m.selector_keys)
    # process-stable digest (NOT builtin hash: the relevant-label
    # fingerprint rides in pod memos that the bench's restart-shaped
    # cold solver must reproduce bit-identically under any hash seed)
    fp = stable_hash(tuple(sorted(relevant)))
    groups: Dict[int, SignatureGroup] = {}
    get = groups.get
    for i, (pod, m) in enumerate(zip(pods, memos)):
        # read/write sig_state as one atomic reference; use LOCALS for
        # grouping so a concurrent group_pods (different fingerprint, e.g.
        # a disruption simulation) can overwrite the memo without this
        # batch mixing the two fingerprints' signatures
        state = m.sig_state
        if state is None or state[0] != fp:
            sig = pod_signature(pod, relevant)
            state = (fp, sig, podcache.intern_sig(sig))
            m.sig_state = state
        g = get(state[2])
        if g is None:
            g = SignatureGroup(signature=state[1], exemplar=pod, sig_id=state[2])
            groups[state[2]] = g
        g.pod_indices.append(i)
    return list(groups.values())


# ---------------------------------------------------------------------------
# signature × pool compatibility (host-side set algebra, S×pools small)


@dataclass
class PoolEncoding:
    nodepool: NodePool
    template_requirements: Requirements
    taints: Taints


@dataclass
class SignaturePoolCompat:
    """Host-side verdicts + merged requirement masks for one (signature,
    pool) pair; feeds the instance-type compat kernel."""

    compatible: bool  # pod vs template (taints + Compatible w/ well-known)
    error: str = ""
    # merged (template ∩ pod) requirement encoding, per key:
    key_mask: Dict[str, np.ndarray] = field(default_factory=dict)  # key → (Vk,) bool
    key_has: Dict[str, bool] = field(default_factory=dict)
    key_neg: Dict[str, bool] = field(default_factory=dict)
    merged: Optional[Requirements] = None


def encode_signature_for_pool(
    group: SignatureGroup, pool: PoolEncoding, vocab: Vocab
) -> SignaturePoolCompat:
    """The oracle's per-pod template checks, once per signature
    (nodeclaim.go:65-101 minus topology)."""
    pod = group.exemplar
    err = pool.taints.tolerates(pod)
    if err:
        return SignaturePoolCompat(False, err)
    pod_reqs = pod_requirements(pod)
    err = pool.template_requirements.compatible(pod_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
    if err:
        return SignaturePoolCompat(False, f"incompatible requirements, {err}")
    merged = Requirements(*pool.template_requirements.values_list())
    merged.add(*pod_reqs.values_list())
    out = SignaturePoolCompat(True, merged=merged)
    for key, req in merged.items():
        for v in req.values:
            vocab.key_vocab(key).intern(v)
        out.key_has[key] = True
        out.key_neg[key] = _is_neg(req)
        out.key_mask[key] = req  # mask encoded later, after vocab is final
    return out


def finalize_signature_masks(compats: List[SignaturePoolCompat], vocab: Vocab) -> None:
    """Second pass: encode masks once every value has been interned."""
    for c in compats:
        if not c.compatible:
            continue
        for key, req in list(c.key_mask.items()):
            if isinstance(req, Requirement):
                c.key_mask[key] = vocab.encode_mask(req, vocab.key_vocab(key).size)
