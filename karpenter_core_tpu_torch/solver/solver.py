"""TorchScheduler: the batched provisioning solve on PyTorch and CUDA.

Counterpart of ``karpenter_core_tpu/solver/solver.py::TPUScheduler`` on
its tensor path:

  host:   route signature groups (the JAX package's default constraint
          engine): tensor groups, parked pod-affinity groups, and the
          groups the tensor path does not take (preferred pod (anti-)
          affinity, pod affinity mixed with anti-affinity or spread, two
          hostname affinity terms, terms on other keys or namespaces,
          anti-affinity whose selector matches another group of the
          batch, host ports or volumes together with a spread or pod
          (anti-)affinity, and the groups those count), which go to the
          greedy scheduler
  host:   PersistentVolume and StorageClass zone pins join the node
          affinity of volume-bearing pods (VolumeTopology.inject)
  host:   signature-group pods → first-fit onto existing nodes
          (existing_node_compat → native/pack.cc, or with
          KARPENTER_TORCH_NATIVE=0 csrc/pack_existing.cu on the card), free capacity net of
          the daemons each node still has to run, nodes holding a pod a
          non-self anti-affinity term counts masked out; topology-
          constrained groups wait for their domains; host-port and
          volume groups follow one at a time, their ports and ephemeral
          claims as extra first-fit columns and the CSI attach limits as
          a per-node mask (constraint_tensors.py)
  host:   leftover and parked pods → per-(signature, pool) set algebra
  device: ONE compat ∧ offering kernel launch per pool against the
          catalog's card-resident type side (solver/compat_kernels.py)
  host:   bounded, NodePool-limit-aware pack rounds: non-self zone
          anti-affinity narrows each group's zones before its frontier,
          zone-spread groups water-fill seeded per-zone counts
          (topology_tensor.py) and try their zone's existing nodes first,
          hostname-capped groups fill per-node quotas on existing nodes,
          zone self-anti-affinity groups take one pod per free zone, then
          class-merged and zone-pinned pack jobs (new nodes carry their
          pool's daemonset overhead and per-node pod caps; host ports
          are extra request and frontier columns) → the pack backend
          (backends/: ffd, lp or auto, KARPENTER_TORCH_PACK_BACKEND):
          first-fit-decreasing on the C++ packer (native/pack.cc), or
          with KARPENTER_TORCH_NATIVE=0 the FFD scan kernel on the card
          (csrc/ffd_pack.cu); the lp backend adds the dual-ascent kernel
          (csrc/dual_ascent.cu), repair packs and a cost guard → cheapest
          type/offering per node → cross-group merge of underfull nodes
          under each side's per-node hostname limits and host ports
          (merge.py; a merge of an LP-chosen node may not raise its
          price) → NodePlans, stripped where a NodePool limit is
          exceeded
  host:   the pod-affinity post-pass: parked groups one at a time in
          anchor-dependency order, each against the placements committed
          so far (zone anchors intersected per term, hostname anchors on
          existing nodes and on planned nodes, which grow their type to
          take joiners or give up one matching pod to seed a fresh
          anchor), to a fixpoint; run again with the donor guard where
          that fixpoint strands a pod from its hostname anchors
  host:   preference relaxation (scheduler/preferences.py's ladder): each
          round strips one soft constraint from a copy of every failed
          group's exemplar, back-fills the relaxed pods onto this solve's
          node plans where they fit, and sends the rest through another
          tensor pass (one more kernel launch per pool), until nothing
          relaxes
  host:   the greedy scheduler (scheduler/, its instance-type filter
          vectorised over the tensor path's host encodings by
          oracle_bridge.py) for the routed-off pods, against copies of
          the existing nodes that carry the tensor path's placements

Spread and affinity seeds count the pods bound in ``kube_client`` (the
JAX package's ``kube_client``). Across solves the JAX package's warm
state holds (incremental.py, per cloud provider and device): a tick
whose inputs are provably the last one's replays whole; otherwise the
route split, the compat rows of known signatures (the kernel launches
for the missing ones only), the pack and finalize of known jobs, the
merge pass and the seeds (while the cluster's generation holds) come
from their memos, content-addressed, so a warm solve is plan-identical
to a cold one (``KARPENTER_TORCH_INCREMENTAL=0``); warmstore.py writes
and restores them. The catalog encodings live in a process-wide cache.
``cluster`` (state.cluster), ``recorder`` (events)
and ``metrics`` (metrics.registry) are the JAX package's: the greedy
fallback walks the cluster's bound anti-affinity pods, nominates its
existing nodes and publishes its events; each solve runs under a
``trace_root("solve")`` (joining the provisioner's trace), its phases
are spans, and its duration, device time, route split, cache and LP
counters feed the metrics. Five
knobs are read as the JAX package reads their ``KARPENTER_TPU_*``
twins (``KARPENTER_TORCH_PACK_BACKEND``, ``_NATIVE``, ``_LP_MIN_WORK``,
``_INCREMENTAL``, ``_CATALOG_CACHE_MAX``); its other defaults the port
depends on are module constants (pack.NATIVE_K_OPEN,
compat_kernels.COMPAT_TILE_BYTES, lp.LP_ITERS, lp.LP_REFINE_ROUNDS,
lp.LP_BRANCH_K, plancost.COST_WEIGHTS, the cache caps in incremental,
the warm store's directory and size cap, the vector merge engine, the
tensor constraint engine). A fleet tenant's solver carries a tenant
scope (``tenant=``) in every memo key, and the batched fleet engine's
content plane (``fleet_plane``) shares job skeletons across tenants.
"""

from __future__ import annotations

import copy
import hashlib
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..apis import labels as wk
from ..buildlib import same_device
from ..apis.nodepool import NodePool, order_by_weight
from ..cloudprovider.types import CloudProvider, InstanceType
from ..kube.objects import EFFECT_PREFER_NO_SCHEDULE, OP_IN, SCHEDULE_ANYWAY, Pod
from ..scheduler.builder import build_scheduler
from ..scheduler.preferences import Preferences
from ..scheduler.topology import TopologyNodeFilter
from ..scheduler.volumetopology import VolumeTopology
from ..scheduling import Requirement, Requirements, Taints, resources
from ..scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    label_requirements,
    node_selector_requirements,
    pod_requirements,
)
from ..scheduling.volumes import Volumes
from ..tracing import deviceplane, tracer
from . import backends, devicetime, plancost, podcache, sharding
from .backend import resolve_device
from .compat_kernels import COMPAT_ALLOWED, DeviceCatalog, allowed_via_kernel, catalog_to_device, signature_side
from .constraint_tensors import (
    GroupVolumes,
    PortFeatures,
    eph_free_columns,
    node_reserved_ports,
    ports_conflict,
    ports_from_triples,
    resolve_group_volumes,
    volume_admit_row,
)
from .encode import (
    EncodedInstanceTypes,
    PoolEncoding,
    ResourceAxis,
    SignatureGroup,
    _selector_key,
    build_axis_from_capacities,
    build_catalog_axis,
    build_requests_matrix_ids,
    encode_instance_types,
    encode_signature_for_pool,
    extend_axis,
    extend_encoded_masks,
    finalize_signature_masks,
    group_pods,
    quantize_capacity,
    quantize_requests,
    unique_requests,
)
from .kernels import build_compat_inputs, zone_ct_masks
from .merge import merge_records_vector
from . import incremental
from .incremental import CacheStats, JobSkeleton, SigRow
from .pack import (
    assign_cheapest_types,
    node_usage_from_assignment,
    pareto_frontier,
    run_pack_existing,
)
from .stablehash import feed as stable_feed
from .topology_tensor import (
    interleave_by_quota,
    seed_counts_for_constraint,
    seed_counts_for_selector,
    spread_quotas,
    water_fill,
)
from .vocab import Vocab

log = logging.getLogger("karpenter.torch.solver")


def catalog_cache_max() -> int:
    """Cached catalog encodings kept process-wide, read at each insert as
    the JAX package reads ``KARPENTER_TPU_CATALOG_CACHE_MAX`` (default 8;
    a fleet raises it to hold every tenant's catalog)."""
    try:
        return max(1, int(os.environ.get("KARPENTER_TORCH_CATALOG_CACHE_MAX", "8")))
    except ValueError:
        return 8


# bounded per-encoding derived-tensor cache (frontiers, ranks, prices)
_RUNTIME_CACHE_MAX = 256

MAX_INT32 = 2**31 - 1

# wall-time phases of a solve, reported in ``last_timings`` as "<phase>_ms":
# group (pod memos + signature grouping), existing (existing-node compat,
# free capacity and the first-fit onto existing nodes), encode (catalog
# and signature encode, daemonset overhead, the compat kernel and its
# sync), prepare (pool choice and class-merged pack jobs), pack (the pack
# backend: the C++ packer or the FFD scan kernel, and the LP's relaxations
# and repair packs), finalize (usage, cheapest type and offering per node), merge
# (the cross-group merge and its emit), limits (NodePool remaining
# limits, their type masks and the enforcement after each pack round),
# affinity (the pod-affinity post-pass), relax (the preference-relaxation
# retry's own work: relaxing exemplars, committing placements, the
# back-fill onto this solve's plans; the JAX package's relax_retry span),
# oracle (the commit onto the node copies and the greedy scheduler; its
# oracle_fallback span). Phases partition the solve: a phase entered
# inside another (the post-pass's packs and merges, the retry's tensor
# passes) counts in its own phase only.
PHASES = (
    "group", "existing", "encode", "prepare", "pack", "finalize", "merge", "limits", "affinity",
    "relax", "oracle",
)


@dataclass
class _CatalogEntry:
    """One catalog generation's tensorization, cached across solves and
    solvers in ``_CATALOG_CACHE``. Keyed by the catalog's object identity
    (the strong ``catalog`` ref keeps the ids stable) and revalidated by
    the provider's catalog generation or a content fingerprint. The
    vocab grows monotonically as pod batches intern new values; cached
    masks are re-extended in place (encode.extend_encoded_masks)."""

    catalog: List[InstanceType]
    fingerprint: bytes
    vocab: Vocab
    axis: ResourceAxis
    enc: EncodedInstanceTypes
    # provider catalog generation this entry was validated against (a
    # matching generation skips the content fingerprint on lookup)
    generation: Optional[int] = None
    # cross-solve compat rows: (pool fingerprint, interned sig id, device)
    # → incremental.SigRow, LRU-capped, living and dying with the entry
    sig_rows: "OrderedDict[tuple, SigRow]" = field(default_factory=OrderedDict)
    # ((vocab-width snapshot, device), DeviceCatalog): the kernel's type
    # side, resident on one device, re-packed when the vocab grew or a
    # solver on another device asks
    device_catalog: Optional[Tuple[tuple, DeviceCatalog]] = None
    # ((vocab-width snapshot, shards, device), (DeviceCatalog, T)): the
    # type side padded to a mesh's shards (sharding.prepare_sharded_catalog)
    sharded_catalog: Optional[Tuple[tuple, tuple]] = None
    # the cloud providers whose solvers resolved to this entry, held
    # weakly: once all are gone the entry is released at the next lookup
    # (it holds its catalog strongly, and a dropped world's catalog of
    # thousands of types would otherwise stay in the heap until LRU)
    owners: "weakref.WeakSet" = field(default_factory=weakref.WeakSet)
    owned: bool = False

    def own(self, owner) -> None:
        if owner is not None:
            self.owners.add(owner)
            self.owned = True

    def orphaned(self) -> bool:
        return self.owned and not self.owners


def _release_orphans() -> None:
    """Drop the entries whose owners are all gone (callers hold
    _CATALOG_LOCK)."""
    for k in [k for k, e in _CATALOG_CACHE.items() if e.orphaned()]:
        del _CATALOG_CACHE[k]


def _cache_insert(key: tuple, entry: _CatalogEntry, stats=None) -> None:
    """Insert ``entry`` into ``_CATALOG_CACHE`` (callers hold
    _CATALOG_LOCK): orphaned entries are released first, then the least
    recently used beyond ``catalog_cache_max()`` (counted as evictions)."""
    _release_orphans()
    _CATALOG_CACHE[key] = entry
    _CATALOG_CACHE.move_to_end(key)
    cap = catalog_cache_max()
    while len(_CATALOG_CACHE) > cap:
        _CATALOG_CACHE.popitem(last=False)
        if stats is not None:
            stats.evict("catalog")


def _sig_rows_put(entry: _CatalogEntry, key: tuple, row: SigRow, stats) -> None:
    """Bounded insert into an entry's compat-row cache (callers hold
    _CATALOG_LOCK: the entry is shared across solvers)."""
    entry.sig_rows[key] = row
    entry.sig_rows.move_to_end(key)
    cap = incremental.cache_cap("compat")
    while len(entry.sig_rows) > cap:
        entry.sig_rows.popitem(last=False)
        if stats is not None:
            stats.evict("compat")


_CATALOG_CACHE: "OrderedDict[tuple, _CatalogEntry]" = OrderedDict()
# guards the cache and in-place mutation of its entries (vocab interning,
# extend_encoded_masks, the device-resident type side, compat rows):
# entries are shared by every solver of the process
_CATALOG_LOCK = threading.RLock()


def _catalog_entry(
    catalog: List[InstanceType], generation: Optional[int] = None, stats=None, owner=None
) -> _CatalogEntry:
    """``catalog``'s encoding from the process-wide cache, encoded and
    inserted on a miss; the cache keeps the ``catalog_cache_max()`` most
    recently used, and releases at each lookup the entries whose owners
    (the cloud providers that asked for them) are all gone. An unchanged
    provider generation skips the content fingerprint; otherwise the
    fingerprint revalidates the identity key."""
    # analysis: allow-cache-determinism(id) — an identity key, never persisted: the entry holds its catalog strongly and every lookup revalidates it (generation, else the content fingerprint)
    key = tuple(map(id, catalog))
    if generation is not None:
        with _CATALOG_LOCK:
            _release_orphans()
            entry = _CATALOG_CACHE.get(key)
            if entry is not None and entry.generation == generation:
                _CATALOG_CACHE.move_to_end(key)
                entry.own(owner)
                if stats is not None:
                    stats.hit("catalog")
                return entry
    fp = _catalog_fingerprint(catalog)
    with _CATALOG_LOCK:
        _release_orphans()
        entry = _CATALOG_CACHE.get(key)
        if entry is not None and entry.fingerprint == fp:
            entry.generation = generation
            _CATALOG_CACHE.move_to_end(key)
            entry.own(owner)
            if stats is not None:
                stats.hit("catalog")
            return entry
        if stats is not None:
            stats.miss("catalog")
        vocab = Vocab()
        axis = build_catalog_axis(catalog)
        enc = encode_instance_types(list(catalog), axis, vocab)
        entry = _CatalogEntry(list(catalog), fp, vocab, axis, enc, generation=generation)
        entry.own(owner)
        # analysis: allow-cache-key(generation, owner) — generation is the guard each lookup revalidates (else the content fingerprint); owner only lists who holds the entry, for its release
        _cache_insert(key, entry, stats)
        return entry


def _cache_put(enc: EncodedInstanceTypes, key: tuple, value) -> None:
    if len(enc.runtime_caches) > _RUNTIME_CACHE_MAX:
        enc.runtime_caches.clear()
    enc.runtime_caches[key] = value


def _offering_pmin(enc: EncodedInstanceTypes, zmask: np.ndarray, ct_ok: np.ndarray) -> np.ndarray:
    """(T,) cheapest offering price per type within a (zone, capacity-
    type) mask (offering_price is inf where no offering exists)."""
    key = ("pmin", zmask.tobytes(), ct_ok.tobytes())
    cached = enc.runtime_caches.get(key)
    if cached is None:
        T = len(enc.instance_types)
        prices = enc.offering_price[:, zmask][:, :, ct_ok].reshape(T, -1)
        cached = prices.min(axis=1) if prices.size else np.full(T, np.inf)
        _cache_put(enc, key, cached)
    return cached


def _offering_rank(enc: EncodedInstanceTypes) -> np.ndarray:
    """(Z, C) stable offering ordinal: lexicographic rank of the (zone
    name, capacity-type name) pair. Price-tie argmins break on this
    content id, never on array position."""
    key = ("offrank",)
    cached = enc.runtime_caches.get(key)
    if cached is None:
        pairs = [(z, c) for z in enc.zones for c in enc.capacity_types]
        order = sorted(range(len(pairs)), key=lambda i: pairs[i])
        rank = np.empty(len(pairs), dtype=np.int64)
        rank[order] = np.arange(len(pairs))
        cached = rank.reshape(len(enc.zones), len(enc.capacity_types))
        _cache_put(enc, key, cached)
    return cached


def _type_rank(enc: EncodedInstanceTypes) -> np.ndarray:
    """(T,) stable type ordinal: rank of the instance type's name (ties
    on duplicate names fall back to catalog position)."""
    key = ("typerank",)
    cached = enc.runtime_caches.get(key)
    if cached is None:
        names = [it.name for it in enc.instance_types]
        order = sorted(range(len(names)), key=lambda i: (names[i], i))
        cached = np.empty(len(names), dtype=np.int64)
        cached[order] = np.arange(len(names))
        _cache_put(enc, key, cached)
    return cached


def _stable_argmin(values: np.ndarray, rank: np.ndarray) -> int:
    """Index of the minimum of ``values``; exact ties resolve to the
    smallest ``rank`` (a stable content id), not the first position."""
    lo = values.min()
    if not np.isfinite(lo):
        return int(np.argmin(values))
    tied = values == lo
    return int(np.flatnonzero(tied)[np.argmin(rank[tied])])


def _rank_order(idx: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """``idx`` reordered by its elements' ``rank`` (stable)."""
    return idx[np.argsort(rank[idx], kind="stable")]


def _job_prices(meta: dict) -> np.ndarray:
    """Per viable type, the cheapest offering price admitted by the
    job's zone/capacity-type requirements (zone-pinned when set) — the
    price model for packed nodes."""
    enc = meta["enc"]
    viable_idx = meta["viable_idx"]
    zone_ok, ct_ok, zone = meta["zone_ok"], meta["ct_ok"], meta["zone"]
    if zone is not None:
        zi = enc.zones.index(zone)
        zprices = enc.offering_price[viable_idx, zi, :][:, ct_ok]
        return np.where(np.isfinite(zprices), zprices, np.inf).min(axis=1)
    op = enc.offering_price[viable_idx][:, zone_ok, :][:, :, ct_ok].reshape(len(viable_idx), -1)
    if not op.size:
        return np.full(len(viable_idx), np.inf)
    return np.where(np.isfinite(op), op, np.inf).min(axis=1)


def _group_node_limits(group: SignatureGroup) -> list:
    """Hostname-level per-node constraints a node holding this group's
    pods must keep satisfying if other pods merge onto it: (selector,
    namespace, max matching pods per node) triples from hostname
    topology spread and hostname anti-affinity. A non-self hostname anti
    term contributes cap 0: the node must never gain a selector-matching
    pod (routing keeps every batch group off such selectors, so the
    limit guards merges and joins)."""
    limits = []
    ns = group.exemplar.namespace
    hs = group.hostname_spread()
    if hs is not None:
        limits.append((hs.label_selector, ns, int(hs.max_skew)))
    for term in group.tensor_anti_terms() or ():
        if term.topology_key != wk.LABEL_HOSTNAME or term.label_selector is None:
            continue
        limits.append((term.label_selector, ns, 1 if group._is_self_term(term) else 0))
    return limits


def _viable_zones(
    enc: EncodedInstanceTypes,
    viable: np.ndarray,
    zone_ok: np.ndarray,
    ct_ok: np.ndarray,
) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Zones the signature allows that have ≥1 viable type with an
    available allowed offering, plus each zone's viable-type mask."""
    zones = [z for zi, z in enumerate(enc.zones) if zone_ok[zi]]
    zone_types = {
        z: viable & enc.offering_avail[:, enc.zones.index(z), :][:, ct_ok].any(axis=1)
        for z in zones
    }
    return [z for z in zones if zone_types[z].any()], zone_types


def _requirements_fingerprint(reqs) -> tuple:
    return () if reqs is None else reqs.fingerprint()


def _catalog_fingerprint(catalog: List[InstanceType]) -> bytes:
    """Process-stable content fingerprint of the fields the encoding
    depends on: requirements, capacity and the full offering tuples."""
    h = hashlib.blake2b(digest_size=16)
    up = h.update
    for it in catalog:
        nb = it.name.encode()
        up(b"t%d:" % len(nb))
        up(nb)
        reqs = it.requirements
        up(reqs.fingerprint_digest() if reqs is not None else b"N")
        cap = it.capacity
        for k in sorted(cap):
            kb = k.encode()
            up(b"c%d:" % len(kb))
            up(kb)
            stable_feed(h, cap[k])
        for o in it.offerings:
            zb = o.zone.encode()
            cb = o.capacity_type.encode()
            up(b"o%d:" % len(zb))
            up(zb)
            up(b"%d:" % len(cb))
            up(cb)
            up(b"T" if o.available else b"F")
            stable_feed(h, o.price)
    return h.digest()


def _entry_sharded(entry: _CatalogEntry, mesh) -> tuple:
    """The kernel's type side for ``entry`` padded to ``mesh``'s shards
    and resident on its card; uploaded again only when the vocab grew or
    the mesh changed (the reference's ``_entry_sharded``)."""
    enc = entry.enc
    keys = tuple(sorted(enc.key_masks.keys()))
    key = (
        tuple((k, entry.vocab.key_vocab(k).size) for k in keys),
        int(mesh.size),
        tuple(str(d) for d in mesh.placements),
    )
    if entry.sharded_catalog is not None and entry.sharded_catalog[0] == key:
        return entry.sharded_catalog[1]
    prepared = sharding.prepare_sharded_catalog(
        mesh, enc.key_masks, enc.key_has, enc.key_neg, enc.offering_avail, keys
    )
    entry.sharded_catalog = (key, prepared)
    return prepared


def existing_node_compat(groups: List[SignatureGroup], nodes: list) -> np.ndarray:
    """(S, M) uint8 admissibility of each signature group on each
    existing node: taints tolerated + node labels satisfy the group's
    requirements (existingnode.go:64-82). Computed once per node CLASS
    (labels minus hostname + taints) — fleets have few classes, so the
    host set algebra is O(S·classes); hostname-pinned signatures resolve
    per node."""
    S, M = len(groups), len(nodes)
    sig_reqs = [pod_requirements(g.exemplar) for g in groups]
    hostname_sigs = {s for s, r in enumerate(sig_reqs) if wk.LABEL_HOSTNAME in r}
    compat = np.zeros((S, M), dtype=np.uint8)
    node_taints = [Taints(n.taints()) for n in nodes]
    class_cols: Dict[tuple, np.ndarray] = {}
    for m, node in enumerate(nodes):
        labels = node.labels()
        ckey = (
            tuple(sorted((k, v) for k, v in labels.items() if k != wk.LABEL_HOSTNAME)),
            tuple(sorted((t.key, t.value, t.effect) for t in node.taints())),
        )
        col = class_cols.get(ckey)
        if col is None:
            class_reqs = label_requirements(
                {k: v for k, v in labels.items() if k != wk.LABEL_HOSTNAME}
            )
            col = np.zeros(S, dtype=np.uint8)
            for s, g in enumerate(groups):
                if s in hostname_sigs:
                    continue  # resolved per node below
                col[s] = (
                    node_taints[m].tolerates(g.exemplar) is None
                    and class_reqs.compatible(sig_reqs[s], hint=False) is None
                )
            class_cols[ckey] = col
        compat[:, m] = col
    for s in hostname_sigs:
        g = groups[s]
        for m, node in enumerate(nodes):
            node_reqs = label_requirements(node.labels())
            node_reqs.add(Requirement(wk.LABEL_HOSTNAME, OP_IN, [node.hostname()]))
            compat[s, m] = (
                node_taints[m].tolerates(g.exemplar) is None
                and node_reqs.compatible(sig_reqs[s], hint=False) is None
            )
    return compat


@dataclass
class NodePlan:
    """One node the solver decided to create."""

    nodepool_name: str
    instance_type: InstanceType
    zone: str
    capacity_type: str
    price: float
    pod_indices: List[int]  # into the solve batch
    pods: Optional[List[Pod]] = None  # resolved by the provisioner for events
    # merged (template ∩ pods) requirement set for the node
    requirements: Optional[object] = None
    max_pods_per_node: int = MAX_INT32
    node_limits: list = field(default_factory=list)
    _pod_requests: Optional[list] = field(default=None, repr=False)
    _requests: Optional[dict] = field(default=None, repr=False)
    # the post-pass charged this plan's capacity to its pool's limits
    # when it opened it (a reseeded anchor): enforcement skips it
    _limits_accounted: bool = field(default=False, repr=False)

    @property
    def requests(self) -> Optional[dict]:
        if self._requests is None and self._pod_requests is not None:
            self._requests = resources.merge(*self._pod_requests)
        return self._requests


@dataclass
class ExistingNodePlan:
    """Pods placed onto an existing node."""

    state_node: object
    pod_indices: List[int]
    pods: Optional[List[Pod]] = None


@dataclass
class SolverResult:
    node_plans: List[NodePlan] = field(default_factory=list)
    existing_plans: List[ExistingNodePlan] = field(default_factory=list)
    pod_errors: Dict[str, str] = field(default_factory=dict)  # pod uid → error
    oracle_results: Optional[object] = None  # scheduler.Results of the greedy fallback

    @property
    def node_count(self) -> int:
        n = len(self.node_plans)
        if self.oracle_results is not None:
            n += len(self.oracle_results.new_node_claims)
        return n

    @property
    def total_price(self) -> float:
        # the greedy scheduler's claims carry instance-type options, not
        # a chosen offering: the price is the tensor path's plans' only
        return sum(p.price for p in self.node_plans)

    @property
    def pods_scheduled(self) -> int:
        n = sum(len(p.pod_indices) for p in self.node_plans)
        n += sum(len(p.pod_indices) for p in self.existing_plans)
        if self.oracle_results is not None:
            n += sum(len(c.pods) for c in self.oracle_results.new_node_claims)
            n += sum(len(e.pods) for e in self.oracle_results.existing_nodes)
        return n


def _exclude(pool: List[SignatureGroup], subset: List[SignatureGroup]) -> List[SignatureGroup]:
    """``pool`` minus ``subset``, by identity (dataclass __eq__ is deep)."""
    ids = {id(g) for g in subset}
    return [g for g in pool if id(g) not in ids]


def _affinity_selectors(group: SignatureGroup) -> list:
    """Selectors of every pod-affinity and anti-affinity term, required
    and preferred."""
    a = group.exemplar.spec.affinity
    if a is None:
        return []
    sels = []
    for pa in (a.pod_affinity, a.pod_anti_affinity):
        if pa is None:
            continue
        sels.extend(t.label_selector for t in pa.required if t.label_selector is not None)
        sels.extend(
            w.pod_affinity_term.label_selector
            for w in pa.preferred
            if w.pod_affinity_term.label_selector is not None
        )
    return sels


def _counts_another_group(group: SignatureGroup, groups: List[SignatureGroup]) -> bool:
    """A tensorizable anti-affinity term of ``group`` selects the labels
    of another group of the batch."""
    sels = [t.label_selector for t in group.tensor_anti_terms() or () if t.label_selector is not None]
    return bool(sels) and any(
        sel.matches(h.exemplar.metadata.labels) for h in groups if h is not group for sel in sels
    )


def route_groups(
    groups: List[SignatureGroup],
) -> Tuple[List[SignatureGroup], List[SignatureGroup], List[SignatureGroup]]:
    """The JAX package's group routing under its default (tensor)
    constraint engine (``TPUScheduler._route_groups_impl``, without the
    cross-solve route memo) → (tensor, parked, oracle groups)."""
    relational = [
        g
        for g in groups
        if g.has_relational or (g.has_stateful_node_constraints and not g.tensor_stateful)
    ]
    tensor_groups = _exclude(groups, relational)
    # pods selected by a relational pod's affinity terms must schedule
    # in the same (oracle) world, or affinity can't anchor to them
    selectors = [sel for g in relational for sel in _affinity_selectors(g)]
    pulled = [
        g
        for g in tensor_groups
        if any(sel.matches(g.exemplar.metadata.labels) for sel in selectors)
    ]
    tensor_groups = _exclude(tensor_groups, pulled)
    oracle_groups = relational + pulled
    # a tensorizable anti group whose selector matches another batch
    # group needs the oracle's interleaving (topology.go:190-219)
    cross = [g for g in tensor_groups if _counts_another_group(g, groups)]
    tensor_groups = _exclude(tensor_groups, cross)
    oracle_groups = oracle_groups + cross
    # tensorizable pod affinity resolves post-pack (parked)
    parked = [g for g in tensor_groups if g.tensor_pod_affinity() is not None]
    tensor_groups = _exclude(tensor_groups, parked)
    # groups counted by an oracle group's spread or affinity selectors,
    # and parked groups anchoring on oracle pods, join the oracle world
    # (fixpoint)
    frontier = list(oracle_groups)
    while frontier and (tensor_groups or parked):
        frontier_sels = [
            s
            for g in frontier
            for s in [
                c.label_selector
                for c in g.exemplar.spec.topology_spread_constraints
                if c.label_selector is not None
            ]
            + _affinity_selectors(g)
        ]
        frontier_labels = [g.exemplar.metadata.labels for g in frontier]
        moved = []
        if frontier_sels:
            moved += [
                g
                for g in tensor_groups + parked
                if any(s.matches(g.exemplar.metadata.labels) for s in frontier_sels)
            ]
        moved_ids = {id(m) for m in moved}
        for g in parked:
            if id(g) in moved_ids:
                continue
            if any(
                t.label_selector is not None and t.label_selector.matches(labels)
                for t in g.affinity_terms()
                for labels in frontier_labels
            ):
                moved.append(g)
        if not moved:
            break
        tensor_groups = _exclude(tensor_groups, moved)
        parked = _exclude(parked, moved)
        oracle_groups = oracle_groups + moved
        frontier = moved
    return tensor_groups, parked, oracle_groups


def _hostname_affinity_terms(pod: Pod) -> list:
    """The pod's required pod-affinity terms on hostname that carry a
    selector."""
    a = pod.spec.affinity
    if a is None or a.pod_affinity is None:
        return []
    return [
        t
        for t in a.pod_affinity.required
        if t.topology_key == wk.LABEL_HOSTNAME and t.label_selector is not None
    ]


class TorchScheduler:
    def __init__(
        self,
        nodepools: List[NodePool],
        cloud_provider: CloudProvider,
        device=None,
        kube_client=None,
        cluster=None,
        recorder=None,
        metrics=None,
        tenant=None,
    ):
        """``kube_client`` (``kube.client.KubeClient``, as the JAX
        package's ``kube_client``) is read for the bound pods that seed
        topology-spread and affinity domain counts, and for the volumes
        of the pods; with None the seeds are empty. ``cluster``
        (``state.cluster.Cluster``) and ``recorder``
        (``events.Recorder``) go to the greedy fallback; ``metrics``
        (``metrics.registry.Metrics``) takes each solve's samples.
        ``tenant``: the fleet tenant this solver serves (fleet/registry.py),
        whose scope rides every memo key the solver writes."""
        self.device = resolve_device(device)
        self.nodepools = order_by_weight(
            [np_ for np_ in nodepools if np_.metadata.deletion_timestamp is None]
        )
        self.cloud_provider = cloud_provider
        self.kube_client = kube_client
        self.cluster = cluster
        self.recorder = recorder
        self.metrics = metrics
        # device/host wall-time split of the most recent solve, and its
        # trace's id (the JAX package's last_timings["trace_id"]; the
        # port keeps last_timings numeric)
        self.last_timings: Optional[Dict[str, float]] = None
        self.last_trace_id: Optional[str] = None
        # serving double-buffer hook: called (no args) the moment the
        # authoritative encode hands off to pack; the pipeline's prewarm
        # stage encodes the next batch while this pack runs
        self.encode_done_listener: Optional[Callable[[], None]] = None
        # the device plane's block of the most recent solve (library
        # loads, transfers per boundary, footprint, the card's memory;
        # tracing/deviceplane.py), and its device time per boundary
        self.last_device_stats: Optional[dict] = None
        self.last_device_phase_ms: Dict[str, float] = {}
        # pods per route of the most recent solve (tensor, parked, oracle)
        # and the oracle's share, as the JAX package's last_route_stats
        self.last_route_stats: Optional[Dict[str, object]] = None
        # preference relaxation of the most recent solve: rounds that
        # retried a group, the pods retried and those the retries placed
        self.last_relax_stats: Optional[Dict[str, int]] = None
        self._relax_rounds = 0
        self._relax_retried: set = set()
        self.last_merge_stats: Optional[Dict[str, object]] = None
        # the pack backend's outcome in the most recent solve (which
        # backend, LP guard wins, relaxation bound sums, refinement and
        # branch counters), its relax-memo hits, and the multi-objective
        # report of its new plans (None when it emitted none)
        self.last_pack_stats: Optional[Dict[str, object]] = None
        self.last_cache_stats: Optional[dict] = None
        self.last_pareto: Optional[dict] = None
        # the shard padding of the most recent solve (solver/sharding.py),
        # None when it touched no mesh
        self.last_shard_stats: Optional[dict] = None
        self._pack_backend_stats: Dict[str, object] = {}
        self._cstats = CacheStats()
        # whether the last solve's post-pass ran a second time with the
        # reseed guard on (_affinity_postpass)
        self.last_reseed_redo = False
        self._merge_stats: Dict[str, object] = {}
        # cross-tick warm state (incremental.warm_state_for, resolved per
        # solve; None with KARPENTER_TORCH_INCREMENTAL=0)
        self._warm: Optional[incremental.WarmState] = None
        # the drained-node delta of a disruption simulation (None: a live
        # solve), carried into every memo key it could shift
        self._sim_drained: Optional[tuple] = None
        # fleet tenancy (fleet/registry.py): a non-empty scope isolates
        # every identity- or generation-scoped memo this solver touches
        # (the warm state it resolves to, the topology seed keys, the job
        # memo keys): generation counters are per object, so two tenants'
        # counters at equal values must never alias their results
        self._tenant_scope: tuple = ("tenant", str(tenant)) if tenant is not None else ()
        # the fleet's content plane (fleet/megasolve.py::SkeletonPlane):
        # installed by the batched fleet engine, it shares job skeletons
        # across tenants under the tenant-free prefix of the job key
        self.fleet_plane = None
        # the most recent snapshot/restore outcome (solver/warmstore.py),
        # and the cache traffic of the last encode_prewarm
        self.last_warmstore_stats: Optional[dict] = None
        self.last_prewarm_stats: Optional[dict] = None
        # per solve: the replay probe's context, the cluster generation
        # witnessing the seed memo, the seed exclusion key, the catalog
        # witnesses and pool fingerprints of the job keys, and the merge
        # screen's intersects memo
        self._replay_ctx: Optional[tuple] = None
        self._cluster_gen: Optional[int] = None
        self._seed_excl: Optional[tuple] = None
        self._batch_rvs: Optional[list] = None
        self._enc_keys: Dict[int, tuple] = {}
        self._pool_fp_by_name: Dict[str, tuple] = {}
        self._intersects_cache: Dict[tuple, bool] = {}
        # per-solve topology state (rebuilt in _solve and _solve_tensor;
        # empty defaults keep direct sub-method calls in tests working)
        self._batch_pods: List[Pod] = []
        self._batch_uids_cache: Optional[set] = None
        self._seed_cache: Dict[tuple, Dict[str, int]] = {}
        self._match_cache: Dict[Tuple[tuple, int], bool] = {}
        self._fold_cache: Dict[tuple, dict] = {}
        self._prep_zone_ledger: List[Tuple[int, str]] = []
        self._ledger_selectors: List[tuple] = []
        self._existing_ctx: Optional[dict] = None
        self._anti_zone_excl_cache: Dict[int, frozenset] = {}
        self._group_vols_cache: Dict[int, GroupVolumes] = {}
        self._plan_match_cache: Dict[Tuple[tuple, int], Tuple[int, bool]] = {}
        self._join_types_cache: Dict[tuple, tuple] = {}
        self._reseed_guard = False
        self._reseeded: List[NodePlan] = []
        self._phase_ms: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self._phase_inner: List[float] = [0.0]
        # per solve: the existing plans already committed onto the node
        # copies, and the copies (id of the caller's node → its copy)
        self._committed_plans: set = set()
        self._node_copies: Dict[int, object] = {}
        # catalog entries this solve has validated, by catalog identity
        self._solve_entries: Dict[tuple, _CatalogEntry] = {}

    # ------------------------------------------------------------------

    def solve(
        self,
        pods: List[Pod],
        state_nodes=None,
        daemonset_pods: Optional[List[Pod]] = None,
        sim_drained: Optional[tuple] = None,
    ) -> SolverResult:
        """One batched solve of ``pods`` against the cluster: existing
        nodes (``state_nodes``, ``StateNode``s, read and never modified:
        the relaxation retries and the greedy fallback see copies that
        carry this solve's placements) first, then new nodes, each
        carrying the overhead of the ``daemonset_pods`` it would run,
        within the NodePools' limits.

        ``sim_drained`` marks a disruption simulation and carries the
        sorted provider ids of the drained candidates: it rides the seed
        memo's keys, so a drained-node solve never aliases the undrained
        one, and a simulation never records the replay snapshot. The
        content caches (route, compat rows, job, merge, intersects) stay
        shared: they are keyed by the exact inputs of their computation."""
        t0 = time.perf_counter()
        self._phase_ms = dict.fromkeys(PHASES, 0.0)
        self._phase_inner = [0.0]  # ms of phases nested in the open one
        self.last_reseed_redo = False
        self._solve_entries = {}
        sink = self.metrics.solver_phase_duration if self.metrics is not None else None
        deviceplane.reset_solve()
        sharding.reset_shard_stats()
        with devicetime.scope(self.device) as clock, tracer.trace_root(
            "solve", metrics_sink=sink, buffer_if="solve", is_solve=True, pods=len(pods)
        ) as tr:
            try:
                return self._solve(
                    pods, list(state_nodes or ()), list(daemonset_pods or ()), sim_drained
                )
            finally:
                self._solve_entries = {}
                total_ms = (time.perf_counter() - t0) * 1000.0
                self.last_device_phase_ms = clock.phase_ms()
                device_ms = sum(self.last_device_phase_ms.values())
                self.last_timings = {
                    "total_ms": total_ms,
                    "device_ms": device_ms,
                    "host_ms": max(total_ms - device_ms, 0.0),
                    **{f"{name}_ms": ms for name, ms in self._phase_ms.items()},
                }
                self.last_trace_id = tr.trace_id if tr is not None else None
                if tr is not None:
                    # the device rollup on the trace's device lane, anchored
                    # at this solve's start (/debug/traces shows it)
                    tr.add_synthetic(
                        "device_total", time.perf_counter_ns() - int(total_ms * 1e6), int(device_ms * 1e6),
                        note="sum of the solve's CUDA event pairs (0 on the CPU)",
                    )
                self.last_merge_stats = dict(self._merge_stats)
                self.last_pack_stats = dict(self._pack_backend_stats)
                self.last_cache_stats = self._cstats.to_dict()
                if tr is not None and (self._cstats.hits or self._cstats.misses):
                    # the hit rates ride on the solve's trace
                    tr.args["cache"] = self.last_cache_stats
                # this solve's mesh padding: the stats, the trace and the
                # gauge (never silent)
                shard_stats = sharding.consume_shard_stats()
                card_ms = clock.card_ms()
                if card_ms:
                    # a mesh across cards: each card's device ms (the
                    # boundaries count their longest card's)
                    shard_stats["card_ms"] = card_ms
                self.last_shard_stats = shard_stats or None
                if shard_stats:
                    if tr is not None:
                        tr.args["shard"] = shard_stats
                    if self.metrics is not None:
                        for axis in ("pods", "types"):
                            waste = shard_stats.get(f"{axis}_waste")
                            if waste is not None:
                                self.metrics.shard_padding_waste.set(float(waste), axis=axis)
                mesh = self._mesh()
                self.last_device_stats = deviceplane.consume_solve(
                    memory=devicetime.device_memory_stats(self.device, mesh.cards if mesh is not None else None)
                )
                if tr is not None and self.last_device_stats:
                    tr.args["device"] = {k: v for k, v in self.last_device_stats.items() if k != "compile_events"}
                if self.metrics is not None:
                    self._observe_solve(total_ms / 1000.0, device_ms / 1000.0)

    def _mesh(self) -> Optional["sharding.Mesh"]:
        """The mesh this solver shards over: the active one
        (``sharding.active_mesh``) when its first placement is this
        solver's device, else None, so a solver on another card of a
        multi-card host, or on the CPU, runs the one-device path."""
        mesh = sharding.active_mesh(self.device.type)
        if mesh is None or not same_device(mesh.device, self.device):
            return None
        return mesh

    def _observe_solve(self, total_s: float, device_s: float) -> None:
        """One solve's samples: its duration and device time, and the
        cross-solve cache traffic of its ``CacheStats``."""
        m = self.metrics
        m.solver_duration.observe(total_s)
        m.solver_device_duration.observe(device_s)
        for cache, n in self._cstats.hits.items():
            m.solver_cache_hits.inc(n, cache=cache)
        for cache, n in self._cstats.misses.items():
            m.solver_cache_misses.inc(n, cache=cache)
        for cache, n in self._cstats.evictions.items():
            m.solver_cache_evictions.inc(n, cache=cache)
        ds = self.last_device_stats
        if ds:
            # library loads, transfers and the card's high-water mark:
            # never silent
            for ev in ds["compile_events"]:
                m.xla_compiles.inc(1, fn=ev["fn"], cause=ev["cause"])
            for phase, dirs in ds["transfer_by_phase"].items():
                for direction, nbytes in dirs.items():
                    m.transfer_bytes.inc(nbytes, direction=direction, phase=phase)
            hbm = ds["hbm"]
            if hbm:
                m.hbm_high_water.set(float(hbm["peak_bytes_in_use"]))

    @contextmanager
    def _phase(self, name: str):
        """Wall time of one solve phase into ``last_timings[name + "_ms"]``,
        less the phases opened inside it, and a span of the solve's trace."""
        t0 = time.perf_counter()
        self._phase_inner.append(0.0)
        try:
            with tracer.span(name):
                yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            inner = self._phase_inner.pop()
            self._phase_ms[name] += ms - inner
            self._phase_inner[-1] += ms

    @property
    def _batch_uids(self) -> set:
        """Lazy uid set of the solve batch (seed paths only)."""
        if self._batch_uids_cache is None:
            self._batch_uids_cache = {p.uid for p in self._batch_pods}
        return self._batch_uids_cache

    def _solve(
        self,
        pods: List[Pod],
        state_nodes: list,
        daemonset_pods: List[Pod],
        sim_drained: Optional[tuple] = None,
    ) -> SolverResult:
        result = SolverResult()
        self._sim_drained = tuple(sim_drained) if sim_drained is not None else None
        self._merge_stats = {
            "merge_ms": 0.0,
            "merge_records": 0,
            "merge_candidates_screened": 0,
            "merge_pairs_applied": 0,
        }
        self._pack_backend_stats = {}
        self._cstats = CacheStats()
        self.last_pareto = None
        # cross-tick state: the replay probe first — a provably unchanged
        # tick skips the pipeline; anything unprovable solves in full
        self._warm = ws = incremental.warm_state_for(self)
        self._replay_ctx = None
        # the cluster-generation witness of the seed memo, and the lazy
        # exclusion key over the batch pods the seed listing could count
        self._cluster_gen = self.cluster.generation() if self.cluster is not None else None
        self._seed_excl = None
        with self._phase("group"):
            # PV and StorageClass zone pins join volume-bearing pods' node
            # affinity before the memo read, so grouping and the compat
            # algebra see them (build_scheduler injects them once more into
            # the greedy fallback's pods, as the JAX package's does; the
            # repeated requirement intersects to itself)
            if self.kube_client is not None:
                self._inject_volume_zones(pods)
            memos, rvs = podcache.get_memos_rvs(pods)
            self._batch_rvs = rvs
            replayed = (
                self._try_replay(ws, pods, rvs, state_nodes, daemonset_pods) if ws is not None else None
            )
            if replayed is None:
                self._bind_requests(memos)
                groups = group_pods(pods, memos=memos)
                tensor_groups, parked, oracle_groups = self._route_groups(groups)
                oracle_pods = [pods[i] for g in oracle_groups for i in g.pod_indices]
                self._observe_route_split(tensor_groups, parked, oracle_pods)
        if replayed is not None:
            # the recorded tick's inputs, so its route and relax stats stand
            return replayed
        # merge-pass pairwise Requirements.intersects memo (content keyed:
        # the warm state shares one bounded map across solves)
        self._intersects_cache = ws.intersects_cache() if ws is not None else {}
        # spread-count seeding excludes the batch being scheduled
        # (topology.go:71-75) and is cached per constraint per solve; the
        # uid set materializes lazily (only seeded paths read it)
        self._batch_pods = pods
        self._batch_uids_cache = None
        self._seed_cache = {}
        # selector-content match caches: many groups carry distinct
        # selector objects with identical content
        self._match_cache = {}
        # per-selector incremental committed-placement counters (cursors
        # over the grow-only plan lists); cleared when limit enforcement
        # strips plans
        self._fold_cache = {}
        # zones each non-self zone anti-affinity group may not use, and
        # the resolved volumes, per group of this solve
        self._anti_zone_excl_cache = {}
        self._group_vols_cache = {}
        # (selector fingerprint, id(plan)) → (members seen, matched): the
        # post-pass's anchor scans rescan a plan only when it grew
        self._plan_match_cache = {}
        # admissible types of a post-pass join or reseed, per (plan
        # requirements, joiner requirements, zone, capacity type, viable)
        self._join_types_cache = {}
        self._committed_plans = set()
        self._node_copies = {}
        self._relax_rounds = 0
        self._relax_retried: set = set()
        if tensor_groups or parked:
            self._solve_tensor(pods, tensor_groups, daemonset_pods, state_nodes, result, parked)
            with self._phase("relax"):
                self._relax_and_retry(pods, tensor_groups + parked, daemonset_pods, result, state_nodes)
        self.last_relax_stats = {
            "rounds": self._relax_rounds,
            "pods_retried": len(self._relax_retried),
            "pods_placed": sum(1 for i in self._relax_retried if pods[i].uid not in result.pod_errors),
        }
        if oracle_pods:
            with self._phase("oracle"):
                # the greedy scheduler must see capacity net of the tensor
                # path's placements: commit them onto the node copies
                self._commit_existing_plans(pods, result, state_nodes)
                self._solve_oracle(
                    oracle_pods, self._copies(state_nodes), daemonset_pods, result
                )
        if ws is not None and self._sim_drained is None:
            # simulations never record: the provisioner's replayable tick
            # must survive a disruption probe in between
            ws.record(self, pods, state_nodes, daemonset_pods, result, self._replay_ctx)
        if result.node_plans:
            # reporting only: computed after the plans are final
            self.last_pareto = plancost.pareto_report(result.node_plans)
        return result

    def _bind_requests(self, memos) -> None:
        """The batch's request views from its pod memos: per pod, its
        request dict and interned id, and this batch's id → request map
        (immune to intern-table resets)."""
        self._all_requests = [m.requests for m in memos]
        self._req_ids = np.fromiter((m.req_id for m in memos), dtype=np.int64, count=len(memos))
        self._req_map = {m.req_id: m.requests for m in memos}

    def _observe_route_split(self, tensor_groups, parked, oracle_pods) -> None:
        """Pods per route into ``last_route_stats`` and the
        ``solver_route_pods`` counter."""
        counts = {
            "tensor": sum(len(g.pod_indices) for g in tensor_groups),
            "parked": sum(len(g.pod_indices) for g in parked),
            "oracle": len(oracle_pods),
        }
        total = sum(counts.values())
        self.last_route_stats = {
            **counts,
            "oracle_share": round(counts["oracle"] / total, 4) if total else 0.0,
        }
        if self.metrics is not None:
            for route, n in counts.items():
                if n:
                    self.metrics.solver_route_pods.inc(n, route=route)

    def _seed_exclusion_key(self) -> tuple:
        """Sorted uids of the batch pods the seed listing could count
        (pods with a live binding in the cluster state): the only part of
        the batch exclusion that moves seed results."""
        if self._seed_excl is None:
            if self.cluster is None:
                self._seed_excl = ()
            else:
                bindings = self.cluster.bindings
                self._seed_excl = tuple(
                    sorted(p.uid for p in self._batch_pods if (p.namespace, p.name) in bindings)
                )
        return self._seed_excl

    def _try_replay(self, ws, pods, rvs, state_nodes, daemonset_pods):
        """Whole-solve replay probe: compute this tick's invalidation
        context (pool fingerprints, catalog generations or fingerprints),
        keep it for the end-of-solve record, and replay the previous
        result when every input matches. External state the keys cannot
        witness (state nodes, a kube client, a cluster) → no replay.

        Beside the pools' fingerprints the context carries the pack
        configuration (the engine token and the active backend's job
        token, as every job key does): a switch of
        ``KARPENTER_TORCH_NATIVE`` or ``KARPENTER_TORCH_PACK_BACKEND``
        between two ticks of unchanged pods packs again. The JAX
        package's probe leaves them out (ROADMAP queue C)."""
        if state_nodes or self.kube_client is not None or self.cluster is not None:
            return None
        with tracer.span("solve.replay_probe"):
            pools_fp: List[tuple] = [
                (
                    "pack",
                    incremental.pack_engine_token(self._mesh()),
                    backends.active_backend().job_token(self.device),
                )
            ]
            catalogs: List[list] = []
            keys: List[tuple] = []
            for np_ in self.nodepools:
                try:
                    its = self.cloud_provider.get_instance_types(np_) or []
                except Exception:  # noqa: BLE001 — the probe must never fail the solve
                    return None
                pools_fp.append(incremental.pool_replay_fingerprint(np_))
                catalogs.append(its)
                keys.append(incremental.catalog_key(self.cloud_provider, np_, its))
            ctx = (
                tuple(pools_fp),
                tuple(tuple(map(id, c)) for c in catalogs),
                catalogs,
                tuple(keys),
            )
            self._replay_ctx = ctx
            return ws.try_replay(self, pods, rvs, state_nodes, daemonset_pods, ctx, self._cstats)

    def _route_groups(
        self, groups: List[SignatureGroup]
    ) -> Tuple[List[SignatureGroup], List[SignatureGroup], List[SignatureGroup]]:
        """``route_groups`` through the route memo: the split is a pure
        function of the batch's ordered interned signatures, so it is
        memoized on that tuple. The JAX package's key also carries its
        constraint-engine switch; the port has the one (tensor) engine,
        so that component is fixed."""
        ws = self._warm
        key = incremental.route_key(groups) if ws is not None else None
        if key is not None:
            key = key + (("ce", "tensor"),)
            cached = ws.routes.get(key, self._cstats)
            if cached is not None:
                t_idx, p_idx, o_idx = cached
                return (
                    [groups[i] for i in t_idx],
                    [groups[i] for i in p_idx],
                    [groups[i] for i in o_idx],
                )
        tensor_groups, parked, oracle_groups = route_groups(groups)
        if key is not None:
            pos = {id(g): i for i, g in enumerate(groups)}
            # analysis: allow-config-provenance(constraint_engine — the port has one constraint engine, the tensor one; the key carries its name)
            ws.routes.put(
                key,
                (
                    tuple(pos[id(g)] for g in tensor_groups),
                    tuple(pos[id(g)] for g in parked),
                    tuple(pos[id(g)] for g in oracle_groups),
                ),
            )
        return tensor_groups, parked, oracle_groups

    def _copies(self, state_nodes: list) -> list:
        """This solve's copies of ``state_nodes``, made on first use."""
        for n in state_nodes:
            if id(n) not in self._node_copies:
                self._node_copies[id(n)] = n.deep_copy()
        return [self._node_copies[id(n)] for n in state_nodes]

    def _commit_existing_plans(self, pods: List[Pod], result: SolverResult, state_nodes: list) -> None:
        """Reflect the placements on existing nodes in this solve's node
        copies (once per plan), so later passes (relaxation retries, the
        greedy scheduler) see capacity net of what is already promised.
        The JAX package commits onto the caller's nodes."""
        copies = self._copies(state_nodes)
        by_id = {id(n): c for n, c in zip(state_nodes, copies)}
        for plan in result.existing_plans:
            if id(plan) in self._committed_plans:
                continue
            self._committed_plans.add(id(plan))
            node_copy = by_id[id(plan.state_node)]
            for i in plan.pod_indices:
                node_copy.update_for_pod(pods[i])

    def _relax_and_retry(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        daemonset_pods: List[Pod],
        result: SolverResult,
        state_nodes: list,
    ) -> None:
        """Preference relaxation fixpoint for the tensor path
        (preferences.go:38-60 ladder, scheduler.go:163-169 re-queue):
        each round strips ONE soft constraint from every failed group's
        exemplar (the whole group shares the signature) and re-enters the
        pipeline with just the failed pods; stops when nothing relaxes.

        As in the JAX package, retried pods see the existing nodes net of
        the committed placements, and this solve's new-node plans only
        through the back-fill, so a relaxed group can open a node where
        the greedy scheduler would back-fill an in-flight claim."""
        if not result.pod_errors:
            return  # nothing failed: no group can need relaxation
        prefs = Preferences(
            any(
                t.effect == EFFECT_PREFER_NO_SCHEDULE
                for np_ in self.nodepools
                for t in np_.spec.template.taints
            )
        )
        for _ in range(10):  # ladder depth bound (terms strip one per round)
            retry: List[SignatureGroup] = []
            for g in groups:
                failed = [i for i in g.pod_indices if pods[i].uid in result.pod_errors]
                if not failed:
                    continue
                # relax a COPY: the exemplar is the caller's live Pod, and
                # a persisted relaxation would survive into later solves
                exemplar = copy.deepcopy(g.exemplar)
                if not prefs.relax(exemplar):
                    continue
                retry.append(SignatureGroup(signature=g.signature, exemplar=exemplar, pod_indices=failed))
            if not retry:
                return
            self._relax_rounds += 1
            for g in retry:
                for i in g.pod_indices:
                    self._relax_retried.add(i)
                    result.pod_errors.pop(pods[i].uid, None)
            # capacity promised to earlier placements must be visible
            # before the retry packs onto existing nodes again
            self._commit_existing_plans(pods, result, state_nodes)
            # in-flight claims first: a relaxed pod back-fills a node plan
            # already emitted this solve before opening a new one
            # (scheduler.go:163-169 re-queues through existing claims)
            retry = self._backfill_node_plans(pods, retry, daemonset_pods, result)
            if not retry:
                return
            parked_retry = [g for g in retry if g.tensor_pod_affinity() is not None]
            regular_retry = [g for g in retry if g.tensor_pod_affinity() is None]
            copies = self._copies(state_nodes)
            originals = {id(c): n for n, c in zip(state_nodes, copies)}
            first_new = len(result.existing_plans)
            self._solve_tensor(pods, regular_retry, daemonset_pods, copies, result, parked_retry)
            # the retry packed onto the copies; its plans name the
            # caller's nodes, as every other existing plan does
            for plan in result.existing_plans[first_new:]:
                plan.state_node = originals[id(plan.state_node)]
            groups = retry

    _BACKFILL_SCAN_CAP = 256  # plans examined per retry group

    def _backfill_node_plans(
        self,
        pods: List[Pod],
        retry: List[SignatureGroup],
        daemonset_pods: List[Pod],
        result: SolverResult,
    ) -> List[SignatureGroup]:
        """Place relaxed-retry pods onto NodePlans already emitted this
        solve when the plan's node would admit them and its pinned
        instance type still has room: the greedy scheduler's re-queued
        pods see earlier in-flight claims (scheduler.go:163-169,241-246);
        without this, a relaxed pod opens a node the greedy scheduler
        would back-fill. Returns the groups still needing a full retry
        pass."""
        if not result.node_plans:
            return retry
        # each plan's summed pod requests, kept up to date as pods join
        # (the same sums as merging its pod list for every probe)
        plan_load: Dict[int, dict] = {}
        pools_by_name = {np_.name: np_ for np_ in self.nodepools}
        # per-pool daemon overhead once, not per (pod × plan)
        daemon_by_pool = {
            name: self._daemon_overhead_for(np_, daemonset_pods) for name, np_ in pools_by_name.items()
        }
        remaining: List[SignatureGroup] = []
        for g in retry:
            if (
                g.zone_spread() is not None
                or g.hostname_spread() is not None
                or g.hostname_isolated
                or g.tensor_pod_affinity() is not None
                or g.zone_anti_isolated
                or g.anti_exclusion_terms()
                or g.has_stateful_node_constraints
            ):
                # topology/affinity/stateful-constrained pods must go
                # through their seeded domain-assignment / masked pack
                # paths; a plain back-fill append ignores domain counts,
                # per-node caps, and port/volume conflict state
                remaining.append(g)
                continue
            pod_reqs = pod_requirements(g.exemplar)
            # the group's pods share their exemplar: taints per pool and
            # requirement compatibility per plan are decided once (a plan's
            # requirements change here only by merging the group's own,
            # which leaves their compatibility as it was)
            intolerant = {
                name: Taints(np_.spec.template.taints).tolerates(g.exemplar) is not None
                for name, np_ in pools_by_name.items()
            }
            compatible: Dict[int, bool] = {}
            unplaced: List[int] = []
            for i in g.pod_indices:
                placed = False
                for plan in result.node_plans[: self._BACKFILL_SCAN_CAP]:
                    np_ = pools_by_name.get(plan.nodepool_name)
                    if np_ is None or plan.requirements is None:
                        continue
                    if plan.max_pods_per_node < MAX_INT32 or plan.node_limits:
                        # capped/limited plans (hostname spread / anti-
                        # affinity groups) never take foreign pods: the
                        # constraint the cap models may be violated
                        continue
                    if intolerant[plan.nodepool_name]:
                        continue
                    if id(plan) not in compatible:
                        # the launched node carries the plan's merged labels
                        # plus its pinned type/zone/capacity-type
                        node_reqs = Requirements(*plan.requirements.values_list())
                        node_reqs.add(*plan.instance_type.requirements.values_list())
                        node_reqs.add(
                            Requirement(wk.LABEL_TOPOLOGY_ZONE, OP_IN, [plan.zone]),
                            Requirement(wk.CAPACITY_TYPE_LABEL_KEY, OP_IN, [plan.capacity_type]),
                        )
                        err = node_reqs.compatible(pod_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS, hint=False)
                        compatible[id(plan)] = not err
                    if not compatible[id(plan)]:
                        continue
                    base = plan_load.get(id(plan))
                    if base is None:
                        base = plan_load[id(plan)] = resources.merge(*(plan._pod_requests or ()))
                    load = resources.merge(base, self._all_requests[i], daemon_by_pool[plan.nodepool_name])
                    if not resources.fits(load, plan.instance_type.allocatable()):
                        continue
                    plan.pod_indices.append(i)
                    if plan._pod_requests is not None:
                        plan._pod_requests.append(self._all_requests[i])
                        plan_load[id(plan)] = resources.merge(base, self._all_requests[i])
                    plan._requests = None  # recompute lazily
                    merged = Requirements(*plan.requirements.values_list())
                    merged.add(*pod_reqs.values_list())
                    plan.requirements = merged
                    placed = True
                    break
                if not placed:
                    unplaced.append(i)
            if unplaced:
                remaining.append(
                    SignatureGroup(signature=g.signature, exemplar=g.exemplar, pod_indices=unplaced)
                )
        return remaining

    def _daemon_overhead_for(self, nodepool: NodePool, daemonset_pods: List[Pod]) -> dict:
        """Daemonset request total for a pool's nodes (the per-pool
        computation of the encode phase)."""
        if not daemonset_pods:
            return {}
        template_reqs = node_selector_requirements(nodepool.spec.template.requirements)
        template_reqs.add(
            *label_requirements(
                {**nodepool.spec.template.metadata.labels, wk.NODEPOOL_LABEL_KEY: nodepool.name}
            ).values_list()
        )
        taints = Taints(nodepool.spec.template.taints)
        daemons = [
            p
            for p in daemonset_pods
            if taints.tolerates(p) is None
            and template_reqs.compatible(pod_requirements(p), frozenset(wk.WELL_KNOWN_LABELS), hint=False)
            is None
        ]
        return resources.requests_for_pods(*daemons) if daemons else {}

    def _solve_oracle(self, pods: List[Pod], state_nodes: list, daemonset_pods: List[Pod], result: SolverResult) -> None:
        """The greedy scheduler for the routed-off ``pods``; its filter
        reads this scheduler's catalog entries."""
        scheduler = build_scheduler(
            self.kube_client,
            self.cluster,
            self.nodepools,
            self.cloud_provider,
            pods,
            state_nodes=state_nodes,
            daemonset_pods=daemonset_pods,
            recorder=self.recorder,
            catalog_entry=self._catalog_entry,
        )
        res = scheduler.solve(pods)
        result.oracle_results = res
        for uid, err in res.pod_errors.items():
            result.pod_errors[uid] = err

    # ------------------------------------------------------------------

    def _catalog_entry(
        self, catalog: List[InstanceType], generation: Optional[int] = None, count: bool = False
    ) -> _CatalogEntry:
        """``catalog``'s entry of the process-wide cache. A solve's later
        passes (relaxation retries, the greedy fallback's filter) reuse
        the entry its first pass validated: nothing in a solve changes a
        catalog. ``count``: the lookup is the encode phase's, counted in
        the solve's ``catalog`` hits and misses as the JAX package counts
        its encode lookups."""
        key = tuple(map(id, catalog))
        entry = self._solve_entries.get(key)
        if entry is None:
            entry = _catalog_entry(catalog, generation, self._cstats if count else None, self.cloud_provider)
            self._solve_entries[key] = entry
        elif count:
            self._cstats.hit("catalog")
        return entry

    def _device_catalog(self, entry: _CatalogEntry) -> DeviceCatalog:
        """The kernel's packed type side for ``entry``, resident on this
        solver's device; uploaded again when the vocab grew or the entry
        last served a solver on another device."""
        enc = entry.enc
        keys = tuple(sorted(enc.key_masks.keys()))
        snapshot = (tuple((k, entry.vocab.key_vocab(k).size) for k in keys), str(self.device))
        if entry.device_catalog is not None and entry.device_catalog[0] == snapshot:
            return entry.device_catalog[1]
        with devicetime.track(phase="compat"):  # the catalog upload is device work
            catalog = catalog_to_device(
                enc.key_masks, enc.key_has, enc.key_neg, keys, enc.offering_avail, self.device
            )
        if self.device.type == "cuda":
            devicetime.transfer("h2d", catalog.planes, catalog.key_off, phase="compat")
        entry.device_catalog = (snapshot, catalog)
        return catalog

    def _build_pools(self) -> Tuple[List[PoolEncoding], List[List[InstanceType]]]:
        """Per-pool template encoding + catalog fetch."""
        pools: List[PoolEncoding] = []
        pool_catalogs: List[List[InstanceType]] = []
        for np_ in self.nodepools:
            try:
                its = self.cloud_provider.get_instance_types(np_)
            except Exception as e:  # noqa: BLE001 — one bad pool must not stop the solve
                log.debug("skipping nodepool %s: instance-type fetch failed: %s", np_.name, e)
                continue
            if not its:
                continue
            template_reqs = node_selector_requirements(np_.spec.template.requirements)
            template_reqs.add(
                *label_requirements(
                    {**np_.spec.template.metadata.labels, wk.NODEPOOL_LABEL_KEY: np_.name}
                ).values_list()
            )
            pools.append(PoolEncoding(np_, template_reqs, Taints(np_.spec.template.taints)))
            pool_catalogs.append(its)
        return pools, pool_catalogs

    # -- warming the shared caches off the solve path ----------------------

    def encode_prewarm(self, pods: List[Pod], daemonset_pods: Optional[List[Pod]] = None) -> dict:
        """Run the host encode of a batch not yet scheduled (pod memos,
        signature grouping, the route split, the catalog encodings and the
        compat rows of its signatures, the compat kernel on this solver's
        device for the rows it lacks), then discard the outputs. It only
        warms content-addressed caches (pod interning, the catalog entries
        and their rows under _CATALOG_LOCK, the route memo), so running it
        beside a solve changes timings, never plans; it reads no cluster
        state and emits nothing. Call it on a scheduler of its own (its
        per-solve scratch is not shared with a live solve). → the
        prewarm's cache traffic."""
        t0 = time.perf_counter()
        self._cstats = CacheStats()
        self._warm = ws = incremental.warm_state_for(self)
        self._solve_entries = {}
        with tracer.trace_root("encode_prewarm", buffer_if="never", pods=len(pods)):
            memos, _rvs = podcache.get_memos_rvs(pods)
            self._bind_requests(memos)
            self._batch_pods = pods
            self._batch_uids_cache = None
            self._intersects_cache = ws.intersects_cache() if ws is not None else {}
            groups = group_pods(pods, memos=memos)
            tensor_groups, parked, _oracle_groups = self._route_groups(groups)
            encode_groups = list(tensor_groups) + list(parked)
            pools, pool_catalogs = self._build_pools()
            if encode_groups and pools:
                with tracer.span("encode"):
                    self._encode_phase(encode_groups, pools, pool_catalogs, list(daemonset_pods or ()))
        self._solve_entries = {}
        stats = self._cstats.to_dict()
        stats["groups"] = len(groups)
        stats["prewarm_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        self.last_prewarm_stats = stats
        return stats

    def prewarm_catalog(self) -> dict:
        """Re-encode each pool's catalog entry off the solve path after a
        catalog or price change (the shared cache under _CATALOG_LOCK, the
        same key and guard), so the next solve finds it warm. → the
        prewarm's cache traffic."""
        t0 = time.perf_counter()
        self._cstats = CacheStats()
        cg = getattr(self.cloud_provider, "catalog_generation", None)
        with tracer.trace_root("prewarm_catalog", buffer_if="never"):
            pools, pool_catalogs = self._build_pools()
            # generation probes take the provider's own lock: before
            # _CATALOG_LOCK, so the catalog lock never nests it
            gens = [cg(p.nodepool) if callable(cg) else None for p in pools]
            with _CATALOG_LOCK:
                with tracer.span("encode.catalog"):
                    for gen, cat in zip(gens, pool_catalogs):
                        _catalog_entry(cat, generation=gen, stats=self._cstats, owner=self.cloud_provider)
        stats = self._cstats.to_dict()
        stats["pools"] = len(pools)
        stats["prewarm_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        return stats

    # -- warm-state persistence (solver/warmstore.py) ---------------------

    def snapshot(self, directory: Optional[str] = None) -> Optional[str]:
        """Serialize this solver's cross-solve planes (catalog entries and
        their compat rows, route, job, merge, emit and screen-row memos,
        seeds, intersects, this device's ``lprelax`` plane) to a versioned
        snapshot file → its path, or None when persistence is off or
        failed (never raises)."""
        from . import warmstore

        return warmstore.snapshot(self, directory=directory)

    def restore(self, path: str) -> dict:
        """Restore a snapshot into this solver's warm state, every plane
        re-anchored to the live world (catalog fingerprints, the cluster
        witness, re-interned signatures); what fails its witness is
        dropped and counted. → the outcome, also ``last_warmstore_stats``."""
        from . import warmstore

        return warmstore.restore(self, path, metrics=self.metrics, fleet_plane=self.fleet_plane)

    def _solve_tensor(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        daemonset_pods: List[Pod],
        state_nodes: list,
        result: SolverResult,
        parked_groups: List[SignatureGroup] = (),
    ) -> None:
        # prep-time (pod index, zone) ledger of zone-pinned assignments:
        # later counting groups fold these, so mutually counting groups
        # see a serially consistent order (each counts everything
        # assigned before it, like the oracle's Record stream). Only pods
        # a cross-counting selector can see are ledgered: a spread
        # selector matching only its own group is fully accounted by that
        # group's water-fill.
        self._prep_zone_ledger = []
        self._ledger_selectors = []
        for g in groups:
            zc = g.zone_spread()
            if zc is None:
                continue
            sel = zc.label_selector
            if sel is None or any(
                h is not g
                and h.exemplar.namespace == g.exemplar.namespace
                and sel.matches(h.exemplar.metadata.labels)
                for h in groups
            ):
                self._ledger_selectors.append((sel, g.exemplar.namespace))
        # parked (pod-affinity) groups join the catalog and compat encode
        # but skip the pack rounds: they resolve after them, one by one
        parked_from = len(groups)
        groups = list(groups) + list(parked_groups)
        # existing capacity first (scheduler.go:241-246): per-group
        # indices still needing placement after the existing-node pack
        self._existing_ctx = None
        leftover: Dict[int, List[int]] = {
            gi: list(groups[gi].pod_indices) for gi in range(parked_from)
        }
        if state_nodes:
            with self._phase("existing"):
                self._pack_existing(
                    pods, groups[:parked_from], daemonset_pods, state_nodes, leftover, result
                )
            if not any(leftover.values()) and not parked_groups:
                return
        pools, pool_catalogs = self._build_pools()
        if not pools:
            for gi in range(parked_from):
                for i in leftover[gi]:
                    result.pod_errors[pods[i].uid] = "no nodepool found"
            for g in groups[parked_from:]:
                for i in g.pod_indices:
                    result.pod_errors[pods[i].uid] = "no nodepool found"
            return
        with self._phase("encode"):
            ctx = self._encode_phase(groups, pools, pool_catalogs, daemonset_pods)
        listener = self.encode_done_listener
        if listener is not None:
            try:
                listener()
            except Exception:  # noqa: BLE001 — a listener bug must not fail the solve
                log.debug("encode_done_listener failed", exc_info=True)
        self._pack_phase(pods, groups, parked_from, pools, leftover, state_nodes, result, ctx)

    def _pack_existing(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        daemonset_pods: List[Pod],
        state_nodes: list,
        leftover: Dict[int, List[int]],
        result: SolverResult,
    ) -> None:
        """Pack signature groups onto existing capacity before opening
        any new node (scheduler.go:241-246; existingnode.go:64-120
        semantics: taints → node-label/requirement compat → resource
        fits). Nodes become an (M, R) free-capacity matrix (available
        minus remaining daemon overhead) in the oracle's try-order
        (initialized first, then name); admissibility comes from
        existing_node_compat; the pack itself is the native first-fit,
        over every pod of the packed groups in the oracle's pod order.

        Zone-spread and hostname-capped groups are not packed here: they
        get zones or per-node quotas first (_prepare_class_jobs) and
        then try existing nodes against the free capacity this stashes
        in ``self._existing_ctx`` (nodes, free, axis, node_zones,
        compat_rows), which every later existing-node pack updates.
        Host-port and volume groups pack after the global first-fit, one
        group at a time (_pack_stateful_existing): their per-node
        conflict state is live across placements."""
        nodes = sorted(state_nodes, key=lambda n: (not n.initialized(), n.name()))
        M = len(nodes)
        # axis spans the nodes' allocatable and every request of the batch
        # (zone-pinned spread packs quantize against it later)
        axis = extend_axis(
            build_axis_from_capacities([n.allocatable() for n in nodes]),
            unique_requests(self._req_ids, self._req_map),
        )
        node_labels = [n.labels() for n in nodes]
        # free capacity: available minus REMAINING daemon overhead
        # (expected daemons that fit the node, less those already present,
        # floored at zero — existingnode.go:43-52)
        free = np.zeros((M, axis.count), dtype=np.int32)
        for m, node in enumerate(nodes):
            taints = Taints(node.taints())
            label_reqs = label_requirements(node_labels[m])
            daemons = [
                p
                for p in daemonset_pods
                if taints.tolerates(p) is None
                and label_reqs.compatible(pod_requirements(p), hint=False) is None
            ]
            expected = resources.requests_for_pods(*daemons) if daemons else {}
            remaining_daemon = {
                k: v
                for k, v in resources.subtract(expected, node.daemonset_request_total()).items()
                if v > 0
            }
            avail = resources.subtract(node.available(), remaining_daemon)
            # an overcommitted node (any negative axis) rejects every pod
            # in the oracle (resources.fits: 0 ≤ negative is false) — a
            # zero row reproduces that, since every pod requests pods≥1
            if not any(v < 0 for v in avail.values()):
                free[m] = quantize_capacity(avail, axis)
        self._existing_ctx = dict(
            nodes=nodes,
            free=free,
            axis=axis,
            node_zones=np.array([lbls.get(wk.LABEL_TOPOLOGY_ZONE, "") for lbls in node_labels]),
            compat_rows={},
        )
        # topology-constrained groups (zone spread, zone self-anti-
        # affinity, hostname caps) are domain-assigned before they touch
        # existing capacity: keep them out of this selector-blind
        # first-fit
        free_groups = [
            (gi, g)
            for gi, g in enumerate(groups)
            if g.zone_spread() is None
            and g.tensor_pod_affinity() is None
            and not g.zone_anti_isolated
            and g.hostname_spread() is None
            and not g.hostname_isolated
        ]
        pack = [(gi, g) for gi, g in free_groups if not g.has_stateful_node_constraints]
        stateful = [(gi, g) for gi, g in free_groups if g.has_stateful_node_constraints]
        if pack:
            self._pack_existing_global(pack, nodes, axis, free, leftover, result)
        if stateful:
            self._pack_stateful_existing(stateful, leftover, result)

    def _pack_existing_global(
        self,
        pack: List[tuple],
        nodes: list,
        axis: ResourceAxis,
        free: np.ndarray,
        leftover: Dict[int, List[int]],
        result: SolverResult,
    ) -> None:
        """One first-fit of every pod of the ``(gi, group)`` pairs in
        ``pack`` onto the existing nodes, in the oracle's pod order."""
        sub_groups = [g for _, g in pack]
        # nodes a non-self anti-affinity term excludes (zones or hosts
        # holding a selector-matching pod) fold in per group
        compat = existing_node_compat(sub_groups, nodes)
        for s, g in enumerate(sub_groups):
            excl = self._anti_exclusion_row(g, self._existing_ctx)
            if excl is not None:
                compat[s] &= ~excl
        if not compat.any():
            return
        # global pack in the oracle's pod order: all pods descending by
        # (primary, memory) — queue.go:76
        pod_idx = np.array([i for g in sub_groups for i in g.pod_indices], dtype=np.int64)
        sig_ids = np.array(
            [s for s, g in enumerate(sub_groups) for _ in g.pod_indices], dtype=np.int32
        )
        reqs = build_requests_matrix_ids(self._req_ids[pod_idx], axis, self._req_map)
        order = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
        pod_idx, sig_ids, reqs = pod_idx[order], sig_ids[order], reqs[order]
        assign, free_out = run_pack_existing(reqs, sig_ids, compat, free, device=self.device)
        self._existing_ctx["free"] = np.ascontiguousarray(free_out, dtype=np.int32)

        by_node: Dict[int, List[int]] = {}
        for j in np.flatnonzero(assign >= 0):
            by_node.setdefault(int(assign[j]), []).append(int(pod_idx[j]))
        if not by_node:
            return
        assigned = {i for members in by_node.values() for i in members}
        for gi, g in pack:
            leftover[gi] = [i for i in g.pod_indices if i not in assigned]
        for m in sorted(by_node):
            result.existing_plans.append(
                ExistingNodePlan(state_node=nodes[m], pod_indices=by_node[m])
            )

    def _pack_stateful_existing(
        self,
        stateful: List[tuple],
        leftover: Dict[int, List[int]],
        result: SolverResult,
    ) -> None:
        """Pack host-port and volume groups onto existing capacity, one
        group at a time in the reference's order, with their per-node
        conflict state enforced in the first-fit:

        - host ports ride as pseudo-resource columns appended to the
          free matrix (``constraint_tensors.PortFeatures``, the exact
          additive encoding of HostPort.matches), so conflicts with the
          nodes' reservations and between this group's own placements
          both hold in the C++ first-fit;
        - volume admissibility is a per-(group, node) mask over the
          union check (a group's shared claims charge a node once), and
          generic-ephemeral PVCs are additive per-driver columns; the
          groups run against a live port-reservation list and a live
          volume overlay, so the order of the groups decides which one
          takes a node's last attach slot, as in the reference."""
        ctx = self._existing_ctx
        nodes = ctx["nodes"]
        # live port reservations: each node's own plus this pass's
        reserved = [list(node_reserved_ports(n)) for n in nodes]
        # live volume overlay: driver → pvc ids this pass added, per node
        vol_overlay: Dict[int, Volumes] = {}
        for gi, g in stateful:
            idx = np.asarray(leftover.get(gi, list(g.pod_indices)), dtype=np.int64)
            if idx.size == 0:
                continue
            row = self._existing_compat_row(g, ctx).astype(bool)
            gv = self._group_volumes(g) if g.has_volumes else None
            if gv is not None:
                for m in np.flatnonzero(row):
                    vu = nodes[m].volume_usage
                    over = vol_overlay.get(int(m))
                    mounted = vu.volumes.union(over) if over else vu.volumes
                    if not volume_admit_row(gv, mounted, vu.csi_limits):
                        row[m] = False
            if not row.any():
                continue
            reqs = build_requests_matrix_ids(self._req_ids[idx], ctx["axis"], self._req_map)
            order = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
            idx, reqs = idx[order], reqs[order]
            ports = g.host_ports()
            eph_drivers = sorted(gv.eph_counts) if gv is not None else []
            free = ctx["free"]
            cols, req_cols = [free], [reqs]
            if ports:
                feats = PortFeatures([ports])
                cols.append(feats.free_matrix(reserved))
                req_cols.append(np.tile(feats.load_row(ports), (len(idx), 1)))
            if eph_drivers:
                cols.append(eph_free_columns(eph_drivers, nodes, vol_overlay))
                load_v = np.array([gv.eph_counts[d] for d in eph_drivers], dtype=np.int32)
                req_cols.append(np.tile(load_v, (len(idx), 1)))
            free_ext = np.ascontiguousarray(np.hstack(cols), dtype=np.int32)
            reqs_ext = np.ascontiguousarray(np.hstack(req_cols), dtype=np.int32)
            assign, free_out = run_pack_existing(
                reqs_ext, np.zeros(len(idx), dtype=np.int32), row[None, :].astype(np.uint8), free_ext,
                device=self.device,
            )
            # the shared state keeps the resource columns only
            ctx["free"] = np.ascontiguousarray(free_out[:, : free.shape[1]], dtype=np.int32)
            placed = assign >= 0
            by_node: Dict[int, List[int]] = {}
            for j in np.flatnonzero(placed):
                by_node.setdefault(int(assign[j]), []).append(int(idx[j]))
            for m in sorted(by_node):
                members = by_node[m]
                if ports:
                    reserved[m].extend(ports_from_triples(ports) * len(members))
                if gv is not None and not gv.empty:
                    over = vol_overlay.setdefault(m, Volumes())
                    for driver, ids in gv.shared.items():
                        for pid in ids:
                            over.add(driver, pid)
                    for driver, n_per_pod in gv.eph_counts.items():
                        for i in members:
                            pod = self._batch_pods[i]
                            for e in range(n_per_pod):
                                over.add(driver, f"{pod.namespace}/{pod.name}-eph{e}")
                result.existing_plans.append(ExistingNodePlan(state_node=nodes[m], pod_indices=members))
            leftover[gi] = [int(i) for i in idx[~placed]]

    def _encode_phase(
        self,
        groups: List[SignatureGroup],
        pools: List[PoolEncoding],
        pool_catalogs: List[List[InstanceType]],
        daemonset_pods: List[Pod],
    ) -> dict:
        """Catalog/signature tensorization, ONE kernel launch per pool over
        the signatures the compat-row memo does not hold, per-pod encoding
        and daemonset overhead while the card works, then one sync."""
        ws = self._warm
        device = str(self.device)
        # a mesh (solver/sharding.py: D shards over placements, this
        # solver's device the first) takes the compat launches onto its
        # padded catalog and the packs onto its shards; None on one card,
        # where nothing here changes
        mesh = self._mesh()
        cg = getattr(self.cloud_provider, "catalog_generation", None)
        # provider generation probes take the provider's own lock: taken
        # before _CATALOG_LOCK, so the catalog lock never nests it
        gens = [cg(p.nodepool) if callable(cg) else None for p in pools]
        if self.device.type == "cuda":
            # the compat kernel's library is loaded (built first, where the
            # checkout has none) before _CATALOG_LOCK: a first load under it
            # would hold every other solver's encode behind one nvcc
            COMPAT_ALLOWED.lib()
        # the lock covers every in-place mutation of the shared entries
        # (vocab interning, mask extension, the device-side upload, rows)
        with _CATALOG_LOCK:
            pool_entries = [
                self._catalog_entry(cat, gen, count=True) for gen, cat in zip(gens, pool_catalogs)
            ]
            # the job memo's catalog witness: the entry's id is stable while
            # the cache holds it, and the fingerprint guards a recycled id
            self._enc_keys = {id(e.enc): (id(e), e.fingerprint) for e in pool_entries}
            pool_fps = [incremental.pool_fingerprint(p) for p in pools]
            self._pool_fp_by_name = {p.nodepool.name: fp for p, fp in zip(pools, pool_fps)}
            # per pool: the signatures whose rows this device already holds,
            # and the missing ones, which alone go through encode and kernel
            cached_rows: List[list] = []
            missing_per_pool: List[List[int]] = []
            with tracer.span("encode.cache_lookup"):
                for pf, e in zip(pool_fps, pool_entries):
                    rows: list = [None] * len(groups)
                    missing: List[int] = []
                    if ws is None:
                        missing = list(range(len(groups)))
                    else:
                        sr = e.sig_rows
                        hits = 0
                        for gi, g in enumerate(groups):
                            sid = g.sig_id
                            row = sr.get((pf, sid, device)) if sid is not None else None
                            if row is None:
                                missing.append(gi)
                            else:
                                sr.move_to_end((pf, sid, device))
                                rows[gi] = row
                                hits += 1
                        if hits:
                            self._cstats.hit("compat", hits)
                        if missing:
                            self._cstats.miss("compat", len(missing))
                    cached_rows.append(rows)
                    missing_per_pool.append(missing)
            sig_compats: List[List] = []
            for pool, e, rows, missing in zip(pools, pool_entries, cached_rows, missing_per_pool):
                miss_set = set(missing)
                sig_compats.append([
                    encode_signature_for_pool(groups[gi], pool, e.vocab) if gi in miss_set else rows[gi].compat
                    for gi in range(len(groups))
                ])
            # only entries with missing rows interned new values: their masks
            # are extended and the missing signatures' masks finalized
            dirty = {id(e): e for e, miss in zip(pool_entries, missing_per_pool) if miss}
            for e in dirty.values():
                extend_encoded_masks(e.enc, e.vocab)
            for compats, e, missing in zip(sig_compats, pool_entries, missing_per_pool):
                if missing:
                    finalize_signature_masks([compats[gi] for gi in missing], e.vocab)
            encoded = [e.enc for e in pool_entries]

            # every pool's launch is enqueued before the first sync; a pool
            # whose rows are all cached launches nothing
            pending = []
            for e, compats, missing in zip(pool_entries, sig_compats, missing_per_pool):
                if not missing:
                    pending.append(None)
                    continue
                sub = [compats[gi] for gi in missing]
                sig_arrays = build_compat_inputs(sub, e.enc, e.vocab)
                zone_ok, ct_ok = zone_ct_masks(sub, e.enc)
                if mesh is not None:
                    prepared = _entry_sharded(e, mesh)
                    # the active catalog's type padding, recorded each
                    # solve (the upload records it on a cache miss only)
                    sharding.record_shard_padding(
                        "types", int(prepared[1]), prepared[0].n_types, accumulate=False,
                        n_devices=int(mesh.size),
                    )
                    with devicetime.track(phase="compat", devices=mesh.cards):
                        # analysis: allow-wait-under-lock(device — the launch reads the entry's device-resident type planes, which _CATALOG_LOCK guards, and only enqueues; the library was loaded before the lock)
                        allowed = sharding.allowed_sharded(
                            prepared, sig_arrays, zone_ok, ct_ok, tuple(sorted(e.enc.key_masks.keys()))
                        )
                    pending.append((allowed, zone_ok, ct_ok, missing))
                    continue
                catalog = self._device_catalog(e)
                with devicetime.track(phase="compat"):
                    sig = signature_side(sig_arrays, zone_ok, ct_ok, catalog)
                    # analysis: allow-wait-under-lock(device — the launch reads the entry's device-resident type planes, which _CATALOG_LOCK guards, and only enqueues; the library was loaded before the lock)
                    allowed = allowed_via_kernel(sig, catalog)
                if self.device.type == "cuda":
                    # the compat boundary's bytes really cross to the card
                    # only there (the reference accounts none at compat)
                    devicetime.transfer("h2d", sig, phase="compat")
                    deviceplane.record_footprint(deviceplane.nbytes_of(allowed))
                pending.append((allowed, zone_ok, ct_ok, missing))

        # per unique catalog: extended axis + quantized request matrix
        uniq_reqs = unique_requests(self._req_ids, self._req_map)
        matrices: Dict[int, tuple] = {}
        for e in {id(e): e for e in pool_entries}.values():
            axis_ext = extend_axis(e.axis, uniq_reqs)
            matrices[id(e)] = (
                axis_ext,
                build_requests_matrix_ids(self._req_ids, axis_ext, self._req_map),
            )
        # daemonset overhead per pool, added to every planned node's load:
        # the daemons whose tolerations and node selection admit the
        # pool's template (well-known labels the template leaves open
        # are allowed undefined)
        daemon_requests = {}
        for pool, e in zip(pools, pool_entries):
            daemons = [
                p
                for p in daemonset_pods
                if pool.taints.tolerates(p) is None
                and pool.template_requirements.compatible(
                    pod_requirements(p), frozenset(wk.WELL_KNOWN_LABELS), hint=False
                )
                is None
            ]
            daemon_requests[pool.nodepool.name] = quantize_requests(
                resources.requests_for_pods(*daemons) if daemons else {}, matrices[id(e)][0]
            )

        allowed_per_pool = []
        S = len(groups)
        for pi, item in enumerate(pending):
            e = pool_entries[pi]
            if item is not None:
                allowed_dev, sub_zone, sub_ct, missing = item
                with devicetime.track(phase="compat"):
                    sub_allowed = allowed_dev.cpu().numpy()
                if self.device.type == "cuda":
                    devicetime.transfer("d2h", sub_allowed, phase="compat")
                if ws is not None:
                    # analysis: allow-cache-key(extra) — the shard padding telemetry of the dispatch region (record_shard_padding's extra kwargs) never flows into the cached rows
                    self._cache_compat_rows(
                        e, pool_fps[pi], groups, missing, sig_compats[pi], sub_allowed, sub_zone, sub_ct,
                        str(self.device),
                    )
                if len(missing) == S:
                    # nothing was cached for this pool: the sub arrays are
                    # the whole arrays
                    allowed_per_pool.append((sub_allowed, sub_zone, sub_ct))
                    continue
            else:
                missing = []
            allowed = np.zeros((S, len(e.enc.instance_types)), dtype=bool)
            zone_ok = np.zeros((S, len(e.enc.zones)), dtype=bool)
            ct_ok = np.zeros((S, len(e.enc.capacity_types)), dtype=bool)
            for gi, row in enumerate(cached_rows[pi]):
                if row is not None:
                    allowed[gi] = row.allowed
                    zone_ok[gi] = row.zone_ok
                    ct_ok[gi] = row.ct_ok
            for k, gi in enumerate(missing):
                allowed[gi] = sub_allowed[k]
                zone_ok[gi] = sub_zone[k]
                ct_ok[gi] = sub_ct[k]
            allowed_per_pool.append((allowed, zone_ok, ct_ok))
        return dict(
            encoded=encoded,
            sig_compats=sig_compats,
            allowed_per_pool=allowed_per_pool,
            matrices=matrices,
            pool_entries=pool_entries,
            daemon_requests=daemon_requests,
            mesh=mesh,
        )

    def _cache_compat_rows(self, entry, pool_fp, groups, missing, compats, allowed, zone_ok, ct_ok, device) -> None:
        """Keep freshly computed (signature, pool) compat rows on the
        catalog entry, keyed by ``device`` (this solver's). Rows are copied
        out of the batch arrays, so the cache never pins a whole (S, T)
        matrix."""
        with _CATALOG_LOCK:
            for k, gi in enumerate(missing):
                sid = groups[gi].sig_id
                if sid is None:
                    continue
                _sig_rows_put(
                    entry,
                    (pool_fp, sid, device),
                    SigRow(
                        compat=compats[gi],
                        allowed=np.array(allowed[k], dtype=bool),
                        zone_ok=np.array(zone_ok[k], dtype=bool),
                        ct_ok=np.array(ct_ok[k], dtype=bool),
                    ),
                    self._cstats,
                )

    def _pack_phase(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        parked_from: int,
        pools: List[PoolEncoding],
        leftover: Dict[int, List[int]],
        state_nodes: list,
        result: SolverResult,
        ctx: dict,
    ) -> None:
        """Bounded, limit-aware pack rounds: pool choice, class-merged
        jobs, pack + finalize, cross-group merge, then NodePool limit
        enforcement over the round's plans (scheduler.go:347-383). Plans
        that no longer fit a limited pool are stripped and their pods
        retried against the surviving pools/types next round; pods still
        pending after the last round were starved by the limits. Then
        the parked groups (``groups[parked_from:]``) go through the
        pod-affinity post-pass."""
        with self._phase("limits"):
            remaining = self._initial_remaining(pools, state_nodes, result.node_plans)
        # only _enforce_limits reads this; skip on the unlimited path
        gi_of = (
            {i: gi for gi, g in enumerate(groups) for i in g.pod_indices} if remaining else {}
        )
        last_chosen: Dict[int, str] = {}
        pending_idx: Dict[int, List[int]] = {gi: idx for gi, idx in leftover.items() if idx}
        max_rounds = max(len(pools) + 1, 4) if remaining else 1
        for _round in range(max_rounds):
            if not pending_idx:
                break
            with self._phase("limits"):
                limit_masks = self._limit_masks(pools, ctx["encoded"], remaining)
            infos: List[dict] = []
            jobs: List[tuple] = []
            metas: List[dict] = []
            with self._phase("prepare"):
                for gi in sorted(pending_idx):
                    info = self._choose_pool(
                        gi, groups[gi], pods, pools, ctx["encoded"], ctx["sig_compats"],
                        ctx["allowed_per_pool"], result, pending_idx[gi], limit_masks,
                    )
                    if info is not None:
                        infos.append(info)
                self._prepare_class_jobs(
                    infos, ctx["matrices"], ctx["pool_entries"], pools, ctx["encoded"],
                    ctx["daemon_requests"], pods, result, jobs, metas,
                )
            records: List[dict] = []
            plans_start = len(result.node_plans)
            self._pack_and_finalize(jobs, metas, pods, result, records, mesh=ctx.get("mesh"))
            with self._phase("merge"):
                self._merge_and_emit(records, pods, result)
            if not remaining:
                pending_idx = {}
                break
            last_chosen.update({info["gi"]: pools[info["chosen"]].nodepool.name for info in infos})
            with self._phase("limits"):
                pending_idx = self._enforce_limits(result, plans_start, remaining, gi_of)
        for gi, idx in pending_idx.items():
            pool_name = last_chosen.get(gi, pools[0].nodepool.name)
            for i in idx:
                result.pod_errors.setdefault(
                    pods[i].uid,
                    f'all available instance types exceed limits for nodepool: "{pool_name}"',
                )
        if parked_from < len(groups):
            with self._phase("affinity"):
                self._affinity_postpass(
                    pods, groups, list(range(parked_from, len(groups))), pools, result, remaining,
                    ctx,
                )

    # ------------------------------------------------------------------
    # NodePool limits (scheduler.go:76-80, 287-321, 347-383)

    @staticmethod
    def _initial_remaining(
        pools: List[PoolEncoding], state_nodes: list, prior_plans: List[NodePlan] = ()
    ) -> Dict[str, dict]:
        """Per limited pool: spec limits minus the capacity of its
        existing nodes (scheduler.go:76-80 + :287-321) and of the
        NodePlans already emitted in this solve."""
        remaining: Dict[str, dict] = {}
        for pool in pools:
            limits = pool.nodepool.spec.limits
            if limits:
                remaining[pool.nodepool.name] = dict(limits)
        if remaining:
            for n in state_nodes:
                name = n.labels().get(wk.NODEPOOL_LABEL_KEY, "")
                if name in remaining:
                    remaining[name] = resources.subtract(remaining[name], n.capacity())
            for plan in prior_plans:
                if plan.nodepool_name in remaining:
                    remaining[plan.nodepool_name] = resources.subtract(
                        remaining[plan.nodepool_name], plan.instance_type.capacity
                    )
        return remaining

    @staticmethod
    def _limit_masks(
        pools: List[PoolEncoding],
        encoded: List[EncodedInstanceTypes],
        remaining: Dict[str, dict],
    ) -> Optional[List[Optional[np.ndarray]]]:
        """Per pool, the (T,) mask of instance types whose capacity still
        fits under the pool's remaining limits (filterByRemainingResources,
        scheduler.go:367-383); None for unlimited pools."""
        if not remaining:
            return None
        masks: List[Optional[np.ndarray]] = []
        for pool, enc in zip(pools, encoded):
            rem = remaining.get(pool.nodepool.name)
            if rem is None:
                masks.append(None)
                continue
            mask = np.ones(len(enc.instance_types), dtype=bool)
            for t, it in enumerate(enc.instance_types):
                for name, r in rem.items():
                    if it.capacity.get(name, 0) > r:
                        mask[t] = False
                        break
            masks.append(mask)
        return masks

    def _enforce_limits(
        self,
        result: SolverResult,
        plans_start: int,
        remaining: Dict[str, dict],
        gi_of: Dict[int, int],
    ) -> Dict[int, List[int]]:
        """Running reduction over this round's emitted plans in order:
        subtract each plan's pinned instance-type capacity from its
        pool's remaining limits; plans that no longer fit are stripped
        and their pods returned, by group, for the next round (plans pin
        their type, so exact subtraction is what actually launches).
        Plans the post-pass already charged (reseeded anchors) are kept
        as they are."""
        kept: List[NodePlan] = []
        spilled: Dict[int, List[int]] = {}
        for plan in result.node_plans[plans_start:]:
            rem = remaining.get(plan.nodepool_name)
            if rem is None or plan._limits_accounted:
                kept.append(plan)
                continue
            cap = plan.instance_type.capacity
            if any(cap.get(name, 0) > r for name, r in rem.items()):
                for i in plan.pod_indices:
                    spilled.setdefault(gi_of[i], []).append(i)
                continue
            remaining[plan.nodepool_name] = resources.subtract(rem, cap)
            kept.append(plan)
        if len(kept) != len(result.node_plans) - plans_start:
            # plans were stripped: the incremental fold counters and the
            # plan match cache (keyed on plan ids, which a stripped plan
            # frees for reuse) assumed a grow-only plan list — rebuild
            # from scratch
            self._fold_cache = {}
            self._plan_match_cache = {}
        result.node_plans[plans_start:] = kept
        return spilled

    # ------------------------------------------------------------------

    def _choose_pool(
        self,
        gi: int,
        group: SignatureGroup,
        pods: List[Pod],
        pools: List[PoolEncoding],
        encoded: List[EncodedInstanceTypes],
        sig_compats,
        allowed_per_pool,
        result: SolverResult,
        indices: List[int],
        limit_masks: Optional[List[Optional[np.ndarray]]] = None,
    ) -> Optional[dict]:
        """First pool (weight order) whose template accepts the signature
        and offers at least one viable type within its remaining limits
        (scheduler.go:256-283 + filterByRemainingResources :367).
        ``indices`` is the group's still-unplaced subset."""
        chosen = None
        chosen_viable = None
        chosen_zone_ok = None
        limit_starved: List[str] = []
        # non-self zone anti-affinity: the zones holding a matching pod
        # leave the pool's zone_ok and, through the offerings, its viable
        # row before the frontier — on copies: the kernel's rows are the
        # signature's, the exclusion is this solve's cluster state. A
        # pool left with no admissible zone is skipped like an
        # incompatible one.
        excl_zones = self._anti_excluded_zones(group) if group.anti_exclusion_terms() else frozenset()
        for pi, pool in enumerate(pools):
            if not sig_compats[pi][gi].compatible:
                continue
            compat_row = allowed_per_pool[pi][0][gi]
            zone_row = allowed_per_pool[pi][1][gi]
            if excl_zones:
                enc = encoded[pi]
                zmask = np.array([z in excl_zones for z in enc.zones], dtype=bool)
                if zmask.any():
                    zone_row = zone_row & ~zmask
                    # the offering leg of the allowed row on the narrowed
                    # zones (the compat leg does not depend on zones)
                    compat_row = compat_row & enc.offering_avail[:, zone_row, :][
                        :, :, allowed_per_pool[pi][2][gi]
                    ].any(axis=(1, 2))
            if limit_masks is not None and limit_masks[pi] is not None:
                viable_row = compat_row & limit_masks[pi]
                if compat_row.any() and not viable_row.any():
                    limit_starved.append(pool.nodepool.name)
                    continue
            else:
                viable_row = compat_row
            if viable_row.any():
                chosen = pi
                chosen_viable = viable_row
                chosen_zone_ok = zone_row
                break
        if chosen is None:
            err = "; ".join(
                f'all available instance types exceed limits for nodepool: "{p.nodepool.name}"'
                if p.nodepool.name in limit_starved
                else f'incompatible with nodepool "{p.nodepool.name}", '
                f'{sig_compats[pi][gi].error or "no viable instance type"}'
                for pi, p in enumerate(pools)
            )
            for i in indices:
                result.pod_errors[pods[i].uid] = err
            return None
        # per-node pod cap from hostname spread / self anti-affinity
        max_per_node = np.int32(MAX_INT32)
        solo_cross_hostname = False
        hs = group.hostname_spread()
        if hs is not None:
            sel = hs.label_selector
            if sel is None or sel.matches(group.exemplar.metadata.labels):
                max_per_node = np.int32(hs.max_skew)
            else:
                # non-self-selecting hostname spread: the reference adds
                # no +1 for non-matching pods (topologygroup.go:166-175)
                # and the hostname min is always 0, so fresh nodes are
                # always admissible and the group's own pods stack
                # freely — but it must not share nodes with pods its
                # selector counts, so it packs solo on new nodes only
                solo_cross_hostname = True
        if group.hostname_isolated:
            max_per_node = np.int32(1)
        return dict(
            group=group,
            gi=gi,
            indices=indices,
            chosen=chosen,
            viable=chosen_viable,  # (T,) bool, limit- and exclusion-filtered
            zone_ok=chosen_zone_ok,  # (Z,) narrowed by anti-affinity exclusion
            ct_ok=allowed_per_pool[chosen][2][gi],  # (C,)
            max_per_node=max_per_node,
            solo_cross_hostname=solo_cross_hostname,
            merged=sig_compats[chosen][gi].merged,  # template ∩ pod reqs
        )

    def _prepare_class_jobs(
        self,
        infos: List[dict],
        matrices: Dict[int, tuple],
        pool_entries: List[_CatalogEntry],
        pools: List[PoolEncoding],
        encoded: List[EncodedInstanceTypes],
        daemon_requests,
        pods: List[Pod],
        result: SolverResult,
        jobs: List[tuple],
        metas: List[dict],
    ) -> None:
        """Class-merged pack jobs. Groups pack together only when their
        FULL merged requirement sets agree — the (viable, zone, ct) masks
        alone miss keys that don't project onto catalog dimensions
        (custom node labels). Hostname-capped groups stay solo (their cap
        is enforced per job). Within a class, every zone-spread group
        water-fills its own pods over the zones and the class's plain
        pods ride along round-robin; each zone's bucket packs as one
        zone-pinned job. A zone self-anti-affinity group stays solo and
        takes one pod per free zone (_affinity_assign)."""
        classes: Dict[tuple, List[dict]] = {}
        for info in infos:
            if (
                int(info["max_per_node"]) < MAX_INT32
                or info["solo_cross_hostname"]
                or info["group"].zone_anti_isolated
            ):
                key = ("solo", id(info["group"]))
            else:
                key = (
                    info["chosen"],
                    info["viable"].tobytes(),
                    info["zone_ok"].tobytes(),
                    info["ct_ok"].tobytes(),
                    _requirements_fingerprint(info["merged"]),
                )
            classes.setdefault(key, []).append(info)
        for members in classes.values():
            chosen = members[0]["chosen"]
            pool, enc = pools[chosen], encoded[chosen]
            viable = members[0]["viable"]
            zone_ok, ct_ok = members[0]["zone_ok"], members[0]["ct_ok"]
            max_per_node = members[0]["max_per_node"]
            merged = members[0]["merged"]
            # hostname-level per-node limits of this class's group (solo
            # classes only — shared classes carry none): the merge pass
            # enforces them on any combined membership
            node_limits = _group_node_limits(members[0]["group"])
            daemon = daemon_requests[pool.nodepool.name]
            requests_matrix = matrices[id(pool_entries[chosen])][1]
            # host-port sets per pod: a class can mix port-bearing and
            # portless groups, and the job's appended port columns let
            # the packer enforce every conflict
            ports_of: Optional[Dict[int, tuple]] = None
            if any(m["group"].has_stateful_node_constraints for m in members):
                ports_of = {}
                for m in members:
                    p = m["group"].host_ports()
                    if p:
                        for i in m["indices"]:
                            ports_of[int(i)] = p
                ports_of = ports_of or None
            spread = [m for m in members if m["group"].zone_spread() is not None]
            plain = [m for m in members if m["group"].zone_spread() is None]

            def sorted_idx(group_pods: List[int]) -> Tuple[np.ndarray, np.ndarray]:
                idx = np.asarray(group_pods, dtype=np.int64)
                reqs = requests_matrix[idx]
                # descending by primary then memory (queue.go:76 ordering)
                order = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
                return idx[order], reqs[order]

            def prepare(idx, reqs, job_viable, zone=None):
                self._prepare_job(
                    idx, reqs, enc, job_viable, zone_ok, ct_ok, daemon, max_per_node, pool,
                    pods, result, jobs, metas, zone=zone, merged=merged,
                    per_node_limits=node_limits, pod_ports=ports_of,
                )

            g0 = members[0]["group"]
            if len(members) == 1 and g0.zone_anti_isolated:
                idx0, reqs0 = sorted_idx(members[0]["indices"])
                self._affinity_assign(
                    members[0], idx0, reqs0, enc, pool, daemon, pods, result, jobs, metas
                )
                continue
            if (
                len(members) == 1
                and int(max_per_node) < MAX_INT32
                and self._existing_ctx is not None
                and g0.zone_spread() is None
            ):
                # hostname-capped group with existing capacity: fill each
                # node's quota (cap minus its matching pods) before
                # opening capped new nodes. Groups that also zone-spread
                # skip this: their pods are zone-assigned first and take
                # new zone-pinned nodes, where the cap still applies.
                idx0, _ = sorted_idx(members[0]["indices"])
                left = self._pack_hostname_existing(
                    members[0], idx0, int(max_per_node), pods, result
                )
                if not left:
                    continue
                members[0] = dict(members[0], indices=left)
                spread, plain = [], [members[0]]

            if not spread:
                prepare(*sorted_idx([i for m in members for i in m["indices"]]), viable)
                continue

            zones, zone_types = _viable_zones(enc, viable, zone_ok, ct_ok)
            if not zones:
                for m in spread:
                    for i in m["indices"]:
                        result.pod_errors[pods[i].uid] = (
                            "no zone with viable offering for topology spread"
                        )
                if plain:
                    prepare(*sorted_idx([i for m in plain for i in m["indices"]]), viable)
                continue

            # per-group min-skew zone assignment from seeded domain
            # counters (topology.go:125-148 Record + topologygroup.go:
            # 93-104 min-skew selection, in closed form); zone-assigned
            # pods try existing nodes in their zone before new ones
            buckets: Dict[str, list] = {z: [] for z in zones}
            Z = len(zones)
            for m in spread:
                g_idx, _ = sorted_idx(m["indices"])
                self._spread_assign(m, g_idx, zones, enc, pods, result, buckets)
            # plain pods ride along only when the zone choice doesn't
            # shrink the viable set — otherwise a pod needing a type
            # offered in one zone could land in a bucket without it
            ride_along = plain and all(
                bool(np.array_equal(zone_types[z], viable)) for z in zones
            )
            if ride_along:
                p_idx, _ = sorted_idx([i for m in plain for i in m["indices"]])
                for zi, z in enumerate(zones):
                    part = p_idx[zi::Z]
                    if part.size:
                        buckets[z].append(part)
                        self._ledger_add(pods, part, z)
            elif plain:
                prepare(*sorted_idx([i for m in plain for i in m["indices"]]), viable)
            for z in zones:
                if buckets[z]:
                    prepare(*sorted_idx(np.concatenate(buckets[z])), zone_types[z], zone=z)

    # ------------------------------------------------------------------
    # topology spread on the tensor path (topology_tensor.py)

    def _spread_seeds(self, group: SignatureGroup, constraint) -> Dict[str, int]:
        """Bound matching-pod counts per domain for one constraint, from
        ``kube_client``, cached per solve (batch pods are excluded) and
        across solves while the cluster's generation holds."""
        key = (
            constraint.topology_key,
            _selector_key(constraint.label_selector),
            group.exemplar.namespace,
            # counting drops pods on nodes failing the exemplar's node
            # filter — groups with different node selection must not
            # share counts
            TopologyNodeFilter.for_pod(group.exemplar).key(),
        )
        seeds = self._seed_cache.get(key)
        if seeds is None:
            seeds, skey = self._seeds_memo_get(key)
            if seeds is None:
                seeds = seed_counts_for_constraint(
                    self.kube_client, group.exemplar, constraint, self._batch_uids
                )
                # analysis: allow-cache-key(self.kube_client) — the seeds memo is scoped to the cluster generation (seeds_get/put); the client is read through that witness
                self._seeds_memo_put(skey, seeds)
            self._seed_cache[key] = seeds
        return seeds

    def _seeds_memo_get(self, key: tuple) -> Tuple[Optional[Dict[str, int]], Optional[tuple]]:
        """The cross-tick seed memo's counts for ``key`` (None on a miss)
        and the memo key to store a recount under (None when the memo is
        off or there is no cluster generation to witness the counts). The
        key carries the seed exclusion key, the drained set of a
        disruption simulation and the tenant scope: the generation guard
        is one cluster's counter, and a simulated world must never alias
        the live one."""
        ws = self._warm
        gen = self._cluster_gen
        if ws is None or gen is None:
            return None, None
        skey = key + (self._seed_exclusion_key(), self._sim_drained, self._tenant_scope)
        return ws.seeds_get(skey, gen, self._cstats), skey

    def _seeds_memo_put(self, skey: Optional[tuple], seeds: Dict[str, int]) -> None:
        if skey is not None:
            # the kube-visible pods and nodes the counts derive from are
            # witnessed by the cluster-generation guard
            self._warm.seeds_put(skey, self._cluster_gen, seeds, self._cstats)

    @staticmethod
    def _sel_fp(sel) -> tuple:
        # cached on the selector object itself (selectors are immutable
        # once built; the hot paths call this very often)
        fp = getattr(sel, "_solver_fp", None)
        if fp is None:
            fp = (
                tuple(sorted(sel.match_labels.items())),
                tuple((e.key, e.operator, tuple(e.values)) for e in sel.match_expressions),
            )
            sel._solver_fp = fp
        return fp

    def _sel_matches(self, sel, i: int, pods: List[Pod]) -> bool:
        if sel is None:
            return True
        key = (self._sel_fp(sel), i)
        hit = self._match_cache.get(key)
        if hit is None:
            hit = sel.matches(pods[i].metadata.labels)
            self._match_cache[key] = hit
        return hit

    def _fold_committed(
        self,
        seeds: Dict[str, int],
        selector,
        namespace: str,
        pods: List[Pod],
        result: SolverResult,
    ) -> Dict[str, int]:
        """Per-zone counts of THIS solve's committed placements matching
        a selector, folded into the seeds — later passes (limit-spill
        rounds) must see them: the oracle records every landing
        immediately (topology.go:125). Free when no plans exist yet."""
        if not (result.node_plans or result.existing_plans):
            return seeds
        # incremental: per selector content, a cursor state counts each
        # plan member exactly once
        key = (self._sel_fp(selector) if selector is not None else None, namespace)
        st = self._fold_cache.get(key)
        if st is None:
            st = {"sizes": {}, "ec": 0, "counts": {}}
            self._fold_cache[key] = st
        counts = st["counts"]

        def _count(members, start, zone):
            n = 0
            for i in members[start:]:
                if pods[i].namespace == namespace and self._sel_matches(selector, i, pods):
                    n += 1
            if n and zone:
                counts[zone] = counts.get(zone, 0) + n

        sizes = st["sizes"]
        for plan in result.node_plans:
            pid = id(plan)
            seen = sizes.get(pid, 0)
            members = plan.pod_indices
            if len(members) > seen:  # a new plan, or one that grew
                _count(members, seen, plan.zone)
                sizes[pid] = len(members)
        eplans = result.existing_plans
        for eplan in eplans[st["ec"] :]:
            _count(eplan.pod_indices, 0, eplan.state_node.labels().get(wk.LABEL_TOPOLOGY_ZONE))
        st["ec"] = len(eplans)
        if not counts:
            return seeds
        seeds = dict(seeds)
        for z, n in counts.items():
            seeds[z] = seeds.get(z, 0) + n
        return seeds

    def _ledger_add(self, pods: List[Pod], part, zone: str) -> None:
        if not self._ledger_selectors:
            return
        for i in part.tolist():
            p = pods[int(i)]
            for sel, ns in self._ledger_selectors:
                if ns == p.namespace and self._sel_matches(sel, int(i), pods):
                    self._prep_zone_ledger.append((int(i), zone))
                    break

    def _fold_ledger(
        self,
        seeds: Dict[str, int],
        selector,
        namespace: str,
        pods: List[Pod],
    ) -> Dict[str, int]:
        """Fold this solve's prep-time zone-pinned assignments into the
        seeds — the in-batch analogue of the oracle recording each
        placement before counting the next (topology.go:125). Unpinned
        jobs are absent: they correspond to pods placed after every
        counting group."""
        if not self._prep_zone_ledger:
            return seeds
        seeds = dict(seeds)
        for i, z in self._prep_zone_ledger:
            if pods[i].namespace == namespace and self._sel_matches(selector, i, pods):
                seeds[z] = seeds.get(z, 0) + 1
        return seeds

    def _existing_compat_row(self, group: SignatureGroup, ctx: dict) -> np.ndarray:
        """(M,) admissibility of one group on the existing nodes, less
        the nodes its non-self anti-affinity excludes, cached per group
        in the existing-node context."""
        row = ctx["compat_rows"].get(id(group))
        if row is None:
            row = existing_node_compat([group], ctx["nodes"])[0]
            excl = self._anti_exclusion_row(group, ctx)
            if excl is not None:
                row = (row.astype(bool) & ~excl).astype(row.dtype)
            ctx["compat_rows"][id(group)] = row
        return row

    def _group_volumes(self, group: SignatureGroup) -> GroupVolumes:
        """Per-solve memo of resolve_group_volumes (the PVC → StorageClass
        → driver chain reads the kube store once per signature)."""
        gv = self._group_vols_cache.get(id(group))
        if gv is None:
            gv = resolve_group_volumes(self.kube_client, group)
            self._group_vols_cache[id(group)] = gv
        return gv

    def _inject_volume_zones(self, pods: List[Pod]) -> None:
        """VolumeTopology.inject on the solve's own pods: PVC-pinned zone
        requirements join each pod's node affinity so the compat algebra
        sees them. A pod whose computed pin is already injected is
        skipped (no memo churn on a re-solve); a pod with volumes but no
        pin never changes."""
        vt = VolumeTopology(self.kube_client)
        for pod in pods:
            if not pod.spec.volumes:
                continue
            reqs = [r for volume in pod.spec.volumes for r in vt._requirements_for_volume(pod, volume)]
            if not reqs:
                continue
            key = tuple(sorted((r.key, r.operator, tuple(r.values)) for r in reqs))
            if pod.__dict__.get("_karp_volzone_key") == key:
                continue  # pin already injected and unchanged
            vt.inject(pod)
            pod.__dict__["_karp_volzone_key"] = key

    # ------------------------------------------------------------------
    # required anti-affinity against pods outside the batch: static
    # domain exclusion from seeded counts (routing sends every group
    # whose term selector matches another batch group to the oracle, so
    # no placement of this solve can move those counts)

    def _anti_seeds(self, group: SignatureGroup, term, topology_key: str) -> Dict[str, int]:
        """Bound matching-pod counts per domain for one anti-affinity
        term (no node filter, topologygroup.go:70-76), cached per solve
        and across solves under the cluster generation (as
        ``_spread_seeds``)."""
        key = ("anti", topology_key, _selector_key(term.label_selector), group.exemplar.namespace)
        seeds = self._seed_cache.get(key)
        if seeds is None:
            seeds, skey = self._seeds_memo_get(key)
            if seeds is None:
                seeds = seed_counts_for_selector(
                    self.kube_client, group.exemplar, topology_key, term.label_selector,
                    self._batch_uids,
                )
                # analysis: allow-cache-key(self.kube_client) — the seeds memo is scoped to the cluster generation (seeds_get/put); the client is read through that witness
                self._seeds_memo_put(skey, seeds)
            self._seed_cache[key] = seeds
        return seeds

    def _anti_excluded_zones(self, group: SignatureGroup) -> frozenset:
        """Zones a non-self required anti-affinity term forbids: every
        zone already holding a selector-matching pod. Cached per group
        for the solve."""
        gid = id(group)
        excl = self._anti_zone_excl_cache.get(gid)
        if excl is None:
            zones: set = set()
            for term in group.anti_exclusion_terms():
                if term.topology_key != wk.LABEL_TOPOLOGY_ZONE:
                    continue
                seeds = self._anti_seeds(group, term, wk.LABEL_TOPOLOGY_ZONE)
                zones.update(z for z, n in seeds.items() if n > 0)
            excl = frozenset(zones)
            self._anti_zone_excl_cache[gid] = excl
        return excl

    def _anti_excluded_hosts(self, group: SignatureGroup) -> frozenset:
        """Hostnames a non-self required anti-affinity term forbids
        (existing nodes already holding a matching pod); a new node is an
        empty hostname domain and always admissible."""
        hosts: set = set()
        for term in group.anti_exclusion_terms():
            if term.topology_key != wk.LABEL_HOSTNAME:
                continue
            seeds = self._anti_seeds(group, term, wk.LABEL_HOSTNAME)
            hosts.update(h for h, n in seeds.items() if n > 0)
        return frozenset(hosts)

    def _anti_exclusion_row(self, group: SignatureGroup, ctx: dict) -> Optional[np.ndarray]:
        """(M,) bool mask of the existing nodes the group's non-self
        anti-affinity terms exclude (zone and hostname), or None when it
        carries none."""
        if not group.anti_exclusion_terms():
            return None
        nodes = ctx["nodes"]
        excl = np.zeros(len(nodes), dtype=bool)
        zones = self._anti_excluded_zones(group)
        if zones:
            excl |= np.isin(ctx["node_zones"], sorted(zones))
        hosts = self._anti_excluded_hosts(group)
        if hosts:
            excl |= np.array([(n.hostname() in hosts or n.name() in hosts) for n in nodes])
        return excl

    def _spread_assign(
        self,
        m: dict,
        g_idx: np.ndarray,
        zones: List[str],
        enc: EncodedInstanceTypes,
        pods: List[Pod],
        result: SolverResult,
        buckets: Dict[str, list],
    ) -> None:
        """Assign one spread group's pods to zones by seeded min-skew
        quotas, route each zone's pods through existing capacity first,
        and append the remainder to the new-node buckets."""
        group: SignatureGroup = m["group"]
        c = group.zone_spread()
        P = len(g_idx)
        if P == 0:
            return
        seeds = self._fold_ledger(
            self._fold_committed(
                self._spread_seeds(group, c), c.label_selector, group.exemplar.namespace, pods,
                result,
            ),
            c.label_selector,
            group.exemplar.namespace,
            pods,
        )
        ctx = self._existing_ctx
        merged = m["merged"]
        zone_req = merged.get_req(wk.LABEL_TOPOLOGY_ZONE) if merged is not None else None

        def allowed(z: str) -> bool:
            return zone_req is None or zone_req.has(z)

        # placement domains A: new-node-eligible zones, plus zones whose
        # existing nodes admit the group (scheduler.go:241-246 order).
        # Hostname-capped groups can't use the existing-node first-fit
        # (it has no per-node matching-count quota), so for them
        # existing-only zones are not placement domains.
        can_use_existing = (
            ctx is not None
            and int(m["max_per_node"]) >= MAX_INT32
            and not m.get("solo_cross_hostname")
        )
        place = list(zones)
        existing_zones: set = set()
        if can_use_existing:
            row = self._existing_compat_row(group, ctx).astype(bool)
            for z in sorted(set(ctx["node_zones"][row].tolist())):
                if z and allowed(z):
                    existing_zones.add(z)
                    if z not in place:
                        place.append(z)
        # pod-supported domains D: the full universe filtered by the
        # merged requirements — supported-but-unplaceable domains pin the
        # global min at their seed count (topologygroup.go:177,193-212)
        universe = set(enc.zones) | set(seeds) | existing_zones
        supported = {d for d in universe if allowed(d)}
        ext = supported - set(place)
        ext_min = min(seeds.get(d, 0) for d in ext) if ext else None
        # min_domains applies to DoNotSchedule only
        min_domains = c.min_domains if c.when_unsatisfiable != SCHEDULE_ANYWAY else None
        counts = np.array([seeds.get(z, 0) for z in place], dtype=np.int64)
        sel = c.label_selector
        if sel is None or sel.matches(group.exemplar.metadata.labels):
            quotas, unplaced = spread_quotas(
                counts, ext_min, c.max_skew, min_domains, len(supported), P
            )
        else:
            # cross-selector spread: the group's own placements never move
            # the counts (topologygroup.go:166-175 adds the +1 only when
            # the pod matches its own selector), so the min-count domain
            # is static and every pod takes it
            if min_domains is not None and len(supported) < min_domains:
                global_min = 0  # topologygroup.go:205-210
            else:
                global_min = min((seeds.get(d, 0) for d in supported), default=0)
            admissible = [zi for zi in range(len(place)) if counts[zi] - global_min <= c.max_skew]
            quotas = np.zeros(len(place), dtype=np.int64)
            if admissible:
                quotas[min(admissible, key=lambda zi: counts[zi])] = P
                unplaced = 0
            else:
                unplaced = P
        parts = interleave_by_quota(g_idx, quotas)
        if unplaced:
            # DoNotSchedule overflow fails like the oracle's DoesNotExist
            # next domain; ScheduleAnyway groups reach here only through
            # the relaxation ladder, which the port refuses
            for i in g_idx[P - unplaced :]:
                result.pod_errors[pods[i].uid] = (
                    f"would violate max-skew for topology spread on {c.topology_key}"
                )
        respill: List[np.ndarray] = []
        for zi, z in enumerate(place):
            part = parts[zi]
            if part.size and can_use_existing and z in existing_zones:
                # pods landing on existing nodes become existing plans at
                # prep — _fold_committed counts those; no ledger entry
                part = self._pack_spread_existing(part, z, group, ctx, result)
            if part.size == 0:
                continue
            if z in buckets:  # new-node-eligible zone
                buckets[z].append(part)
                self._ledger_add(pods, part, z)
            else:
                respill.append(part)
        if respill:
            # existing-only zones out of free capacity: retarget the
            # least-loaded new-node zone (bounded skew divergence — the
            # oracle would interleave these per pod)
            spill = np.concatenate(respill)
            tgt = min(zones, key=lambda z: seeds.get(z, 0) + sum(int(p.size) for p in buckets[z]))
            buckets[tgt].append(spill)
            self._ledger_add(pods, spill, tgt)

    def _pack_hostname_existing(
        self,
        m: dict,
        idx: np.ndarray,  # the group's pod indices, descending by size
        cap: int,
        pods: List[Pod],
        result: SolverResult,
    ) -> List[int]:
        """Fill existing nodes up to each node's hostname quota: the cap
        minus the node's matching pods, bound (seeds) or placed earlier
        in this solve — hostname domains always see a global min of 0
        (topologygroup.go:193-196). A group with both a hostname spread
        and self anti-affinity takes the minimum over both constraints'
        quotas. Host-side first-fit, O(P·M). Returns the indices still
        needing new nodes."""
        group: SignatureGroup = m["group"]
        ctx = self._existing_ctx
        nodes = ctx["nodes"]
        ns = group.exemplar.namespace
        constraints: List[tuple] = []
        hs = group.hostname_spread()
        if hs is not None:
            constraints.append((int(hs.max_skew), hs.label_selector, self._spread_seeds(group, hs)))
        if group.hostname_isolated:
            term = next(
                t
                for t in group.exemplar.spec.affinity.pod_anti_affinity.required
                if t.topology_key == wk.LABEL_HOSTNAME
            )
            skey = ("anti-host", _selector_key(term.label_selector), ns)
            seeds = self._seed_cache.get(skey)
            if seeds is None:
                seeds = seed_counts_for_selector(
                    self.kube_client, group.exemplar, wk.LABEL_HOSTNAME, term.label_selector,
                    self._batch_uids,
                )
                self._seed_cache[skey] = seeds
            constraints.append((1, term.label_selector, seeds))

        def committed(selector) -> Dict[str, int]:
            # matching pods this solve already put on each existing node
            out: Dict[str, int] = {}
            for eplan in result.existing_plans:
                n = sum(
                    1
                    for i in eplan.pod_indices
                    if pods[i].namespace == ns
                    and (selector is None or selector.matches(pods[i].metadata.labels))
                )
                if n:
                    name = eplan.state_node.hostname() or eplan.state_node.name()
                    out[name] = out.get(name, 0) + n
            return out

        row = self._existing_compat_row(group, ctx).astype(bool)
        quota = np.where(row, np.int64(cap), np.int64(0)).astype(np.int64)
        for c_cap, selector, seeds in constraints:
            done = committed(selector)
            q_c = np.array(
                [
                    max(
                        0,
                        c_cap
                        - max(seeds.get(n.hostname(), 0), seeds.get(n.name(), 0))
                        - max(done.get(n.hostname(), 0), done.get(n.name(), 0)),
                    )
                    for n in nodes
                ],
                dtype=np.int64,
            )
            quota = np.minimum(quota, q_c)
        if not quota.any():
            return list(idx)
        reqs = build_requests_matrix_ids(self._req_ids[idx], ctx["axis"], self._req_map)
        free = ctx["free"]
        by_node: Dict[int, List[int]] = {}
        leftover: List[int] = []
        eligible = np.flatnonzero(quota > 0)
        for j, i in enumerate(idx):
            placed = False
            for mi in eligible:
                if quota[mi] > 0 and (free[mi] >= reqs[j]).all():
                    free[mi] -= reqs[j]
                    quota[mi] -= 1
                    by_node.setdefault(int(mi), []).append(int(i))
                    placed = True
                    break
            if not placed:
                leftover.append(int(i))
        for mi in sorted(by_node):
            result.existing_plans.append(
                ExistingNodePlan(state_node=nodes[mi], pod_indices=by_node[mi])
            )
        return leftover

    def _pack_spread_existing(
        self,
        part: np.ndarray,
        zone: str,
        group: SignatureGroup,
        ctx: dict,
        result: SolverResult,
    ) -> np.ndarray:
        """First-fit one zone bucket onto that zone's admitting existing
        nodes (zone-pinned so committed domain counts stay exact) on the
        native first-fit; returns the indices that still need a new
        node."""
        row = self._existing_compat_row(group, ctx).astype(bool)
        mask = row & (ctx["node_zones"] == zone)
        if not mask.any():
            return part
        reqs = build_requests_matrix_ids(self._req_ids[part], ctx["axis"], self._req_map)
        assign, free_out = run_pack_existing(
            reqs, np.zeros(len(part), dtype=np.int32), mask[None, :].astype(np.uint8), ctx["free"],
            device=self.device,
        )
        ctx["free"] = np.ascontiguousarray(free_out, dtype=np.int32)
        placed = assign >= 0
        if placed.any():
            by_node: Dict[int, List[int]] = {}
            for j in np.flatnonzero(placed):
                by_node.setdefault(int(assign[j]), []).append(int(part[j]))
            for mnode in sorted(by_node):
                result.existing_plans.append(
                    ExistingNodePlan(state_node=ctx["nodes"][mnode], pod_indices=by_node[mnode])
                )
        return part[~placed]

    def _affinity_assign(
        self,
        m: dict,
        idx: np.ndarray,  # the group's pod indices, descending by size
        reqs: np.ndarray,
        enc: EncodedInstanceTypes,
        pool: PoolEncoding,
        daemon: np.ndarray,
        pods: List[Pod],
        result: SolverResult,
        jobs: List[tuple],
        metas: List[dict],
    ) -> None:
        """Zone self-anti-affinity: at most one pod per zone; zones
        already holding a matching pod are full and the pods left over
        fail (nextDomainAntiAffinity, topologygroup.go:249-257). Each
        placed pod tries its zone's existing nodes, else takes a one-pod
        zone-pinned job kept out of the merge."""
        group: SignatureGroup = m["group"]
        zone_ok, ct_ok = m["zone_ok"], m["ct_ok"]
        P = len(idx)
        ctx = self._existing_ctx
        zones, zone_types = _viable_zones(enc, m["viable"], zone_ok, ct_ok)
        term = next(
            t
            for t in group.exemplar.spec.affinity.pod_anti_affinity.required
            if t.topology_key == wk.LABEL_TOPOLOGY_ZONE
        )
        seeds = self._fold_committed(
            seed_counts_for_selector(
                self.kube_client, group.exemplar, wk.LABEL_TOPOLOGY_ZONE, term.label_selector,
                self._batch_uids,
            ),
            term.label_selector,
            group.exemplar.namespace,
            pods,
            result,
        )
        counts = np.array([min(seeds.get(z, 0), 1) for z in zones], dtype=np.int64)
        quotas, _ = water_fill(counts, P, ceiling=1)
        pos = 0
        for zi, z in enumerate(zones):
            if quotas[zi] <= 0:
                continue
            part = idx[pos : pos + 1]
            r = reqs[pos : pos + 1]
            pos += 1
            if ctx is not None:
                part = self._pack_spread_existing(part, z, group, ctx, result)
            if part.size:
                self._prepare_job(
                    part, r, enc, zone_types[z], zone_ok, ct_ok, daemon, np.int32(1), pool, pods,
                    result, jobs, metas, zone=z, merged=m["merged"], no_merge=True,
                )
        for i in idx[pos:]:
            result.pod_errors[pods[i].uid] = (
                "pod anti-affinity on zone: no zone without a matching pod"
            )

    # ------------------------------------------------------------------
    # the pod-affinity post-pass: parked groups against the placements
    # committed by the pack rounds (topologygroup.go:215-247)

    def _plan_has_match(self, plan: NodePlan, sel, ns: str, pods: List[Pod]) -> bool:
        """Whether any member of ``plan`` matches (sel, ns). Cached per
        selector content and plan; rescans only the members added since
        the last check."""
        members = plan.pod_indices
        if sel is None:
            return any(pods[i].namespace == ns for i in members)
        key = (self._sel_fp(sel), id(plan))
        seen, matched = self._plan_match_cache.get(key, (0, False))
        if matched:
            return True
        if seen < len(members):
            for i in members[seen:]:
                if pods[i].namespace == ns and self._sel_matches(sel, i, pods):
                    matched = True
                    break
            self._plan_match_cache[key] = (len(members), matched)
        return matched

    @staticmethod
    def _topo_order_parked(groups: List[SignatureGroup], parked_idx: List[int]) -> List[int]:
        """Anchor-dependency order: when one of A's affinity selectors
        matches B's labels, B resolves first (its placements are A's
        admissible domains). Kahn's algorithm; a cycle falls back to
        input order (the cycle member that goes first sees no in-batch
        anchors, as the reference does under that pod order)."""
        sels_of = {
            gi: [t.label_selector for t in groups[gi].affinity_terms() if t.label_selector is not None]
            for gi in parked_idx
        }
        deps: Dict[int, set] = {gi: set() for gi in parked_idx}
        for gi in parked_idx:
            sels = sels_of[gi]
            if not sels:
                continue
            for gj in parked_idx:
                if gj != gi and any(sel.matches(groups[gj].exemplar.metadata.labels) for sel in sels):
                    deps[gi].add(gj)
        order: List[int] = []
        placed: set = set()
        pending = list(parked_idx)
        while pending:
            ready = [gi for gi in pending if deps[gi] <= placed]
            if not ready:
                ready = [pending[0]]  # a cycle: break it in input order
            for gi in ready:
                order.append(gi)
                placed.add(gi)
            pending = [gi for gi in pending if gi not in placed]
        return order

    def _affinity_postpass(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        parked_idx: List[int],
        pools: List[PoolEncoding],
        result: SolverResult,
        remaining: Dict[str, dict],
        ctx: dict,
    ) -> None:
        """Resolve the parked required pod-affinity groups after the pack
        rounds, one group at a time in anchor-dependency order, each
        against every placement committed so far: its admissible domains
        are the reference's counts at placement (topologygroup.go:215-247)
        under the pod order that places counted groups first. Rounds
        repeat while one makes progress (the oracle's retry queue,
        queue.go): a group that failed for want of anchors retries after
        later groups placed pods its selectors match.

        The hostname reseeds move donors as the JAX package does. Where
        the fixpoint leaves a moved donor, or a pod it anchored, with no
        pod its hostname term selects on its node (the JAX package's
        plan breaks that affinity; later joins often re-anchor a donor,
        and then the plan is the JAX package's), the post-pass runs
        again from the state before it, moving only donors whose move
        keeps every such term (_donor_movable)."""
        order = self._topo_order_parked(groups, parked_idx)
        snapshot = self._postpass_snapshot(result, remaining)
        self._reseed_guard = False
        self._reseeded = []
        self._postpass_rounds(pods, groups, order, pools, result, remaining, ctx)
        if self._reseeded and self._reseed_stranded(result, pods):
            self._postpass_restore(snapshot, result, remaining)
            self._reseed_guard = True
            self._postpass_rounds(pods, groups, order, pools, result, remaining, ctx)
        self.last_reseed_redo = self._reseed_guard

    def _postpass_snapshot(self, result: SolverResult, remaining: Dict[str, dict]) -> tuple:
        """What the post-pass may change: the plans' memberships, types,
        prices and requirements, the plan and existing-plan lists, the
        pod errors, the remaining limits and the existing nodes' free
        capacity (every post-pass write replaces these arrays and dicts
        or appends to the lists)."""
        plans = [
            (
                p,
                {
                    **p.__dict__,
                    "pod_indices": list(p.pod_indices),
                    "_pod_requests": None if p._pod_requests is None else list(p._pod_requests),
                },
            )
            for p in result.node_plans
        ]
        free = None if self._existing_ctx is None else self._existing_ctx["free"]
        return (
            plans, len(result.existing_plans), dict(result.pod_errors),
            {k: dict(v) for k, v in remaining.items()}, free,
        )

    def _postpass_restore(self, snapshot: tuple, result: SolverResult, remaining: Dict[str, dict]) -> None:
        """Undo the post-pass: everything ``_postpass_snapshot`` took back
        as it was."""
        plans, n_existing, errors, limits, free = snapshot
        for p, state in plans:
            p.__dict__.update(state)
        result.node_plans[:] = [p for p, _ in plans]
        del result.existing_plans[n_existing:]
        result.pod_errors.clear()
        result.pod_errors.update(errors)
        remaining.clear()
        remaining.update(limits)
        if free is not None:
            self._existing_ctx["free"] = free
        # incremental caches over the plan lists: rebuilt from scratch
        self._fold_cache = {}
        self._plan_match_cache = {}

    def _reseed_stranded(self, result: SolverResult, pods: List[Pod]) -> bool:
        """Whether a plan a reseed took a pod from or opened holds, at
        the fixpoint, a pod with a required hostname pod-affinity term
        that no pod on the plan (itself included) matches."""
        touched = {id(p) for p in self._reseeded}
        for plan in result.node_plans:
            if id(plan) not in touched:
                continue
            members = [pods[i] for i in plan.pod_indices]
            for pod in members:
                for t in _hostname_affinity_terms(pod):
                    if not any(
                        o.namespace == pod.namespace and t.label_selector.matches(o.metadata.labels)
                        for o in members
                    ):
                        return True
        return False

    def _postpass_rounds(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        order: List[int],
        pools: List[PoolEncoding],
        result: SolverResult,
        remaining: Dict[str, dict],
        ctx: dict,
    ) -> None:
        """The parked groups in ``order``, in rounds until one makes no
        progress."""
        encoded = ctx["encoded"]
        gi_of = {i: gi for gi in order for i in groups[gi].pod_indices} if remaining else {}
        pending: Dict[int, List[int]] = {gi: list(groups[gi].pod_indices) for gi in order}
        for _ in range(len(order) + 1):
            progress = False
            for gi in order:
                idxs = pending.get(gi)
                if not idxs:
                    continue
                group = groups[gi]
                # the last round's failures were provisional
                for i in idxs:
                    result.pod_errors.pop(pods[i].uid, None)
                # limits move as plans emit: masks per attempt
                with self._phase("limits"):
                    limit_masks = self._limit_masks(pools, encoded, remaining)
                info = self._choose_pool(
                    gi, group, pods, pools, encoded, ctx["sig_compats"], ctx["allowed_per_pool"],
                    result, idxs, limit_masks,
                )
                if info is None:
                    pending[gi] = []  # incompatibility is terminal
                    continue
                chosen = info["chosen"]
                pool, enc = pools[chosen], encoded[chosen]
                requests_matrix = ctx["matrices"][id(ctx["pool_entries"][chosen])][1]
                idx = np.asarray(info["indices"], dtype=np.int64)
                reqs = requests_matrix[idx]
                sort = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
                idx, reqs = idx[sort], reqs[sort]
                daemon = ctx["daemon_requests"][pool.nodepool.name]
                jobs: List[tuple] = []
                metas: List[dict] = []
                plans_start = len(result.node_plans)
                if group.tensor_pod_affinity() == wk.LABEL_TOPOLOGY_ZONE:
                    self._postpass_zone_affinity(
                        info, group, idx, reqs, enc, pool, daemon, pods, result, jobs, metas,
                        requests_matrix, remaining,
                    )
                else:
                    self._postpass_hostname_affinity(
                        info, group, idx, reqs, enc, pool, daemon, pods, result,
                        requests_matrix, remaining,
                    )
                if jobs:
                    records: List[dict] = []
                    self._pack_and_finalize(
                        jobs, metas, pods, result, records, merge_all=False, mesh=ctx.get("mesh")
                    )
                    with self._phase("merge"):
                        self._merge_and_emit(records, pods, result)
                if remaining:
                    # a limited pool: plans over the remaining budget are
                    # stripped and their pods fail (the pool is starved,
                    # a retry cannot help — scheduler.go:347-383)
                    with self._phase("limits"):
                        spilled = self._enforce_limits(result, plans_start, remaining, gi_of)
                    pool_name = pool.nodepool.name
                    for sidx in spilled.values():
                        for i in sidx:
                            result.pod_errors[pods[i].uid] = (
                                f'all available instance types exceed limits for nodepool: "{pool_name}"'
                            )
                failed = [i for i in idxs if pods[i].uid in result.pod_errors]
                if len(failed) < len(idxs):
                    progress = True
                pending[gi] = failed
            if not progress:
                break

    def _postpass_zone_affinity(
        self,
        info: dict,
        group: SignatureGroup,
        idx: np.ndarray,
        reqs: np.ndarray,
        enc: EncodedInstanceTypes,
        pool: PoolEncoding,
        daemon: np.ndarray,
        pods: List[Pod],
        result: SolverResult,
        jobs: List[tuple],
        metas: List[dict],
        requests_matrix: np.ndarray,
        remaining: Dict[str, dict],
    ) -> None:
        """Zone pod affinity against committed placements: the pods may
        go to any viable zone where every required term already counts a
        matching pod (per-term anchor sets intersected). A term with no
        anchor anywhere must be self-selecting and bootstraps: then the
        whole group lands in one zone, since its first placement anchors
        the empty terms there (topologygroup.go:215-232)."""
        terms = group.affinity_terms()
        zone_ok, ct_ok, viable = info["zone_ok"], info["ct_ok"], info["viable"]
        ctx = self._existing_ctx
        zones, zone_types = _viable_zones(enc, viable, zone_ok, ct_ok)

        def zone_price(z: str) -> float:
            zi = enc.zones.index(z)
            p = enc.offering_price[zone_types[z], zi, :][:, ct_ok]
            p = np.where(np.isfinite(p), p, np.inf)
            return float(p.min()) if p.size else np.inf

        own_labels = group.exemplar.metadata.labels
        anchored_sets: List[set] = []
        bootstrap_ok = True
        for term in terms:
            seeds = self._fold_committed(
                seed_counts_for_selector(
                    self.kube_client, group.exemplar, wk.LABEL_TOPOLOGY_ZONE, term.label_selector,
                    self._batch_uids,
                ),
                term.label_selector,
                group.exemplar.namespace,
                pods,
                result,
            )
            anchors_t = {z for z, v in seeds.items() if v > 0}
            if anchors_t:
                anchored_sets.append(anchors_t)
            elif term.label_selector is not None and not term.label_selector.matches(own_labels):
                bootstrap_ok = False  # an empty term the group cannot seed itself
        if not bootstrap_ok:
            for i in idx:
                result.pod_errors[pods[i].uid] = "pod affinity: no pod matches the affinity selector"
            return
        has_bootstrap_terms = len(anchored_sets) < len(terms)
        anchors: List[str] = []
        if anchored_sets:
            inter = set.intersection(*anchored_sets)
            anchors = [z for z in zones if z in inter]
            if not anchors:
                # matching pods exist, but no viable zone holds every term
                for i in idx:
                    result.pod_errors[pods[i].uid] = "pod affinity anchors are outside viable zones"
                return
            if has_bootstrap_terms:
                # the first placement seeds the empty terms in its zone;
                # the later pods must follow it there
                anchors = [min(anchors, key=zone_price)]
        if anchors:
            part = idx
            if ctx is not None:
                for z in anchors:
                    if not part.size:
                        break
                    part = self._pack_spread_existing(part, z, group, ctx, result)
            if part.size:
                # this solve's planned nodes in anchor zones take the pods
                # too (the oracle fills in-flight claims before opening
                # nodes, scheduler.go:241-246)
                anchor_plans = [p for p in result.node_plans if p.zone in anchors]
                if anchor_plans:
                    part = self._join_planned_nodes(
                        part, anchor_plans, info, enc, pool, daemon, pods, result,
                        requests_matrix, remaining,
                    )
            if part.size:
                sub = np.isin(idx, part)
                zmask = zone_ok & np.array([z in anchors for z in enc.zones], dtype=bool)
                v = viable & enc.offering_avail[:, zmask, :][:, :, ct_ok].any(axis=(1, 2))
                self._prepare_job(
                    idx[sub], reqs[sub], enc, v, zmask, ct_ok, daemon, info["max_per_node"], pool,
                    pods, result, jobs, metas, merged=info["merged"],
                )
            return
        if not group.affinity_self_selecting():
            # no matching pod anywhere, and only a self-selecting group
            # may seed its own domain
            for i in idx:
                result.pod_errors[pods[i].uid] = "pod affinity: no pod matches the affinity selector"
            return
        if not zones:
            for i in idx:
                result.pod_errors[pods[i].uid] = "no zone with viable offering for pod affinity"
            return
        # bootstrap one zone, the cheapest viable offering's (the oracle
        # takes any viable domain)
        z_star = min(zones, key=zone_price)
        part = idx
        if ctx is not None:
            part = self._pack_spread_existing(part, z_star, group, ctx, result)
        if part.size:
            star_plans = [p for p in result.node_plans if p.zone == z_star]
            if star_plans:
                part = self._join_planned_nodes(
                    part, star_plans, info, enc, pool, daemon, pods, result, requests_matrix,
                    remaining,
                )
        if part.size:
            sub = np.isin(idx, part)
            self._prepare_job(
                idx[sub], reqs[sub], enc, zone_types[z_star], zone_ok, ct_ok, daemon,
                info["max_per_node"], pool, pods, result, jobs, metas, zone=z_star,
                merged=info["merged"],
            )

    def _postpass_hostname_affinity(
        self,
        info: dict,
        group: SignatureGroup,
        idx: np.ndarray,
        reqs: np.ndarray,
        enc: EncodedInstanceTypes,
        pool: PoolEncoding,
        daemon: np.ndarray,
        pods: List[Pod],
        result: SolverResult,
        requests_matrix: np.ndarray,
        remaining: Dict[str, dict],
    ) -> None:
        """Hostname pod affinity against committed placements: anchors
        are existing nodes holding matching pods and this solve's planned
        nodes holding matching members (which grow their type to take
        joiners, as the oracle's in-flight claims re-narrow). With no
        anchor, a self-selecting group bootstraps one node and anyone
        else fails (topologygroup.go:215-232). Zone terms beside the
        hostname term narrow the anchors to the zones every zone term
        admits."""
        terms = group.affinity_terms()
        host_term = next(t for t in terms if t.topology_key == wk.LABEL_HOSTNAME)
        zone_terms = [t for t in terms if t.topology_key == wk.LABEL_TOPOLOGY_ZONE]
        ns = group.exemplar.namespace
        sel = host_term.label_selector
        ctx = self._existing_ctx
        own_labels = group.exemplar.metadata.labels
        zone_filter: Optional[set] = None
        zone_bootstrap = False
        for zt in zone_terms:
            zseeds = self._fold_committed(
                seed_counts_for_selector(
                    self.kube_client, group.exemplar, wk.LABEL_TOPOLOGY_ZONE, zt.label_selector,
                    self._batch_uids,
                ),
                zt.label_selector, ns, pods, result,
            )
            anchors_t = {z for z, v in zseeds.items() if v > 0}
            if anchors_t:
                zone_filter = anchors_t if zone_filter is None else (zone_filter & anchors_t)
            elif zt.label_selector is not None and not zt.label_selector.matches(own_labels):
                for i in idx:
                    result.pod_errors[pods[i].uid] = (
                        "pod affinity: no pod matches the affinity selector"
                    )
                return
            else:
                zone_bootstrap = True  # an empty zone term the group seeds
        if zone_filter is not None and not zone_filter:
            for i in idx:
                result.pod_errors[pods[i].uid] = "pod affinity anchors are outside viable zones"
            return
        seeds = seed_counts_for_selector(
            self.kube_client, group.exemplar, wk.LABEL_HOSTNAME, sel, self._batch_uids
        )
        # existing nodes that gained matching pods in this solve anchor too
        for eplan in result.existing_plans:
            if any(
                pods[i].namespace == ns and self._sel_matches(sel, i, pods)
                for i in eplan.pod_indices
            ):
                name = eplan.state_node.hostname() or eplan.state_node.name()
                seeds[name] = seeds.get(name, 0) + 1
        planned_anchors = [
            p
            for p in result.node_plans
            if self._plan_has_match(p, sel, ns, pods)
            and (zone_filter is None or p.zone in zone_filter)
        ]
        if zone_bootstrap and (seeds or planned_anchors):
            # an empty self-seeded zone term pins the group to the zone of
            # its first anchor (node order, then plan order: the oracle's
            # first fit)
            z_star = None
            if ctx is not None and seeds:
                for n, z in zip(ctx["nodes"], ctx["node_zones"]):
                    if (n.hostname() in seeds or n.name() in seeds) and (
                        zone_filter is None or z in zone_filter
                    ):
                        z_star = str(z)
                        break
            if z_star is None and planned_anchors:
                z_star = planned_anchors[0].zone
            if z_star is not None:
                zone_filter = {z_star}
                planned_anchors = [p for p in planned_anchors if p.zone == z_star]
        left = idx
        if seeds and ctx is not None and left.size:
            left = self._pack_affinity_hostname_existing(
                left, group, seeds, ctx, result, zone_filter=zone_filter
            )
        if planned_anchors and left.size:
            left = self._join_planned_nodes(
                left, planned_anchors, info, enc, pool, daemon, pods, result, requests_matrix,
                remaining,
            )
        if left.size and planned_anchors:
            # full anchors: the oracle's anchors take joiners while they
            # grow across many claims; the same outcome comes from moving
            # one matching pod off a full anchor plan onto a fresh node in
            # its zone and putting the joiners beside it
            left = self._reseed_anchor_nodes(
                left, planned_anchors, info, enc, pool, daemon, pods, result, requests_matrix,
                sel, ns, remaining,
            )
        if not left.size:
            return
        if not seeds and not planned_anchors:
            if group.affinity_self_selecting():
                binfo = info
                if zone_filter is not None:
                    zmask = info["zone_ok"] & np.array(
                        [z in zone_filter for z in enc.zones], dtype=bool
                    )
                    v = info["viable"] & enc.offering_avail[:, zmask, :][:, :, info["ct_ok"]].any(
                        axis=(1, 2)
                    )
                    if not v.any():
                        for i in left:
                            result.pod_errors[pods[i].uid] = (
                                "pod affinity anchors are outside viable zones"
                            )
                        return
                    binfo = dict(info, zone_ok=zmask, viable=v)
                sub = np.isin(idx, left)
                self._pack_affinity_hostname_new(
                    idx[sub], reqs[sub], enc, pool, daemon, binfo, pods, result
                )
                return
            for i in left:
                result.pod_errors[pods[i].uid] = "pod affinity: no pod matches the affinity selector"
            return
        # anchors exist but are full: a fresh node is a zero-count domain
        for i in left:
            result.pod_errors[pods[i].uid] = "pod affinity on hostname: anchor nodes are full"

    def _join_types(
        self,
        plan: NodePlan,
        merged,
        zi: int,
        ci: int,
        viable: np.ndarray,
        enc: EncodedInstanceTypes,
        pin: bool,
    ) -> tuple:
        """Catalog indices of the types a node holding ``plan``'s pods
        and pods of requirements ``merged`` may take at offering (zi, ci),
        cached per solve. ``pin`` (joins) adds the plan's zone and
        capacity type to the combined requirements and first checks the
        joiner against them; a reseed's fresh node skips both."""
        key = (plan.requirements.fingerprint(), merged.fingerprint(), zi, ci, viable.tobytes())
        cached = self._join_types_cache.get(key)
        if cached is not None:
            return cached
        combined = Requirements(*plan.requirements.values_list())
        combined.add(*merged.values_list())
        if pin:
            combined.add(
                Requirement(wk.LABEL_TOPOLOGY_ZONE, OP_IN, [plan.zone]),
                Requirement(wk.CAPACITY_TYPE_LABEL_KEY, OP_IN, [plan.capacity_type]),
            )
        if pin and merged.compatible(combined, ALLOW_UNDEFINED_WELL_KNOWN_LABELS, hint=False) is not None:
            cached = ()
        else:
            tmask = viable & enc.offering_avail[:, zi, ci]
            cached = tuple(
                int(t)
                for t in np.flatnonzero(tmask)
                if combined.compatible(
                    enc.instance_types[t].requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS, hint=False
                )
                is None
            )
        self._join_types_cache[key] = cached
        return cached

    @staticmethod
    def _prefix_fit(usage: np.ndarray, jreqs: np.ndarray, alloc: np.ndarray) -> Tuple[int, np.ndarray]:
        """Longest prefix of ``jreqs`` that some row of ``alloc`` holds on
        top of ``usage`` → (its length, the cumulative loads)."""
        cum = usage[None, :] + np.cumsum(jreqs, axis=0)
        fits_any = (cum[:, None, :] <= alloc[None, :, :]).all(-1).any(1)
        n_fit = int(fits_any.sum()) if fits_any.all() else int(np.argmin(fits_any))
        return n_fit, cum

    def _reseed_anchor_nodes(
        self,
        left: np.ndarray,
        plans: List[NodePlan],
        info: dict,
        enc: EncodedInstanceTypes,
        pool: PoolEncoding,
        daemon: np.ndarray,
        pods: List[Pod],
        result: SolverResult,
        requests_matrix: np.ndarray,
        sel,
        ns: str,
        remaining: Dict[str, dict],
    ) -> np.ndarray:
        """Seed fresh anchor nodes for hostname-affinity leftovers: take
        one selector-matching pod from a full anchor plan that holds more
        than one, open a new node in the same zone and capacity type with
        it, and first-fit the leftovers there. Zones do not change, so
        every committed zone count and zone constraint holds. Mutates the
        donor plan in place, as the JAX package does, and records both
        plans in ``self._reseeded`` for the post-pass's fixpoint check.
        Under ``self._reseed_guard`` (the post-pass's second run) it
        moves no pod whose own hostname affinity, or that of a pod it
        anchors, the move would break (_donor_movable)."""
        merged = info["merged"]
        viable = info["viable"]
        joiner = info["group"].exemplar
        alloc = self._alloc_full(enc, daemon)
        # worklist: a fresh node whose joiners also match the selector
        # (self-selecting groups) becomes a donor itself
        worklist = sorted(plans, key=lambda p: -len(p.pod_indices))
        wi = 0
        while wi < len(worklist):
            donor_plan = worklist[wi]
            wi += 1
            if not left.size:
                break
            if donor_plan.max_pods_per_node < MAX_INT32 or donor_plan.node_limits:
                continue
            if donor_plan.nodepool_name != pool.nodepool.name:
                continue
            if donor_plan.requirements is None or merged is None:
                continue
            if donor_plan.requirements.intersects(merged) is not None:
                continue
            if donor_plan.zone not in enc.zones or donor_plan.capacity_type not in enc.capacity_types:
                continue
            zi = enc.zones.index(donor_plan.zone)
            ci = enc.capacity_types.index(donor_plan.capacity_type)
            if not (info["zone_ok"][zi] and info["ct_ok"][ci]):
                continue
            matching = [
                i
                for i in donor_plan.pod_indices
                if pods[i].namespace == ns and self._sel_matches(sel, i, pods)
            ]
            if len(matching) < 2:
                continue  # the donor keeps an anchor of its own
            while left.size and len(matching) > 1:
                donor = next(
                    (
                        i
                        for i in reversed(matching)
                        if not self._reseed_guard or self._donor_movable(i, donor_plan, joiner, pods)
                    ),
                    None,
                )
                if donor is None:
                    break
                matching.remove(donor)
                # the new node carries the donor too: its types must
                # satisfy both sides' requirements
                t_idx = np.array(
                    self._join_types(donor_plan, merged, zi, ci, viable, enc, pin=False),
                    dtype=np.int64,
                )
                if t_idx.size == 0:
                    return left
                usage = requests_matrix[[donor]].astype(np.int64).sum(axis=0)
                n_fit, cum = self._prefix_fit(
                    usage, requests_matrix[left].astype(np.int64), alloc[t_idx]
                )
                if n_fit == 0:
                    matching.append(donor)
                    break
                fits = (cum[n_fit - 1][None, :] <= alloc[t_idx]).all(axis=1)
                prices = enc.offering_price[t_idx, zi, ci]
                prices = np.where(fits & np.isfinite(prices), prices, np.inf)
                t_local = int(np.argmin(prices))
                if not np.isfinite(prices[t_local]):
                    matching.append(donor)
                    break
                t = int(t_idx[t_local])
                rem = remaining.get(pool.nodepool.name) if remaining else None
                if rem is not None:
                    cap = enc.instance_types[t].capacity
                    if any(v > rem.get(name, 0) for name, v in cap.items() if v > 0):
                        matching.append(donor)
                        break  # no limit headroom for another node
                    remaining[pool.nodepool.name] = resources.subtract(rem, cap)
                # detach the donor (same zone, so the committed counts
                # hold; the plan's match cache forgets the shrunk plan)
                pos = donor_plan.pod_indices.index(donor)
                donor_plan.pod_indices.pop(pos)
                if donor_plan._pod_requests is not None:
                    donor_plan._pod_requests.pop(pos)
                donor_plan._requests = None
                pid = id(donor_plan)
                self._plan_match_cache = {
                    k: v for k, v in self._plan_match_cache.items() if k[1] != pid
                }
                members = [int(donor)] + [int(i) for i in left[:n_fit]]
                combined = Requirements(*donor_plan.requirements.values_list())
                combined.add(*merged.values_list())
                # its limits are charged above: the post-pass enforcement
                # must not subtract or strip it again
                new_plan = NodePlan(
                    nodepool_name=pool.nodepool.name,
                    instance_type=enc.instance_types[t],
                    zone=donor_plan.zone,
                    capacity_type=donor_plan.capacity_type,
                    price=float(enc.offering_price[t, zi, ci]),
                    pod_indices=members,
                    requirements=combined,
                    _pod_requests=[self._all_requests[i] for i in members],
                    _limits_accounted=True,
                )
                result.node_plans.append(new_plan)
                worklist.append(new_plan)
                self._reseeded += (donor_plan, new_plan)
                # the donor is already counted in this zone; only the
                # joiners are new to the committed counters
                for st in self._fold_cache.values():
                    st["sizes"][id(new_plan)] = 1
                left = left[n_fit:]
        return left

    @staticmethod
    def _donor_movable(donor: int, plan: NodePlan, joiner: Pod, pods: List[Pod]) -> bool:
        """Whether moving ``donor`` off ``plan`` onto a fresh node beside
        pods like ``joiner`` keeps every required hostname pod affinity:
        each of the donor's own terms must match the donor or the
        joiners, and each term of another member that the donor matches
        must still match a pod left on the plan. (The JAX package's
        reseed moves donors unchecked and can strand a pod away from
        every pod its hostname term selects; bench config 6 does so.)"""
        d = pods[donor]
        for t in _hostname_affinity_terms(d):
            if not (
                t.label_selector.matches(d.metadata.labels)
                or (joiner.namespace == d.namespace and t.label_selector.matches(joiner.metadata.labels))
            ):
                return False
        for m in plan.pod_indices:
            if m == donor:
                continue
            ns = pods[m].namespace
            for t in _hostname_affinity_terms(pods[m]):
                if d.namespace != ns or not t.label_selector.matches(d.metadata.labels):
                    continue
                if not any(
                    j != donor and pods[j].namespace == ns and t.label_selector.matches(pods[j].metadata.labels)
                    for j in plan.pod_indices
                ):
                    return False
        return True

    def _join_planned_nodes(
        self,
        left: np.ndarray,
        plans: List[NodePlan],
        info: dict,
        enc: EncodedInstanceTypes,
        pool: PoolEncoding,
        daemon: np.ndarray,
        pods: List[Pod],
        result: SolverResult,
        requests_matrix: np.ndarray,
        remaining: Optional[Dict[str, dict]] = None,
    ) -> np.ndarray:
        """First-fit ``left`` (descending by size) onto this solve's
        planned anchor nodes, growing each node's instance type within
        the commonly viable set — pods joining an in-flight NodeClaim
        whose instance options re-narrow (scheduler.go:241-246). Mutates
        the joined plans in place, as the JAX package does. Returns the
        indices no anchor could take."""
        merged = info["merged"]
        viable = info["viable"]
        alloc = self._alloc_full(enc, daemon)
        for plan in plans:
            if not left.size:
                break
            if plan.max_pods_per_node < MAX_INT32 or plan.node_limits:
                continue  # capped or limited nodes never take joiners
            if plan.nodepool_name != pool.nodepool.name:
                continue
            if plan.requirements is None or merged is None:
                continue
            if plan.requirements.intersects(merged) is not None:
                continue
            if plan.zone not in enc.zones or plan.capacity_type not in enc.capacity_types:
                continue
            zi = enc.zones.index(plan.zone)
            ci = enc.capacity_types.index(plan.capacity_type)
            # the joiner's own zone and capacity type must admit the
            # plan's pinned offering
            if not (info["zone_ok"][zi] and info["ct_ok"][ci]):
                continue
            cached = self._join_types(plan, merged, zi, ci, viable, enc, pin=True)
            if not cached:
                continue
            t_idx = np.array(cached, dtype=np.int64)
            usage = requests_matrix[plan.pod_indices].astype(np.int64).sum(axis=0)
            n_fit, cum = self._prefix_fit(usage, requests_matrix[left].astype(np.int64), alloc[t_idx])
            if n_fit == 0:
                continue
            fits = (cum[n_fit - 1][None, :] <= alloc[t_idx]).all(axis=1)
            prices = enc.offering_price[t_idx, zi, ci]
            prices = np.where(fits & np.isfinite(prices), prices, np.inf)
            t_local = int(np.argmin(prices))
            if not np.isfinite(prices[t_local]):
                continue
            t = int(t_idx[t_local])
            it_new = enc.instance_types[t]
            rem = remaining.get(plan.nodepool_name) if remaining else None
            if rem is not None and it_new is not plan.instance_type:
                # growing the node takes the capacity delta from the limit
                delta = resources.subtract(it_new.capacity, plan.instance_type.capacity)
                if any(v > rem.get(name, 0) for name, v in delta.items() if v > 0):
                    continue
                remaining[plan.nodepool_name] = resources.subtract(rem, delta)
            members = left[:n_fit].tolist()
            plan.pod_indices.extend(int(i) for i in members)
            plan.instance_type = it_new
            plan.price = float(enc.offering_price[t, zi, ci])
            combined = Requirements(*plan.requirements.values_list())
            combined.add(*merged.values_list())
            plan.requirements = combined
            if plan._pod_requests is not None:
                plan._pod_requests.extend(self._all_requests[int(i)] for i in members)
            plan._requests = None
            left = left[n_fit:]
        return left

    def _pack_affinity_hostname_existing(
        self,
        idx: np.ndarray,
        group: SignatureGroup,
        seeds: Dict[str, int],
        ctx: dict,
        result: SolverResult,
        zone_filter: Optional[set] = None,
    ) -> np.ndarray:
        """First-fit the group onto the existing nodes already holding a
        matching pod (the only admissible domains once anchors exist),
        within ``zone_filter`` when the group's zone terms narrow it, on
        the native first-fit."""
        row = self._existing_compat_row(group, ctx).astype(bool)
        anchor = np.array([n.hostname() in seeds or n.name() in seeds for n in ctx["nodes"]])
        mask = row & anchor
        if zone_filter is not None:
            mask &= np.isin(ctx["node_zones"], sorted(zone_filter))
        if not mask.any():
            return idx
        reqs = build_requests_matrix_ids(self._req_ids[idx], ctx["axis"], self._req_map)
        assign, free_out = run_pack_existing(
            reqs, np.zeros(len(idx), dtype=np.int32), mask[None, :].astype(np.uint8), ctx["free"],
            device=self.device,
        )
        ctx["free"] = np.ascontiguousarray(free_out, dtype=np.int32)
        placed = assign >= 0
        by_node: Dict[int, List[int]] = {}
        for j in np.flatnonzero(placed):
            by_node.setdefault(int(assign[j]), []).append(int(idx[j]))
        for mnode in sorted(by_node):
            result.existing_plans.append(
                ExistingNodePlan(state_node=ctx["nodes"][mnode], pod_indices=by_node[mnode])
            )
        return idx[~placed]

    def _pack_affinity_hostname_new(
        self,
        idx: np.ndarray,
        reqs: np.ndarray,
        enc: EncodedInstanceTypes,
        pool: PoolEncoding,
        daemon: np.ndarray,
        m: dict,
        pods: List[Pod],
        result: SolverResult,
    ) -> None:
        """Bootstrap one co-located node: the longest size-descending
        prefix some viable type holds becomes one NodePlan, the rest fail
        (a second node would be a zero-count hostname domain the pods
        cannot join, as in the oracle)."""
        viable_idx = np.flatnonzero(m["viable"])
        if len(viable_idx) == 0:
            for i in idx:
                result.pod_errors[pods[i].uid] = "no viable instance type"
            return
        alloc = self._alloc_full(enc, daemon)[viable_idx]
        n_fit, cum = self._prefix_fit(np.zeros(reqs.shape[1], dtype=np.int64), reqs.astype(np.int64), alloc)
        if n_fit == 0:
            for i in idx:
                result.pod_errors[pods[i].uid] = "no instance type fits the first co-located pod"
            return
        fits = (cum[n_fit - 1][None, :] <= alloc).all(axis=1)
        zone_ok, ct_ok = m["zone_ok"], m["ct_ok"]
        prices = enc.offering_price[viable_idx][:, zone_ok, :][:, :, ct_ok].reshape(len(viable_idx), -1)
        p = (
            np.where(np.isfinite(prices), prices, np.inf).min(axis=1)
            if prices.size
            else np.full(len(viable_idx), np.inf)
        )
        p = np.where(fits, p, np.inf)
        t_local = int(np.argmin(p))
        if not np.isfinite(p[t_local]):
            for i in idx:
                result.pod_errors[pods[i].uid] = "packed node has no fitting instance type"
            return
        t = int(viable_idx[t_local])
        offering_zone, offering_ct, offering_price = self._cheapest_offering(enc, t, zone_ok, ct_ok, None)
        members = idx[:n_fit].tolist()
        result.node_plans.append(
            NodePlan(
                nodepool_name=pool.nodepool.name,
                instance_type=enc.instance_types[t],
                zone=offering_zone,
                capacity_type=offering_ct,
                price=offering_price,
                pod_indices=members,
                requirements=m["merged"],
                _pod_requests=[self._all_requests[i] for i in members],
            )
        )
        for i in idx[n_fit:]:
            result.pod_errors[pods[i].uid] = "pod affinity on hostname: co-located node is full"

    # ------------------------------------------------------------------

    def _prepare_job(
        self,
        idx: np.ndarray,
        reqs: np.ndarray,
        enc: EncodedInstanceTypes,
        viable: np.ndarray,
        zone_ok: np.ndarray,
        ct_ok: np.ndarray,
        daemon: np.ndarray,
        max_per_node,
        pool: PoolEncoding,
        pods: List[Pod],
        result: SolverResult,
        jobs: List[tuple],
        metas: List[dict],
        zone: Optional[str] = None,
        merged=None,
        per_node_limits: Optional[list] = None,
        no_merge: bool = False,
        pod_ports: Optional[Dict[int, tuple]] = None,
    ) -> None:
        """One pack job (requests, frontier, per-node pod cap) and its
        finalize meta. Host-port feature columns are appended to the
        job's requests, and the fresh-node port capacities tiled onto
        every frontier row (constant columns keep the frontier's
        dominance), so the packer enforces port conflicts; meta["reqs"]
        and meta["alloc"] stay resource-only, so finalize prices and
        usage never see the port columns."""
        viable_idx = np.flatnonzero(viable)
        if len(viable_idx) == 0:
            for i in idx:
                result.pod_errors[pods[i].uid] = "no viable instance type"
            return
        # stable name-rank order on the viable axis: every price argmin
        # over it resolves exact ties to the same instance type
        viable_idx = _rank_order(viable_idx, _type_rank(enc))
        alloc = self._alloc_full(enc, daemon)[viable_idx].astype(np.int32)
        cache_key = ("frontier", viable_idx.tobytes(), daemon.tobytes())
        frontier = enc.runtime_caches.get(cache_key)
        if frontier is None:
            frontier = pareto_frontier(alloc)
            _cache_put(enc, cache_key, frontier)
        job_reqs, job_frontier = reqs, frontier
        port_features: tuple = ()
        port_sets = None
        if pod_ports:
            sets = [pod_ports.get(int(i), ()) for i in idx]
            if any(sets):
                feats = PortFeatures(sets)
                port_sets = sets
                port_features = tuple(feats.features)
                job_reqs = np.ascontiguousarray(
                    np.hstack([reqs, feats.load_matrix(sets)]), dtype=np.int32
                )
                job_frontier = np.ascontiguousarray(
                    np.hstack([frontier, np.tile(feats.caps, (frontier.shape[0], 1))]),
                    dtype=np.int32,
                )
        jobs.append((job_reqs, job_frontier, np.int32(max_per_node)))
        metas.append(
            dict(
                idx=idx,
                reqs=reqs,
                enc=enc,
                viable_idx=viable_idx,
                alloc=alloc,
                zone_ok=zone_ok,
                ct_ok=ct_ok,
                pool=pool,
                zone=zone,
                daemon=daemon,
                max_per_node=int(max_per_node),
                merged=merged,
                per_node_limits=per_node_limits or [],
                no_merge=no_merge,
                port_features=port_features,
                pod_port_sets=port_sets,
            )
        )

    def _pack_and_finalize(
        self,
        jobs: List[tuple],
        metas: List[dict],
        pods: List[Pod],
        result: SolverResult,
        records: List[dict],
        merge_all: Optional[bool] = None,
        mesh=None,
    ) -> None:
        """Pack and finalize one job batch through the cross-tick job memo:
        a job whose content-addressed key hits reuses its finalize
        skeleton (no pack dispatch: no packer call, no scan launch, no
        upload) and only rebinds node memberships to this tick's batch
        indices. The misses go through the active pack backend (ffd | lp
        | auto, ``KARPENTER_TORCH_PACK_BACKEND``) exactly as a cold solve
        sends them, and fill the memo. Emission follows the metas order
        either way, so warm and cold solves build identical plan and
        record streams. ``mesh``: the encode phase's active mesh
        (``sharding.active_mesh``), which the packs shard over and every
        job key carries."""
        backend = backends.active_backend()
        ws = self._warm
        plane = self.fleet_plane
        keys: List[Optional[tuple]] = [None] * len(jobs)
        skels: List[Optional[JobSkeleton]] = [None] * len(jobs)
        if ws is not None and jobs:
            with tracer.span("pack.cache.lookup", jobs=len(jobs)):
                for i, (job, meta) in enumerate(zip(jobs, metas)):
                    keys[i] = key = self._job_key(job, meta, mesh, backend)
                    if key is not None:
                        skels[i] = ws.jobs.get(key, self._cstats)
                        if skels[i] is None and plane is not None:
                            # the key less its trailing tenant scope is pure
                            # content (the device among it): a skeleton
                            # another tenant computed for the same content
                            # is this job's skeleton
                            skels[i] = plane.skeleton_get(key[:-1], self._cstats)
        miss = [i for i in range(len(jobs)) if skels[i] is None]
        # what a pack backend reads of a job's meta, and nothing else
        miss_metas = [
            dict(
                alloc=metas[i]["alloc"],
                enc=metas[i]["enc"],
                viable_idx=metas[i]["viable_idx"],
                zone_ok=metas[i]["zone_ok"],
                ct_ok=metas[i]["ct_ok"],
                zone=metas[i]["zone"],
            )
            for i in miss
        ]
        with self._phase("pack"):
            # backend.lock spans the call and the reads of its per-call
            # outputs: a concurrent solve on the shared singleton must not
            # overwrite last_stats/last_job_flags between them
            with backend.lock:
                packed = (
                    # analysis: allow-wait-under-lock(device — backend.lock exists to serialize this dispatch and its output reads; the solver holds no other lock here, so the edge cannot deadlock)
                    backend.pack_jobs(
                        [jobs[i] for i in miss], miss_metas, device=self.device,
                        stats=self._cstats, mesh=mesh,
                    )
                    if miss
                    else []
                )
                self._observe_pack_backend(backend, bool(miss))
                # True where the LP partition won: those jobs' merge
                # records are cost-guarded
                flags = list(getattr(backend, "last_job_flags", ()) or ())
        if len(flags) != len(miss):
            flags = [False] * len(miss)
        if merge_all is None:
            # small plans: every node joins the merge pass (the oracle
            # back-fills leftover space on full nodes too); large plans:
            # only underfull tails
            total_nodes = 0
            mi = 0
            for i in range(len(jobs)):
                if skels[i] is not None:
                    total_nodes += skels[i].node_count
                else:
                    total_nodes += int(packed[mi][1])
                    mi += 1
            merge_all = total_nodes <= 256
        with self._phase("finalize"):
            mi = 0
            for i, meta in enumerate(metas):
                skel = skels[i]
                if skel is None:
                    node_ids, node_count = packed[mi]
                    skel = self._job_skeleton(meta, node_ids, int(node_count), cost_guard=flags[mi])
                    mi += 1
                    if keys[i] is not None:
                        # analysis: allow-cache-key(metas.reqs, metas.alloc, self._pack_backend_stats, self.fleet_plane, self.metrics) — reqs rides the key as its job_digest and alloc is _alloc_full(enc, daemon)[viable], all keyed; the rest is telemetry and the content plane (keyed by this key less its tenant scope)
                        ws.jobs.put(keys[i], skel, self._cstats)
                        if plane is not None:
                            # analysis: allow-cache-key(metas.reqs, metas.alloc, self._pack_backend_stats, self.fleet_plane, self.metrics) — as the put above: the tenant scope is not in the skeleton's read-set
                            plane.skeleton_put(keys[i][:-1], skel, self._cstats)
                self._emit_skeleton(meta, skel, keys[i], pods, result, records, merge_all)

    def _observe_pack_backend(self, backend, dispatched: bool) -> None:
        """The pack backend's per-call outcome (LP guard wins, relaxation
        bound sum, refinement and branch counters) summed into this
        solve's ``last_pack_stats``."""
        stats = getattr(backend, "last_stats", None) if dispatched else None
        acc = self._pack_backend_stats
        acc["backend"] = backend.name
        if not stats:
            return
        for k in (
            "jobs", "lp_won", "ffd_kept", "ffd_kept_cold", "ffd_kept_refined", "refine_rounds",
            "refine_accepted", "branches_considered", "branches_pruned", "branches_explored",
            "branches_won", "ascent_iters",
        ):
            if k in stats:
                acc[k] = acc.get(k, 0) + int(stats[k])
        for k in ("lp_bound_sum", "lp_saved_per_hr"):
            if k in stats:
                acc[k] = round(acc.get(k, 0.0) + float(stats[k]), 6)
        if self.metrics is not None:
            self._observe_lp_outcomes(stats)

    def _observe_lp_outcomes(self, stats: dict) -> None:
        """The LP guard's outcome per job (won, or FFD kept before or
        after the refinement tier) and the branch outcomes of one pack
        call, as the JAX package counts them."""
        jobs = self.metrics.solver_lp_jobs
        if stats.get("lp_won"):
            jobs.inc(stats["lp_won"], outcome="lp_won")
        cold = int(stats.get("ffd_kept_cold", 0))
        refined = int(stats.get("ffd_kept_refined", 0))
        if cold:
            jobs.inc(cold, outcome="ffd_kept_cold")
        if refined:
            jobs.inc(refined, outcome="ffd_kept_refined")
        if stats.get("ffd_kept") and not (cold or refined):
            jobs.inc(stats["ffd_kept"], outcome="ffd_kept")
        for outcome in ("pruned", "explored", "won"):
            v = int(stats.get(f"branches_{outcome}", 0))
            if v:
                self.metrics.solver_lp_branches.inc(v, outcome=outcome)

    def _job_key(self, job: tuple, meta: dict, mesh=None, backend=None) -> Optional[tuple]:
        """Content address of one pack job: every input the pack and the
        finalize read. Equal keys give identical skeletons (the
        computation is deterministic), which keeps warm solves
        plan-identical to cold ones. The host-port feature labels are in
        it because two port universes can give byte-identical request
        matrices (TCP:80 and TCP:81 wildcard columns); the engine token
        with ``mesh``'s chunk configuration and the backend token because
        two engines or backends may partition equal inputs differently; the
        device because the entry is shared by every device's solvers, and
        the fleet's content plane is keyed by everything but the tenant
        scope, which comes last, by the JAX package's contract."""
        # analysis: allow-cache-determinism(id) — a per-solve map from the live encoding object to its content key; never persisted
        enc_key = self._enc_keys.get(id(meta["enc"]))
        if enc_key is None or self._warm is None:
            return None
        pool_fp = self._pool_fp_by_name.get(meta["pool"].nodepool.name)
        if pool_fp is None:
            return None
        reqs, _frontier, mpn = job
        merged = meta["merged"]
        limits_key = tuple(
            (self._sel_fp(sel) if sel is not None else None, ns, int(cap))
            for sel, ns, cap in meta["per_node_limits"] or ()
        )
        return (
            enc_key,
            pool_fp,
            meta["zone"],
            incremental.job_digest(reqs),
            meta["viable_idx"].tobytes(),
            np.asarray(meta["zone_ok"]).tobytes(),
            np.asarray(meta["ct_ok"]).tobytes(),
            meta["daemon"].tobytes(),
            int(mpn),
            merged.fingerprint() if merged is not None else None,
            limits_key,
            bool(meta["no_merge"]),
            tuple(meta["port_features"] or ()),
            incremental.pack_engine_token(mesh),
            backend.job_token(self.device) if backend is not None else ("ffd",),
            str(self.device),
            self._tenant_scope,
        )

    def _job_skeleton(
        self, meta: dict, node_ids: np.ndarray, node_count: int, cost_guard: bool = False
    ) -> JobSkeleton:
        """The finalize computation for one packed job, positional over
        the job's size-sorted pod order."""
        reqs, enc = meta["reqs"], meta["enc"]
        viable_idx, alloc = meta["viable_idx"], meta["alloc"]
        node_ids = np.asarray(node_ids)
        unsched = np.flatnonzero(node_ids < 0)
        R = reqs.shape[1]
        if node_count == 0:
            z = np.zeros(0, dtype=np.int64)
            return JobSkeleton(
                0, z, np.zeros(1, dtype=np.int64), unsched,
                np.zeros(0, dtype=bool), np.zeros(0, dtype=bool),
                np.zeros((0, R), dtype=np.int64),
                alloc.max(axis=0) if alloc.size else np.zeros(R, np.int32),
                z, z, [], [], np.zeros(0), cost_guard,
            )
        usage = node_usage_from_assignment(reqs, node_ids, node_count)
        chosen_types = assign_cheapest_types(usage, alloc, _job_prices(meta))
        # underfull ⇔ half the elementwise-max viable allocatable still
        # holds the load — those tail nodes go to the merge pass
        alloc_cap = alloc.max(axis=0)
        valid = node_ids >= 0
        vpos = np.flatnonzero(valid)
        order = np.argsort(node_ids[valid], kind="stable")
        positions = vpos[order]
        sorted_ids = node_ids[valid][order]
        bounds = np.searchsorted(sorted_ids, np.arange(node_count + 1))
        usage64 = usage.astype(np.int64)
        ok = chosen_types >= 0
        underfull = np.all(usage64 * 2 <= alloc_cap.astype(np.int64)[None, :], axis=1)
        if cost_guard:
            # LP-chosen partitions: a node is a merge candidate only when
            # it is underfull for its chosen type — the LP sizes nodes for
            # cheap small types, and fullness against the biggest viable
            # type would send every such node through a merge the cost
            # guard then rejects pair by pair
            chosen_alloc = alloc[np.maximum(chosen_types, 0)].astype(np.int64)
            underfull = ok & np.all(usage64 * 2 <= chosen_alloc, axis=1)
        ok_nodes = np.flatnonzero(ok)
        ok_ord = np.full(node_count, -1, dtype=np.int64)
        ok_ord[ok_nodes] = np.arange(ok_nodes.size)
        if ok_nodes.size:
            t_global = viable_idx[chosen_types[ok_nodes]]
            off_zone, off_ct, off_price = self._cheapest_offering_batch(
                enc, t_global, meta["zone_ok"], meta["ct_ok"], meta["zone"]
            )
        else:
            t_global = np.zeros(0, dtype=np.int64)
            off_zone, off_ct, off_price = [], [], np.zeros(0)
        return JobSkeleton(
            node_count=int(node_count),
            positions=positions,
            bounds=bounds,
            unsched=unsched,
            ok=ok,
            underfull=underfull,
            usage64=usage64,
            alloc_cap=alloc_cap,
            ok_ord=ok_ord,
            t_global=t_global,
            off_zone=off_zone,
            off_ct=off_ct,
            off_price=off_price,
            cost_guard=bool(cost_guard),
        )

    def _emit_skeleton(
        self,
        meta: dict,
        skel: JobSkeleton,
        key: Optional[tuple],
        pods: List[Pod],
        result: SolverResult,
        records: List[dict],
        merge_all: bool,
    ) -> None:
        """Rebind one job skeleton to this tick's batch: positional node
        memberships become pod indices, plan nodes emit NodePlans and
        underfull tails become merge records, carrying their record
        identity ``_rkey`` (job key, node ordinal) when the job is
        memoized. Capped and limited groups merge too: the merge check
        enforces each side's per-node limits on the combined membership.
        Only no_merge jobs (zone self-anti-affinity) stay out of the
        merge."""
        idx, enc = meta["idx"], meta["enc"]
        for i in idx[skel.unsched]:
            result.pod_errors[pods[i].uid] = (
                "no instance type satisfied resources and requirements (tensor path)"
            )
        if skel.node_count == 0:
            return
        viable_bool = np.zeros(len(enc.instance_types), dtype=bool)
        viable_bool[meta["viable_idx"]] = True
        if meta["no_merge"]:
            to_record = np.zeros(skel.node_count, dtype=bool)
        elif merge_all and not skel.cost_guard:
            to_record = skel.ok.copy()
        else:
            to_record = skel.ok & skel.underfull
        # records of one job share its per-job arrays and lists (the
        # merge engines replace, never mutate, record entries)
        job_limits = list(meta["per_node_limits"])
        max_per_node = meta["max_per_node"]
        pool, zone = meta["pool"], meta["zone"]
        port_sets = meta["pod_port_sets"]
        positions, bounds = skel.positions, skel.bounds
        for n in range(skel.node_count):
            pos_slice = positions[bounds[n] : bounds[n + 1]]
            members = idx[pos_slice].tolist()
            if not skel.ok[n]:
                for i in members:
                    result.pod_errors[pods[i].uid] = "packed node has no fitting instance type"
                continue
            if to_record[n]:
                rec = dict(
                    enc=enc,
                    pool=pool,
                    zone=zone,
                    zone_ok=meta["zone_ok"],
                    ct_ok=meta["ct_ok"],
                    viable=viable_bool,
                    usage=skel.usage64[n],
                    members=members,
                    daemon=meta["daemon"],
                    alloc_cap=skel.alloc_cap,
                    merged=meta["merged"],
                    max_per_node=max_per_node,
                    limits=job_limits,
                )
                if port_sets is not None:
                    # the node's reserved ports ride the record, so the
                    # merge can reject conflicting combinations
                    node_ports = sorted({t for p in pos_slice for t in port_sets[int(p)]})
                    if node_ports:
                        rec["ports"] = tuple(node_ports)
                if skel.cost_guard:
                    rec["_cost_guard"] = True
                if key is not None:
                    rec["_rkey"] = (key, n)
                records.append(rec)
                continue
            o = int(skel.ok_ord[n])
            result.node_plans.append(
                NodePlan(
                    nodepool_name=pool.nodepool.name,
                    instance_type=enc.instance_types[int(skel.t_global[o])],
                    zone=skel.off_zone[o],
                    capacity_type=skel.off_ct[o],
                    price=float(skel.off_price[o]),
                    pod_indices=members,
                    requirements=meta["merged"],
                    max_pods_per_node=int(max_per_node),
                    node_limits=list(job_limits),
                    _pod_requests=[self._all_requests[i] for i in members],
                )
            )

    # ------------------------------------------------------------------

    _MERGE_SCAN_CAP = 64  # K-open bound on the first-fit merge scan

    def _alloc_full(self, enc: EncodedInstanceTypes, daemon: np.ndarray) -> np.ndarray:
        """(T, R_ext) daemon-adjusted allocatable over the whole catalog
        (cached on the encoding)."""
        key = ("alloc", daemon.tobytes())
        cached = enc.runtime_caches.get(key)
        if cached is not None:
            return cached
        alloc = enc.allocatable.astype(np.int64)
        if alloc.shape[1] < daemon.shape[0]:
            alloc = np.concatenate(
                [alloc, np.zeros((alloc.shape[0], daemon.shape[0] - alloc.shape[1]), np.int64)],
                axis=1,
            )
        alloc = np.maximum(alloc - daemon[None, :].astype(np.int64), 0)
        _cache_put(enc, key, alloc)
        return alloc

    def _merge_and_emit(self, records: List[dict], pods: List[Pod], result: SolverResult) -> None:
        """Greedy first-fit merge of underfull planned nodes across
        signature groups (merge.py's vector engine), then emit. A merge
        is legal when the nodes share a pool, the intersected zone/
        capacity-type masks stay nonempty, and some commonly-viable type
        holds the combined load with an available offering.

        Through the cross-tick merge memo: when every record carries its
        identity (job key, node ordinal), the pass is a deterministic
        function of the identified stream, and a hit replays the recorded
        absorption trails and emitted offerings. A cluster whose trail
        the emit memo holds takes its recorded offering."""
        if not records:
            return
        t0 = time.perf_counter()
        st = self._merge_stats
        ws = self._warm
        mkey = None
        if ws is not None and all("_rkey" in r for r in records):
            mkey = ("vector", int(self._MERGE_SCAN_CAP), tuple(r["_rkey"] for r in records))
            skel = ws.merges.get(mkey, self._cstats)
            if skel is not None:
                with tracer.span("pack.cache.merge_replay", plans=len(skel.clusters)):
                    self._replay_merge(skel, records, pods, result)
                st["merge_engine"] = "vector"
                st["merge_records"] = st.get("merge_records", 0) + len(records)
                st["merge_pairs_applied"] = st.get("merge_pairs_applied", 0) + skel.applied
                st["merge_ms"] = st.get("merge_ms", 0.0) + (time.perf_counter() - t0) * 1000.0
                return
        applied_before = st.get("merge_pairs_applied", 0)
        records.sort(key=lambda r: -int(r["usage"][0]))
        merged = merge_records_vector(self, records, pods, self._MERGE_SCAN_CAP)
        trails = self._merge_trails(merged, records) if ws is not None else None
        clusters: Optional[list] = [] if mkey is not None and trails is not None else None
        for ci, m in enumerate(merged):
            trail = trails[ci] if trails is not None else None
            emitted = ws.emits.get(trail, self._cstats) if trail is not None else None
            if emitted is not None:
                self._emit_from_choice(m, emitted, pods, result)
            else:
                before = len(result.node_plans)
                self._emit_record(m, pods, result)
                if len(result.node_plans) > before:
                    plan = result.node_plans[-1]
                    emitted = (
                        self._type_ordinal(m["enc"], plan.instance_type),
                        plan.zone,
                        plan.capacity_type,
                        plan.price,
                        False,
                    )
                else:
                    emitted = (-1, None, None, 0.0, True)
                if trail is not None:
                    # analysis: allow-cache-key(result) — emitted is read from the plan this record just appended; the trail keys the record
                    ws.emits.put(trail, emitted, self._cstats)
            if clusters is not None:
                if trail is None:
                    clusters = None  # an unrecoverable trail: not memoized
                else:
                    clusters.append((trail,) + emitted)
        if mkey is not None and clusters is not None:
            # analysis: allow-cache-key(result) — the clusters are the emitted tuples of the keyed trails, not the result's other plans
            ws.merges.put(
                mkey,
                incremental.MergeSkeleton(clusters, st.get("merge_pairs_applied", 0) - applied_before),
                self._cstats,
            )
        st["merge_engine"] = "vector"
        st["merge_records"] = st.get("merge_records", 0) + len(records)
        st["merge_ms"] = st.get("merge_ms", 0.0) + (time.perf_counter() - t0) * 1000.0

    @staticmethod
    def _merge_trails(merged: List[dict], records: List[dict]) -> list:
        """Each merged cluster's absorption trail (the identities of the
        records whose memberships concatenated into it, in first-fit
        order), recovered from the membership runs. A cluster touching an
        unidentified record gets a None trail (not cached)."""
        by_first = {r["members"][0]: r for r in records if r["members"]}
        trails = []
        for m in merged:
            mem = m["members"]
            trail: list = []
            i = 0
            ok = bool(mem)
            while i < len(mem):
                r = by_first.get(mem[i])
                rkey = r.get("_rkey") if r is not None else None
                if rkey is None:
                    ok = False
                    break
                rl = len(r["members"])
                if mem[i : i + rl] != r["members"]:
                    ok = False
                    break
                trail.append(rkey)
                i += rl
            trails.append(tuple(trail) if ok and trail else None)
        return trails

    def _emit_from_choice(self, m: dict, emitted: tuple, pods: List[Pod], result: SolverResult) -> None:
        """Emit one merged cluster from a memoized offering choice: the
        NodePlan (or the errors) _emit_record builds for this
        content-identical cluster."""
        t, zone, ct, price, failed = emitted
        if failed:
            for i in m["members"]:
                result.pod_errors[pods[i].uid] = "packed node has no fitting instance type"
            return
        enc = m["enc"]
        result.node_plans.append(
            NodePlan(
                nodepool_name=m["pool"].nodepool.name,
                instance_type=enc.instance_types[t],
                zone=zone,
                capacity_type=ct,
                price=price,
                pod_indices=m["members"],
                requirements=m["merged"],
                max_pods_per_node=int(m.get("max_per_node", MAX_INT32)),
                node_limits=list(m.get("limits", [])),
                _pod_requests=[self._all_requests[i] for i in m["members"]],
            )
        )

    def _replay_merge(self, skel: incremental.MergeSkeleton, records: List[dict], pods, result) -> None:
        """Re-apply a recorded merge outcome to this tick's content-identical
        records: fold memberships, requirements and limits in the recorded
        absorption order and emit the recorded offerings."""
        by_key = {r["_rkey"]: r for r in records}
        for cluster in skel.clusters:
            trail, emitted = cluster[0], cluster[1:]
            recs = [by_key[k] for k in trail]
            base = recs[0]
            members = list(base["members"])
            merged_req = base["merged"]
            limits = base["limits"]
            mpn = base.get("max_per_node", MAX_INT32)
            for r in recs[1:]:
                combined = Requirements(*merged_req.values_list())
                combined.add(*r["merged"].values_list())
                merged_req = combined
                limits = limits + r["limits"]
                mpn = min(mpn, r.get("max_per_node", MAX_INT32))
                members.extend(r["members"])
            self._emit_from_choice(
                dict(base, members=members, merged=merged_req, limits=limits, max_per_node=mpn),
                emitted, pods, result,
            )

    @staticmethod
    def _type_ordinal(enc: EncodedInstanceTypes, it: InstanceType) -> int:
        table = enc.runtime_caches.get(("type_ord",))
        if table is None:
            table = {id(t): i for i, t in enumerate(enc.instance_types)}
            _cache_put(enc, ("type_ord",), table)
        return table[id(it)]

    def _merge_scalar(self, records: List[dict], pods: List[Pod]) -> List[dict]:
        """Reference merge engine: the pure-Python pairwise first-fit
        loop over pre-sorted records — the parity reference for the
        vector engine."""
        st = self._merge_stats
        screened = 0
        applied = 0
        merged: List[dict] = []
        for r in records:
            placed = False
            for m in merged[: self._MERGE_SCAN_CAP]:
                screened += 1
                if m["enc"] is not r["enc"] or m["pool"] is not r["pool"]:
                    continue
                if m["zone"] is not None and r["zone"] is not None and m["zone"] != r["zone"]:
                    continue
                enc = r["enc"]
                zone = m["zone"] if m["zone"] is not None else r["zone"]
                zone_ok = m["zone_ok"] & r["zone_ok"]
                ct_ok = m["ct_ok"] & r["ct_ok"]
                if not zone_ok.any() or not ct_ok.any():
                    continue
                if zone is not None and not zone_ok[enc.zones.index(zone)]:
                    continue
                viable = m["viable"] & r["viable"]
                if not viable.any():
                    continue
                if m["merged"] is None or r["merged"] is None:
                    continue
                # cheap reject: combined load exceeds even the elementwise
                # max of both sides' viable capacities
                if np.any(m["usage"] + r["usage"] > np.minimum(m["alloc_cap"], r["alloc_cap"])):
                    continue
                if self._merge_pair_exact(
                    m, r, pods, zone=zone, zone_ok=zone_ok, ct_ok=ct_ok, viable=viable
                ):
                    applied += 1
                    placed = True
                    break
            if not placed:
                merged.append(dict(r, members=list(r["members"])))
        st["merge_candidates_screened"] = st.get("merge_candidates_screened", 0) + screened
        st["merge_pairs_applied"] = st.get("merge_pairs_applied", 0) + applied
        return merged

    def _merge_pair_exact(
        self,
        m: dict,
        r: dict,
        pods: List[Pod],
        skip_intersects: bool = False,
        zone=None,
        zone_ok=None,
        ct_ok=None,
        viable=None,
    ) -> bool:
        """Exact tail of one merge-pair check — requirement-set
        intersection, hostname-level per-node limits, combined-load
        fits, offering availability on the intersected masks — then the
        apply (Requirements union, limit-count carry-over, membership
        join). Mutates ``m``; True when ``r`` was absorbed. Both merge
        engines go through it, so its host-port guard holds in each."""
        enc = r["enc"]
        if zone is None:
            zone = m["zone"] if m["zone"] is not None else r["zone"]
        if zone_ok is None:
            zone_ok = m["zone_ok"] & r["zone_ok"]
        if ct_ok is None:
            ct_ok = m["ct_ok"] & r["ct_ok"]
        if viable is None:
            viable = m["viable"] & r["viable"]
        # two nodes whose reserved host ports conflict never fold: the
        # oracle's HostPortUsage.conflicts on the combined membership
        m_ports, r_ports = m.get("ports"), r.get("ports")
        if m_ports and r_ports and ports_conflict(m_ports, r_ports):
            return False
        if not skip_intersects:
            ikey = (m["merged"].fingerprint(), r["merged"].fingerprint())
            compat_ok = self._intersects_cache.get(ikey)
            if compat_ok is None:
                compat_ok = m["merged"].intersects(r["merged"]) is None
                self._intersects_cache[ikey] = compat_ok
            if not compat_ok:
                return False
        limits = m.get("limits", []) + r.get("limits", [])
        # every hostname-level constraint of either side must hold on the
        # merged membership (the oracle's per-node count at placement);
        # per-side counts are cached so large memberships aren't
        # rescanned per pair
        for sel, ns, cap in limits:
            count = self._record_limit_count(m, sel, ns, pods) + self._record_limit_count(
                r, sel, ns, pods
            )
            if count > cap:
                return False
        usage = m["usage"] + r["usage"]
        alloc = self._alloc_full(enc, r["daemon"])
        fits = viable & np.all(usage[None, :] <= alloc, axis=1)
        if not fits.any():
            return False
        zmask = zone_ok
        if zone is not None:
            zmask = np.zeros(len(enc.zones), dtype=bool)
            zmask[enc.zones.index(zone)] = True
        off_ok = enc.offering_avail[:, zmask][:, :, ct_ok].any(axis=(1, 2))
        if not (fits & off_ok).any():
            return False
        # cost guard: when either side's partition was chosen by the LP
        # backend for its price, the merged node may not cost more than
        # the two nodes it replaces (FFD records never carry the flag)
        guarded = bool(m.get("_cost_guard") or r.get("_cost_guard"))
        merged_price: Optional[float] = None
        if guarded:
            pm = np.where(fits & off_ok, _offering_pmin(enc, zmask, ct_ok), np.inf)
            merged_price = float(pm.min())
            if merged_price > self._record_price(m) + self._record_price(r) + 1e-9:
                return False
        combined = Requirements(*m["merged"].values_list())
        combined.add(*r["merged"].values_list())
        # merge the per-selector count caches additively BEFORE the
        # memberships join: keys cached on both sides stay exact (counts
        # are disjoint membership sums); one-sided keys are completed now,
        # while the sides are still separate (their selectors ride in
        # _limit_sels)
        m_cache = m.get("_limit_counts") or {}
        r_cache = r.get("_limit_counts") or {}
        shared = m_cache.keys() & r_cache.keys()
        counts = {k: m_cache[k] + r_cache[k] for k in shared}
        if limits:
            sels = {**(r.get("_limit_sels") or {}), **(m.get("_limit_sels") or {})}
            for k in (m_cache.keys() | r_cache.keys()) - shared:
                if k not in sels:
                    continue
                counts[k] = self._record_limit_count(m, sels[k], k[1], pods) + (
                    self._record_limit_count(r, sels[k], k[1], pods)
                )
            m["_limit_sels"] = sels
        m.update(
            usage=usage,
            zone=zone,
            zone_ok=zone_ok,
            ct_ok=ct_ok,
            viable=viable,
            merged=combined,
            limits=limits,
            max_per_node=min(m.get("max_per_node", MAX_INT32), r.get("max_per_node", MAX_INT32)),
        )
        m["members"].extend(r["members"])
        m["_limit_counts"] = counts
        if m_ports or r_ports:
            m["ports"] = tuple(sorted(set(m_ports or ()) | set(r_ports or ())))
        if guarded:
            m["_cost_guard"] = True
            m["_price"] = merged_price
        else:
            m.pop("_price", None)
        return True

    def _record_price(self, rec: dict) -> float:
        """The price this record would emit at: cheapest offering of the
        cheapest viable type that holds its usage, under its own zone and
        capacity-type masks (the _emit_record choice), cached on the
        record — the merge guard prices each side once."""
        p = rec.get("_price")
        if p is not None:
            return p
        enc = rec["enc"]
        zmask = rec["zone_ok"]
        if rec["zone"] is not None:
            zmask = np.zeros(len(enc.zones), dtype=bool)
            zmask[enc.zones.index(rec["zone"])] = True
        alloc = self._alloc_full(enc, rec["daemon"])
        fits = rec["viable"] & np.all(rec["usage"][None, :] <= alloc, axis=1)
        prices = np.where(fits, _offering_pmin(enc, zmask, rec["ct_ok"]), np.inf)
        p = float(prices.min()) if prices.size else float("inf")
        rec["_price"] = p
        return p

    def _record_limit_count(self, record: dict, sel, ns: str, pods: List[Pod]) -> int:
        """Members of a merge record matching (sel, ns), cached on the
        record with the selector beside it."""
        cache = record.setdefault("_limit_counts", {})
        key = (self._sel_fp(sel) if sel is not None else None, ns)
        count = cache.get(key)
        if count is None:
            count = sum(
                1
                for i in record["members"]
                if pods[i].namespace == ns and self._sel_matches(sel, i, pods)
            )
            cache[key] = count
            record.setdefault("_limit_sels", {})[key] = sel
        return count

    def _emit_record(self, m: dict, pods: List[Pod], result: SolverResult) -> None:
        enc, zone_ok, ct_ok, zone = m["enc"], m["zone_ok"], m["ct_ok"], m["zone"]
        usage = m["usage"]
        alloc = self._alloc_full(enc, m["daemon"])
        fits = m["viable"] & np.all(usage[None, :] <= alloc, axis=1)
        zmask = zone_ok
        if zone is not None:
            zmask = np.zeros(len(enc.zones), dtype=bool)
            zmask[enc.zones.index(zone)] = True
        # price ties break on the stable type name rank, not position
        p = np.where(fits, _offering_pmin(enc, zmask, ct_ok), np.inf)
        t = _stable_argmin(p, _type_rank(enc))
        if not np.isfinite(p[t]):
            for i in m["members"]:
                result.pod_errors[pods[i].uid] = "packed node has no fitting instance type"
            return
        offering_zone, offering_ct, offering_price = self._cheapest_offering(
            enc, t, zone_ok, ct_ok, zone
        )
        result.node_plans.append(
            NodePlan(
                nodepool_name=m["pool"].nodepool.name,
                instance_type=enc.instance_types[t],
                zone=offering_zone,
                capacity_type=offering_ct,
                price=offering_price,
                pod_indices=m["members"],
                requirements=m["merged"],
                max_pods_per_node=int(m.get("max_per_node", MAX_INT32)),
                node_limits=list(m.get("limits", [])),
                _pod_requests=[self._all_requests[i] for i in m["members"]],
            )
        )

    @staticmethod
    def _cheapest_offering(
        enc: EncodedInstanceTypes,
        t: int,
        zone_ok: np.ndarray,
        ct_ok: np.ndarray,
        zone: Optional[str],
    ) -> Tuple[str, str, float]:
        prices = enc.offering_price[t]  # (Z, C)
        mask = np.isfinite(prices) & ct_ok[None, :] & zone_ok[:, None]
        if zone is not None:
            zmask = np.zeros(len(enc.zones), dtype=bool)
            zmask[enc.zones.index(zone)] = True
            mask = mask & zmask[:, None]
        masked = np.where(mask, prices, np.inf)
        flat = _stable_argmin(masked.ravel(), _offering_rank(enc).ravel())
        zi, ci = np.unravel_index(flat, masked.shape)
        return enc.zones[zi], enc.capacity_types[ci], float(masked[zi, ci])

    @staticmethod
    def _cheapest_offering_batch(
        enc: EncodedInstanceTypes,
        types: np.ndarray,
        zone_ok: np.ndarray,
        ct_ok: np.ndarray,
        zone: Optional[str],
    ) -> Tuple[List[str], List[str], np.ndarray]:
        """_cheapest_offering over many nodes' chosen types at once: one
        masked argmin over (N, Z, C), ties on the stable (zone,
        capacity-type) rank."""
        prices = enc.offering_price[types]  # (N, Z, C)
        mask = np.isfinite(prices) & ct_ok[None, None, :] & zone_ok[None, :, None]
        if zone is not None:
            zmask = np.zeros(len(enc.zones), dtype=bool)
            zmask[enc.zones.index(zone)] = True
            mask = mask & zmask[None, :, None]
        masked = np.where(mask, prices, np.inf).reshape(len(types), -1)
        pmin = masked.min(axis=1)
        rank = _offering_rank(enc).reshape(1, -1)
        tied = masked == pmin[:, None]
        flat = np.where(tied, rank, np.iinfo(np.int64).max).argmin(axis=1)
        zi, ci = np.unravel_index(flat, prices.shape[1:])
        return (
            [enc.zones[z] for z in zi],
            [enc.capacity_types[c] for c in ci],
            masked[np.arange(len(types)), flat],
        )
