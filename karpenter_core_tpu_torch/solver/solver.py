"""TorchScheduler: the batched provisioning solve on PyTorch and CUDA.

Counterpart of ``karpenter_core_tpu/solver/solver.py::TPUScheduler`` on
its plain tensor path:

  host:   signature-group pods → per-(signature, pool) set algebra
  device: ONE compat ∧ offering kernel launch per pool against the
          catalog's card-resident type side (solver/compat_kernels.py)
  host:   class-merged pack jobs → C++ first-fit-decreasing pack
          (native/pack.cc) → cheapest type/offering per node
  host:   cross-group merge of underfull nodes (merge.py) → NodePlans

Features the JAX package sends off this path raise NotImplementedError
with the feature's name instead of routing elsewhere: topology spread,
pod affinity and anti-affinity, host ports, volumes, existing nodes
(``state_nodes``), NodePool limits, ``daemonset_pods`` and preference
relaxation. The port reads no environment variable: the JAX package's
defaults it depends on are module constants (pack.NATIVE_K_OPEN,
compat_kernels.COMPAT_TILE_BYTES, the vector merge engine, the ffd pack
backend with the native engine).
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..apis import labels as wk
from ..apis.nodepool import NodePool, order_by_weight
from ..cloudprovider.types import CloudProvider, InstanceType
from ..kube.objects import EFFECT_PREFER_NO_SCHEDULE, Pod
from ..scheduling import Requirements, Taints, resources
from ..scheduling.requirements import label_requirements, node_selector_requirements
from . import podcache
from .backend import resolve_device
from .compat_kernels import DeviceCatalog, allowed_via_kernel, catalog_to_device, signature_side
from .encode import (
    EncodedInstanceTypes,
    PoolEncoding,
    ResourceAxis,
    SignatureGroup,
    build_catalog_axis,
    build_requests_matrix_ids,
    encode_instance_types,
    encode_signature_for_pool,
    extend_axis,
    extend_encoded_masks,
    finalize_signature_masks,
    group_pods,
    quantize_requests,
    unique_requests,
)
from .kernels import build_compat_inputs, zone_ct_masks
from .merge import merge_records_vector
from .pack import assign_cheapest_types, batch_pack, node_usage_from_assignment, pareto_frontier
from .stablehash import feed as stable_feed
from .vocab import Vocab

log = logging.getLogger("karpenter.torch.solver")

# cached catalog encodings per scheduler — the JAX package's
# KARPENTER_TPU_CATALOG_CACHE_MAX default
CATALOG_CACHE_MAX = 8
# bounded per-encoding derived-tensor cache (frontiers, ranks, prices)
_RUNTIME_CACHE_MAX = 256

MAX_INT32 = 2**31 - 1

# wall-time phases of a solve, reported in ``last_timings`` as "<phase>_ms":
# group (pod memos + signature grouping), encode (catalog and signature
# encode, the compat kernel and its sync), prepare (pool choice and
# class-merged pack jobs), pack (the C++ packer), finalize (usage,
# cheapest type and offering per node), merge (the cross-group merge and
# its emit)
PHASES = ("group", "encode", "prepare", "pack", "finalize", "merge")


@dataclass
class _CatalogEntry:
    """One catalog generation's tensorization, cached across solves on
    the scheduler. The vocab grows monotonically as pod batches intern
    new values; cached masks are re-extended in place
    (encode.extend_encoded_masks)."""

    catalog: List[InstanceType]
    fingerprint: bytes
    vocab: Vocab
    axis: ResourceAxis
    enc: EncodedInstanceTypes
    # (vocab-width snapshot, DeviceCatalog): the kernel's type side,
    # resident on the solve device, re-packed only when the vocab grew
    device_catalog: Optional[Tuple[tuple, DeviceCatalog]] = None


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
    job's zone/capacity-type requirements — the price model for packed
    nodes."""
    enc = meta["enc"]
    viable_idx = meta["viable_idx"]
    zone_ok, ct_ok = meta["zone_ok"], meta["ct_ok"]
    op = enc.offering_price[viable_idx][:, zone_ok, :][:, :, ct_ok].reshape(len(viable_idx), -1)
    if not op.size:
        return np.full(len(viable_idx), np.inf)
    return np.where(np.isfinite(op), op, np.inf).min(axis=1)


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

    @property
    def requests(self) -> Optional[dict]:
        if self._requests is None and self._pod_requests is not None:
            self._requests = resources.merge(*self._pod_requests)
        return self._requests


@dataclass
class ExistingNodePlan:
    """Pods placed onto an existing node (never produced by this slice)."""

    state_node: object
    pod_indices: List[int]
    pods: Optional[List[Pod]] = None


@dataclass
class SolverResult:
    node_plans: List[NodePlan] = field(default_factory=list)
    existing_plans: List[ExistingNodePlan] = field(default_factory=list)
    pod_errors: Dict[str, str] = field(default_factory=dict)  # pod uid → error
    oracle_results: Optional[object] = None  # no oracle fallback in this slice

    @property
    def node_count(self) -> int:
        return len(self.node_plans)

    @property
    def total_price(self) -> float:
        return sum(p.price for p in self.node_plans)

    @property
    def pods_scheduled(self) -> int:
        return sum(len(p.pod_indices) for p in self.node_plans) + sum(
            len(p.pod_indices) for p in self.existing_plans
        )


@dataclass
class JobSkeleton:
    """Pack + finalize products of one job, positional over the job's
    size-sorted pod order."""

    node_count: int
    positions: np.ndarray  # valid sorted positions, grouped by node
    bounds: np.ndarray  # (node_count + 1,) into positions
    unsched: np.ndarray  # positions whose pod packed nowhere
    ok: np.ndarray  # (N,) node has a fitting type
    underfull: np.ndarray  # (N,) usage*2 <= alloc_cap
    usage64: np.ndarray  # (N, R) int64
    alloc_cap: np.ndarray  # (R,) the merge pass's cheap-reject seed
    ok_ord: np.ndarray  # (N,) ordinal among ok nodes
    t_global: np.ndarray  # (n_ok,) chosen type per ok node
    off_zone: list
    off_ct: list
    off_price: np.ndarray


class _DeviceClock:
    """Device time of a solve from CUDA event pairs (no-op on the CPU)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pairs: list = []

    @contextmanager
    def track(self):
        if not self.cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.pairs.append((start, end))

    def ms(self) -> float:
        total = 0.0
        for start, end in self.pairs:
            end.synchronize()
            total += start.elapsed_time(end)
        return total


def _route_check(group: SignatureGroup) -> None:
    """Raise NotImplementedError for a group the slice does not carry."""
    spec = group.exemplar.spec
    if spec.topology_spread_constraints:
        raise NotImplementedError(
            "topology spread (zone/hostname spread) is not ported yet"
        )
    a = spec.affinity
    if a is not None:
        if a.pod_affinity is not None and (a.pod_affinity.required or a.pod_affinity.preferred):
            raise NotImplementedError("pod affinity is not ported yet")
        if a.pod_anti_affinity is not None and (
            a.pod_anti_affinity.required or a.pod_anti_affinity.preferred
        ):
            raise NotImplementedError("pod anti-affinity is not ported yet")
    if any(p.host_port for c in spec.containers + spec.init_containers for p in c.ports):
        raise NotImplementedError("host ports are not ported yet")
    if any(v.persistent_volume_claim is not None or v.ephemeral for v in spec.volumes):
        raise NotImplementedError("volumes are not ported yet")


def _relaxable(pod: Pod, prefer_no_schedule: bool) -> bool:
    """Whether the JAX package's preference ladder would relax this pod
    (scheduler/preferences.py): preferred node affinity, a required
    node-affinity term beyond the first, or any PreferNoSchedule pool
    taint (counted even when the pod already tolerates it)."""
    a = pod.spec.affinity
    if a is not None and a.node_affinity is not None:
        na = a.node_affinity
        if na.preferred:
            return True
        if na.required is not None and len(na.required.node_selector_terms) > 1:
            return True
    return prefer_no_schedule


class TorchScheduler:
    def __init__(
        self,
        nodepools: List[NodePool],
        cloud_provider: CloudProvider,
        device=None,
    ):
        self.device = resolve_device(device)
        self.nodepools = order_by_weight(
            [np_ for np_ in nodepools if np_.metadata.deletion_timestamp is None]
        )
        self.cloud_provider = cloud_provider
        # device/host wall-time split of the most recent solve
        self.last_timings: Optional[Dict[str, float]] = None
        self.last_merge_stats: Optional[Dict[str, object]] = None
        self._merge_stats: Dict[str, object] = {}
        self._catalogs: "OrderedDict[tuple, _CatalogEntry]" = OrderedDict()
        self._clock = _DeviceClock(self.device)

    # ------------------------------------------------------------------

    def solve(
        self,
        pods: List[Pod],
        state_nodes=None,
        daemonset_pods: Optional[List[Pod]] = None,
    ) -> SolverResult:
        """One batched solve of ``pods`` onto new nodes."""
        if state_nodes:
            raise NotImplementedError("existing nodes (state_nodes) are not ported yet")
        if daemonset_pods:
            raise NotImplementedError("daemonset_pods overhead is not ported yet")
        for np_ in self.nodepools:
            if np_.spec.limits:
                raise NotImplementedError(
                    f'NodePool limits are not ported yet (nodepool "{np_.name}")'
                )
        t0 = time.perf_counter()
        self._clock = _DeviceClock(self.device)
        self._phase_ms = dict.fromkeys(PHASES, 0.0)
        try:
            return self._solve(pods)
        finally:
            total_ms = (time.perf_counter() - t0) * 1000.0
            device_ms = self._clock.ms()
            self.last_timings = {
                "total_ms": total_ms,
                "device_ms": device_ms,
                "host_ms": max(total_ms - device_ms, 0.0),
                **{f"{name}_ms": ms for name, ms in self._phase_ms.items()},
            }
            self.last_merge_stats = dict(self._merge_stats)

    @contextmanager
    def _phase(self, name: str):
        """Wall time of one solve phase into ``last_timings[name + "_ms"]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._phase_ms[name] += (time.perf_counter() - t0) * 1000.0

    def _solve(self, pods: List[Pod]) -> SolverResult:
        result = SolverResult()
        self._merge_stats = {
            "merge_ms": 0.0,
            "merge_records": 0,
            "merge_candidates_screened": 0,
            "merge_pairs_applied": 0,
        }
        with self._phase("group"):
            memos, _ = podcache.get_memos_rvs(pods)
            self._all_requests = [m.requests for m in memos]
            self._req_ids = np.fromiter((m.req_id for m in memos), dtype=np.int64, count=len(memos))
            self._req_map = {m.req_id: m.requests for m in memos}
            groups = group_pods(pods, memos=memos)
        # merge-pass pairwise Requirements.intersects memo (content keyed)
        self._intersects_cache: Dict[tuple, bool] = {}
        for g in groups:
            _route_check(g)
        if groups:
            self._solve_tensor(pods, groups, result)
            self._check_relaxation(pods, groups, result)
        return result

    def _check_relaxation(self, pods, groups, result: SolverResult) -> None:
        """The JAX package re-enters failed, relaxable groups through its
        preference ladder; that retry is not ported, so such a batch
        raises rather than returning a different plan."""
        if not result.pod_errors:
            return
        prefer = any(
            t.effect == EFFECT_PREFER_NO_SCHEDULE
            for np_ in self.nodepools
            for t in np_.spec.template.taints
        )
        for g in groups:
            if any(pods[i].uid in result.pod_errors for i in g.pod_indices) and _relaxable(
                g.exemplar, prefer
            ):
                raise NotImplementedError("preference relaxation is not ported yet")

    # ------------------------------------------------------------------

    def _catalog_entry(self, catalog: List[InstanceType]) -> _CatalogEntry:
        # identity key revalidated by the content fingerprint on every
        # lookup (the entry's strong ref keeps the ids from recycling)
        key = tuple(map(id, catalog))
        fp = _catalog_fingerprint(catalog)
        entry = self._catalogs.get(key)
        if entry is not None and entry.fingerprint == fp:
            self._catalogs.move_to_end(key)
            return entry
        vocab = Vocab()
        axis = build_catalog_axis(catalog)
        enc = encode_instance_types(list(catalog), axis, vocab)
        entry = _CatalogEntry(list(catalog), fp, vocab, axis, enc)
        self._catalogs[key] = entry
        self._catalogs.move_to_end(key)
        while len(self._catalogs) > CATALOG_CACHE_MAX:
            self._catalogs.popitem(last=False)
        return entry

    def _device_catalog(self, entry: _CatalogEntry) -> DeviceCatalog:
        """The kernel's packed type side for ``entry``, resident on the
        solve device and re-uploaded only when the vocab grew."""
        enc = entry.enc
        keys = tuple(sorted(enc.key_masks.keys()))
        snapshot = tuple((k, entry.vocab.key_vocab(k).size) for k in keys)
        if entry.device_catalog is not None and entry.device_catalog[0] == snapshot:
            return entry.device_catalog[1]
        with self._clock.track():  # the catalog upload is device work
            catalog = catalog_to_device(
                enc.key_masks, enc.key_has, enc.key_neg, keys, enc.offering_avail, self.device
            )
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

    def _solve_tensor(
        self, pods: List[Pod], groups: List[SignatureGroup], result: SolverResult
    ) -> None:
        pools, pool_catalogs = self._build_pools()
        if not pools:
            for g in groups:
                for i in g.pod_indices:
                    result.pod_errors[pods[i].uid] = "no nodepool found"
            return
        with self._phase("encode"):
            ctx = self._encode_phase(groups, pools, pool_catalogs)
        self._pack_phase(pods, groups, pools, result, ctx)

    def _encode_phase(
        self,
        groups: List[SignatureGroup],
        pools: List[PoolEncoding],
        pool_catalogs: List[List[InstanceType]],
    ) -> dict:
        """Catalog/signature tensorization, ONE kernel launch per pool,
        per-pod encoding while the card works, then one sync."""
        pool_entries = [self._catalog_entry(cat) for cat in pool_catalogs]
        sig_compats: List[List] = [
            [encode_signature_for_pool(g, pool, e.vocab) for g in groups]
            for pool, e in zip(pools, pool_entries)
        ]
        for e in {id(e): e for e in pool_entries}.values():
            extend_encoded_masks(e.enc, e.vocab)
        for compats, e in zip(sig_compats, pool_entries):
            finalize_signature_masks(compats, e.vocab)
        encoded = [e.enc for e in pool_entries]

        # every pool's launch is enqueued before the first sync
        pending = []
        for e, compats in zip(pool_entries, sig_compats):
            sig_arrays = build_compat_inputs(compats, e.enc, e.vocab)
            zone_ok, ct_ok = zone_ct_masks(compats, e.enc)
            catalog = self._device_catalog(e)
            with self._clock.track():
                sig = signature_side(sig_arrays, zone_ok, ct_ok, catalog)
                allowed = allowed_via_kernel(sig, catalog)
            pending.append((allowed, zone_ok, ct_ok))

        # per unique catalog: extended axis + quantized request matrix
        uniq_reqs = unique_requests(self._req_ids, self._req_map)
        matrices: Dict[int, tuple] = {}
        for e in {id(e): e for e in pool_entries}.values():
            axis_ext = extend_axis(e.axis, uniq_reqs)
            matrices[id(e)] = (
                axis_ext,
                build_requests_matrix_ids(self._req_ids, axis_ext, self._req_map),
            )
        # no daemonset overhead in this slice: a zero vector per pool
        daemon_requests = {
            pool.nodepool.name: quantize_requests({}, matrices[id(e)][0])
            for pool, e in zip(pools, pool_entries)
        }

        allowed_per_pool = []
        for allowed, zone_ok, ct_ok in pending:
            with self._clock.track():
                host = allowed.cpu().numpy()
            allowed_per_pool.append((host, zone_ok, ct_ok))
        return dict(
            encoded=encoded,
            sig_compats=sig_compats,
            allowed_per_pool=allowed_per_pool,
            matrices=matrices,
            pool_entries=pool_entries,
            daemon_requests=daemon_requests,
        )

    def _pack_phase(
        self,
        pods: List[Pod],
        groups: List[SignatureGroup],
        pools: List[PoolEncoding],
        result: SolverResult,
        ctx: dict,
    ) -> None:
        """One pack round: pool choice, class-merged jobs, pack +
        finalize, cross-group merge."""
        infos: List[dict] = []
        jobs: List[tuple] = []
        metas: List[dict] = []
        with self._phase("prepare"):
            for gi, g in enumerate(groups):
                info = self._choose_pool(
                    gi, g, pods, pools, ctx["sig_compats"], ctx["allowed_per_pool"], result,
                    list(g.pod_indices),
                )
                if info is not None:
                    infos.append(info)
            self._prepare_class_jobs(
                infos, ctx["matrices"], ctx["pool_entries"], pools, ctx["encoded"],
                ctx["daemon_requests"], pods, result, jobs, metas,
            )
        records: List[dict] = []
        self._pack_and_finalize(jobs, metas, pods, result, records)
        with self._phase("merge"):
            self._merge_and_emit(records, pods, result)

    def _choose_pool(
        self,
        gi: int,
        group: SignatureGroup,
        pods: List[Pod],
        pools: List[PoolEncoding],
        sig_compats,
        allowed_per_pool,
        result: SolverResult,
        indices: List[int],
    ) -> Optional[dict]:
        """First pool (weight order) whose template accepts the signature
        and offers at least one viable type (scheduler.go:256-283)."""
        chosen = None
        for pi, pool in enumerate(pools):
            if not sig_compats[pi][gi].compatible:
                continue
            if allowed_per_pool[pi][0][gi].any():
                chosen = pi
                break
        if chosen is None:
            err = "; ".join(
                f'incompatible with nodepool "{p.nodepool.name}", '
                f'{sig_compats[pi][gi].error or "no viable instance type"}'
                for pi, p in enumerate(pools)
            )
            for i in indices:
                result.pod_errors[pods[i].uid] = err
            return None
        return dict(
            group=group,
            gi=gi,
            indices=indices,
            chosen=chosen,
            viable=allowed_per_pool[chosen][0][gi],  # (T,) bool
            zone_ok=allowed_per_pool[chosen][1][gi],  # (Z,)
            ct_ok=allowed_per_pool[chosen][2][gi],  # (C,)
            max_per_node=np.int32(MAX_INT32),
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
        # groups pack together only when their FULL merged requirement
        # sets agree — the (viable, zone, ct) masks alone miss keys that
        # don't project onto catalog dimensions (custom node labels)
        classes: Dict[tuple, List[dict]] = {}
        for info in infos:
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
            requests_matrix = matrices[id(pool_entries[chosen])][1]
            idx = np.asarray([i for m in members for i in m["indices"]], dtype=np.int64)
            reqs = requests_matrix[idx]
            # descending by primary then memory (queue.go:76 ordering)
            order = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
            self._prepare_job(
                idx[order], reqs[order], enc, members[0]["viable"], members[0]["zone_ok"],
                members[0]["ct_ok"], daemon_requests[pool.nodepool.name],
                members[0]["max_per_node"], pool, pods, result, jobs, metas,
                merged=members[0]["merged"],
            )

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
        merged=None,
    ) -> None:
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
        jobs.append((reqs, frontier, np.int32(max_per_node)))
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
                daemon=daemon,
                max_per_node=int(max_per_node),
                merged=merged,
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
    ) -> None:
        """Pack every job on the native packer, then finalize in job
        order."""
        with self._phase("pack"):
            packed = batch_pack(jobs)
        if merge_all is None:
            # small plans: every node joins the merge pass (the oracle
            # back-fills leftover space on full nodes too); large plans:
            # only underfull tails
            merge_all = sum(int(count) for _, count in packed) <= 256
        with self._phase("finalize"):
            for meta, (node_ids, node_count) in zip(metas, packed):
                skel = self._job_skeleton(meta, node_ids, int(node_count))
                self._emit_skeleton(meta, skel, pods, result, records, merge_all)

    def _job_skeleton(self, meta: dict, node_ids: np.ndarray, node_count: int) -> JobSkeleton:
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
                z, z, [], [], np.zeros(0),
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
        ok_nodes = np.flatnonzero(ok)
        ok_ord = np.full(node_count, -1, dtype=np.int64)
        ok_ord[ok_nodes] = np.arange(ok_nodes.size)
        if ok_nodes.size:
            t_global = viable_idx[chosen_types[ok_nodes]]
            off_zone, off_ct, off_price = self._cheapest_offering_batch(
                enc, t_global, meta["zone_ok"], meta["ct_ok"], None
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
        )

    def _emit_skeleton(
        self,
        meta: dict,
        skel: JobSkeleton,
        pods: List[Pod],
        result: SolverResult,
        records: List[dict],
        merge_all: bool,
    ) -> None:
        """Positional node memberships become pod indices; plan nodes
        emit NodePlans and underfull tails become merge records."""
        idx, enc = meta["idx"], meta["enc"]
        for i in idx[skel.unsched]:
            result.pod_errors[pods[i].uid] = (
                "no instance type satisfied resources and requirements (tensor path)"
            )
        if skel.node_count == 0:
            return
        viable_bool = np.zeros(len(enc.instance_types), dtype=bool)
        viable_bool[meta["viable_idx"]] = True
        to_record = skel.ok.copy() if merge_all else skel.ok & skel.underfull
        max_per_node = meta["max_per_node"]
        pool = meta["pool"]
        positions, bounds = skel.positions, skel.bounds
        for n in range(skel.node_count):
            members = idx[positions[bounds[n] : bounds[n + 1]]].tolist()
            if not skel.ok[n]:
                for i in members:
                    result.pod_errors[pods[i].uid] = "packed node has no fitting instance type"
                continue
            if to_record[n]:
                records.append(
                    dict(
                        enc=enc,
                        pool=pool,
                        zone=None,
                        zone_ok=meta["zone_ok"],
                        ct_ok=meta["ct_ok"],
                        viable=viable_bool,
                        usage=skel.usage64[n],
                        members=members,
                        daemon=meta["daemon"],
                        alloc_cap=skel.alloc_cap,
                        merged=meta["merged"],
                        max_per_node=max_per_node,
                        limits=[],
                    )
                )
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
                    node_limits=[],
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
        holds the combined load with an available offering."""
        if not records:
            return
        t0 = time.perf_counter()
        st = self._merge_stats
        records.sort(key=lambda r: -int(r["usage"][0]))
        merged = merge_records_vector(self, records, pods, self._MERGE_SCAN_CAP)
        for m in merged:
            self._emit_record(m, pods, result)
        st["merge_engine"] = "vector"
        st["merge_records"] = st.get("merge_records", 0) + len(records)
        st["merge_ms"] = st.get("merge_ms", 0.0) + (time.perf_counter() - t0) * 1000.0

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
        intersection, combined-load fits, offering availability on the
        intersected masks — then the apply (Requirements union,
        membership join). Mutates ``m``; True when ``r`` was absorbed."""
        enc = r["enc"]
        if zone is None:
            zone = m["zone"] if m["zone"] is not None else r["zone"]
        if zone_ok is None:
            zone_ok = m["zone_ok"] & r["zone_ok"]
        if ct_ok is None:
            ct_ok = m["ct_ok"] & r["ct_ok"]
        if viable is None:
            viable = m["viable"] & r["viable"]
        if not skip_intersects:
            ikey = (m["merged"].fingerprint(), r["merged"].fingerprint())
            compat_ok = self._intersects_cache.get(ikey)
            if compat_ok is None:
                compat_ok = m["merged"].intersects(r["merged"]) is None
                self._intersects_cache[ikey] = compat_ok
            if not compat_ok:
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
        combined = Requirements(*m["merged"].values_list())
        combined.add(*r["merged"].values_list())
        m.update(
            usage=usage,
            zone=zone,
            zone_ok=zone_ok,
            ct_ok=ct_ok,
            viable=viable,
            merged=combined,
            limits=m.get("limits", []) + r.get("limits", []),
            max_per_node=min(m.get("max_per_node", MAX_INT32), r.get("max_per_node", MAX_INT32)),
        )
        m["members"].extend(r["members"])
        return True

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
