"""Mega-solve: many tenants' solves through one device, one dispatch.

Counterpart of ``karpenter_core_tpu/fleet/megasolve.py``. Three pieces,
chosen per round by the engine switch ``KARPENTER_TORCH_FLEET_ENGINE``
(``batched``, the default, or ``solo``: independent per-tenant solves,
the plan-identity oracle), or by ``FleetEngine(engine=)``:

- **CatalogPlane** dedupes tenant catalogs by content. The plane maps
  (tenant, pool, provider catalog generation) to a content fingerprint
  (the ``fleetenv`` memo: once per generation, not per solve) and the
  fingerprint to one canonical plane-owned copy of the catalog
  (``fleetcanon``), so content-identical tenants resolve to the same
  catalog object and share one encoded ``_CatalogEntry``, its compat
  rows and its card-resident type side. A tenant mutating its own
  catalog in place never reaches the copy other tenants read.
- **SkeletonPlane** is the fleet-wide job-skeleton memo (``fleetjob``).
  A job key less its trailing tenant scope is pure content (the catalog
  entry's identity and fingerprint, the pool fingerprint, the request
  digest, every mask, the engine and backend tokens, the device), and
  the skeleton is a deterministic function of it, so sharing it across
  tenants is memoization, never approximation.
- **_MegaDispatcher** coalesces pack calls. Each tenant solve runs on a
  worker thread that installs a ``_CoalescingBackend``
  (``backends.set_thread_backend``); its pack submissions park at a
  quiescence barrier and flush as ONE ``pack_jobs(jobs, metas, device,
  stats)`` call of the real backend on the lanes' one device. With the
  C++ packer every job packs alone; with ``KARPENTER_TORCH_NATIVE=0``
  ``pack.batch_pack`` launches the FFD scan (``csrc/ffd_pack.cu``) once
  per (pad class, width) class of the whole flush, so one launch carries
  several tenants' jobs, each lane independent of the others. Either
  way a job's result does not depend on the flush it rides in.

Identity: batched plans equal solo plans for the same tenant inputs.
Isolation: the only cross-tenant sharing is content-addressed; every
identity- or generation-scoped memo carries the tenant scope.

The JAX package's ``KARPENTER_TPU_FLEET_WORKERS``,
``_JOIN_TIMEOUT_S`` and ``_TENANT_LABELS`` are module constants here
(``FLEET_WORKERS``, ``FLEET_JOIN_TIMEOUT_S``, ``FLEET_TENANT_LABELS``)
with the reference's defaults; tests monkeypatch them.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..solver import backends as backends_mod
from ..solver.backends import PackBackend
from ..solver.incremental import LRU, CacheStats
from ..tracing import tracer

# tenant solves run at once in a batched round
FLEET_WORKERS = 4
# a batched round's bound on joining its workers: a wedged lane surfaces
# as a counted timeout outcome, never a hung round
FLEET_JOIN_TIMEOUT_S = 300
# tenants that keep their own label on the per-tenant metrics; the rest
# are counted under "_other"
FLEET_TENANT_LABELS = 64

ENGINES = ("batched", "solo")


def fleet_engine_name() -> str:
    """The engine switch, read per round; an unknown name degrades to the
    default, never fails the round."""
    name = os.environ.get("KARPENTER_TORCH_FLEET_ENGINE", "batched").strip().lower()
    return name if name in ENGINES else "batched"


def _clone_catalog(its: list) -> list:
    """A plane-owned copy of a tenant catalog: every field the encoding and
    the emitted plans read, copied field by field."""
    from ..cloudprovider.types import InstanceType, InstanceTypeOverhead, Offering, Offerings

    return [
        InstanceType(
            it.name,
            it.requirements.copy(),
            Offerings(Offering(o.capacity_type, o.zone, o.price, o.available) for o in it.offerings),
            dict(it.capacity),
            overhead=InstanceTypeOverhead(
                dict(it.overhead.kube_reserved),
                dict(it.overhead.system_reserved),
                dict(it.overhead.eviction_threshold),
            ),
        )
        for it in its
    ]


# -- the catalog content plane --------------------------------------------------


class CatalogPlane:
    """Content-addressed canonical catalogs for the batched engine."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        # (tenant, pool name, provider catalog generation) -> fingerprint:
        # the provider's generation witnesses the catalog's content
        self._envelopes = LRU("fleetenv")
        # fingerprint -> (canonical copy, plane generation)
        self._canon = LRU("fleetcanon")
        self._next_gen = 0
        self._active = False
        self.stats = CacheStats()

    def activate(self, on: bool) -> None:
        with self._mu:
            self._active = bool(on)

    def active(self) -> bool:
        with self._mu:
            return self._active

    def _fingerprint_for(self, tenant_id: str, pool_name, gen, its) -> bytes:
        from ..solver.solver import _catalog_fingerprint

        key = (tenant_id, pool_name, gen)
        fp = self._envelopes.get(key, self.stats)
        if fp is None:
            fp = _catalog_fingerprint(its)
            self._envelopes.put(key, fp, self.stats)
        return fp

    def _canonical_for(self, fp: bytes, its: list) -> tuple:
        with self._mu:
            canon = self._canon.get(fp, self.stats)
            if canon is None:
                self._next_gen += 1
                canon = (_clone_catalog(its), ("fleet", self._next_gen))
                # analysis: allow-cache-key(its) — fp is its content fingerprint (_catalog_fingerprint), so the canonical clone is a function of the key
                self._canon.put(fp, canon, self.stats)
        return canon

    def prewarm(self, tenant_id: str, provider, nodepools) -> None:
        """At admission: each pool catalog's fingerprint and, first of its
        content, its canonical copy, so the tenant's first round pays
        neither."""
        cg = getattr(provider, "catalog_generation", None)
        for np_ in list(nodepools) or [None]:
            its = provider.get_instance_types(np_)
            gen = cg(np_) if callable(cg) else None
            if gen is None:
                continue
            pool_name = np_.metadata.name if np_ is not None else None
            self._canonical_for(self._fingerprint_for(tenant_id, pool_name, gen, its), its)

    def resolve(self, tenant_id: str, provider, nodepool) -> Tuple[list, object]:
        """→ (catalog, generation witness) of one tenant pool: the
        canonical copy when active, else (or for a provider without a
        trusted generation counter) the tenant's own catalog."""
        its = provider.get_instance_types(nodepool)
        cg = getattr(provider, "catalog_generation", None)
        gen = cg(nodepool) if callable(cg) else None
        if not self.active() or gen is None:
            return its, gen
        pool_name = nodepool.metadata.name if nodepool is not None else None
        return self._canonical_for(self._fingerprint_for(tenant_id, pool_name, gen, its), its)

    def export_canon(self) -> list:
        """(fingerprint, canonical catalog) pairs for the warm store. The
        ``fleetenv`` memo is keyed by live generation counters and is not
        exported: admission recomputes it."""
        with self._mu:
            return [(fp, canon[0]) for fp, canon in self._canon.items()]

    def import_canon(self, entries: list) -> int:
        """Install persisted canonical catalogs; plane generations are
        minted afresh, so a restored copy never collides with one this
        process handed out."""
        n = 0
        with self._mu:
            for fp, catalog in entries:
                if self._canon.get(fp) is None:
                    self._next_gen += 1
                    self._canon.put(fp, (list(catalog), ("fleet", self._next_gen)))
                    n += 1
        return n

    def debug_state(self) -> dict:
        with self._mu:
            return {
                "active": self._active,
                "envelopes": len(self._envelopes),
                "canonical_catalogs": len(self._canon),
                "stats": self.stats.to_dict(),
            }


class TenantCatalogView:
    """The cloud provider a tenant's solver reads: its own catalog in solo
    rounds, the canonical copies in batched rounds. Everything but the
    catalog surface goes to the tenant's own provider."""

    def __init__(self, provider, plane: CatalogPlane, tenant_id: str):
        self._provider = provider
        self._plane = plane
        self._tenant_id = tenant_id

    def get_instance_types(self, nodepool=None):
        return self._plane.resolve(self._tenant_id, self._provider, nodepool)[0]

    def catalog_generation(self, nodepool=None):
        return self._plane.resolve(self._tenant_id, self._provider, nodepool)[1]

    def __getattr__(self, name):
        return getattr(self._provider, name)


# -- the fleet-wide job-skeleton plane ------------------------------------------


class SkeletonPlane:
    """The ``fleetjob`` LRU, read and written by
    ``TorchScheduler._pack_and_finalize`` under the job key's tenant-free
    prefix (``key[:-1]``)."""

    def __init__(self) -> None:
        self._skeletons = LRU("fleetjob")

    def skeleton_get(self, key: tuple, stats: Optional[CacheStats] = None):
        return self._skeletons.get(key, stats)

    def skeleton_put(self, key: tuple, skel, stats: Optional[CacheStats] = None) -> None:
        self._skeletons.put(key, skel, stats)

    def __len__(self) -> int:
        return len(self._skeletons)


# -- pack coalescing ----------------------------------------------------------------


class _PackWait:
    """One tenant thread's parked pack submission, with the lane's trace
    context: the flush links every parked lane's trace to the shared
    dispatch, and back."""

    __slots__ = ("jobs", "metas", "device", "results", "flags", "error", "done", "ctx")

    def __init__(self, jobs, metas, device):
        self.jobs = jobs
        self.metas = metas
        self.device = device
        self.results = None
        self.flags: List[bool] = []
        self.error: Optional[BaseException] = None
        self.done = False
        self.ctx = tracer.capture()


class _MegaDispatcher:
    """Quiescence-flush coalescer: pack submissions park here; once every
    busy worker is parked (or the safety window passes) the last arrival
    flushes them all as one call of the real backend. A flush carries one
    device: lanes on two devices raise rather than mix."""

    def __init__(self, backend: PackBackend, window: float = 0.05):
        self._backend = backend
        self._window = window
        self._cv = threading.Condition()
        self._active = 0  # workers driving a tenant solve
        self._pending: List[_PackWait] = []
        self.stats = CacheStats()  # the flushes' relax-memo traffic (lp)
        self.flushes = 0
        self.calls = 0
        self.jobs_in = 0
        self.max_occupancy = 0
        self.pad_real = 0
        self.pad_slots = 0
        # the LP backend's counters summed over the flushes
        self.lp_totals: dict = {}

    def target_token(self, device=None) -> tuple:
        """The real backend's job token: fleet job keys equal solo keys for
        the same content, which lets the content plane and the per-tenant
        memos interoperate."""
        return self._backend.job_token(device)

    def worker_begin(self) -> None:
        with self._cv:
            self._active += 1

    def worker_end(self) -> None:
        with self._cv:
            self._active -= 1
            self._cv.notify_all()  # a departing worker can complete quiescence

    def pack_alone(self, jobs: list, metas: list, device, mesh) -> Tuple[list, List[bool]]:
        """One lane's jobs through the real backend on the calling thread,
        outside any flush (the lane stays a busy worker meanwhile)."""
        with self._backend.lock:
            # analysis: allow-wait-under-lock(device — backend.lock exists to serialize this dispatch and its output reads; the lane holds no other lock here, so the edge cannot deadlock)
            packed = self._backend.pack_jobs(jobs, metas, device=device, stats=self.stats, mesh=mesh)
            flags = list(getattr(self._backend, "last_job_flags", ()) or ())
        return packed, flags if len(flags) == len(jobs) else [False] * len(jobs)

    def submit(self, jobs: list, metas: list, device) -> Tuple[list, List[bool]]:
        w = _PackWait(jobs, metas, device)
        with self._cv:
            self._pending.append(w)
            self.calls += 1
            self.jobs_in += len(jobs)
            self._cv.notify_all()
        while True:
            batch: Optional[List[_PackWait]] = None
            with self._cv:
                if w.done:
                    break
                if self._pending and len(self._pending) >= max(self._active, 1):
                    batch, self._pending = self._pending, []
                elif not self._cv.wait(timeout=self._window):
                    if not w.done and self._pending:
                        # safety flush: progress even if a worker stalls
                        # outside the barrier (grouping is latency only)
                        batch, self._pending = self._pending, []
            if batch is not None:
                self._run_batch(batch)
                with self._cv:
                    self._cv.notify_all()
        if w.error is not None:
            raise w.error
        return w.results, w.flags

    def _run_batch(self, batch: List[_PackWait]) -> None:
        from ..solver.backend import resolve_device
        from ..solver.pack import _pad_class

        all_jobs = [j for w in batch for j in w.jobs]
        all_metas = [m for w in batch for m in w.metas]
        links = [w.ctx.trace_id for w in batch if w.ctx is not None]
        flusher_id = tracer.current_trace_id()
        if flusher_id is not None:
            for w in batch:
                if w.ctx is not None and w.ctx.trace_id != flusher_id:
                    w.ctx.trace.add_link(flusher_id, via="fleet.megadispatch")
        try:
            devices = {str(resolve_device(w.device)) for w in batch}
            if len(devices) != 1:
                raise ValueError(f"one pack flush got lanes on several devices: {sorted(devices)}")
            device = batch[0].device
            with tracer.span("fleet.megadispatch", jobs=len(all_jobs), tenant_calls=len(batch), links=links):
                # the real backend's lock spans the call and its per-call outputs
                with self._backend.lock:
                    # analysis: allow-wait-under-lock(device — backend.lock exists to serialize this dispatch and its output reads; the flusher holds nothing else, so the edge cannot deadlock)
                    packed = self._backend.pack_jobs(all_jobs, all_metas, device=device, stats=self.stats)
                    flags = list(getattr(self._backend, "last_job_flags", ()) or ())
                    bstats = dict(getattr(self._backend, "last_stats", {}) or {})
            if len(flags) != len(all_jobs):
                flags = [False] * len(all_jobs)
            with self._cv:
                self.flushes += 1
                self.max_occupancy = max(self.max_occupancy, len(batch))
                for k, v in bstats.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        self.lp_totals[k] = round(self.lp_totals.get(k, 0) + v, 6)
                for j in all_jobs:
                    p = int(j[0].shape[0])
                    self.pad_real += p
                    self.pad_slots += _pad_class(p)
            pos = 0
            for w in batch:
                n = len(w.jobs)
                w.results = packed[pos : pos + n]
                w.flags = flags[pos : pos + n]
                pos += n
        except BaseException as err:  # noqa: BLE001 — every waiter wakes with the error
            for w in batch:
                w.error = err
        finally:
            with self._cv:
                for w in batch:
                    w.done = True
                self._cv.notify_all()

    def summary(self) -> dict:
        with self._cv:
            waste = round(1.0 - self.pad_real / self.pad_slots, 4) if self.pad_slots else 0.0
            out = {
                "flushes": self.flushes,
                "pack_calls": self.calls,
                "jobs": self.jobs_in,
                "max_occupancy": self.max_occupancy,
                "padding_waste": waste,
            }
            if self.lp_totals:
                out["lp"] = dict(self.lp_totals)
            return out


class _CoalescingBackend(PackBackend):
    """A tenant thread's facade over the dispatcher; its job token is the
    real backend's, so job keys (and the content plane) do not depend on
    the engine."""

    name = "fleet"

    def __init__(self, dispatcher: _MegaDispatcher):
        super().__init__()
        self._dispatcher = dispatcher
        self.last_stats: dict = {}

    def job_token(self, device=None) -> tuple:
        return self._dispatcher.target_token(device)

    def pack_jobs(self, jobs, metas, device=None, stats=None, mesh=None):
        if mesh is not None:
            # under a mesh the lane packs on its own thread: the pod-axis
            # padding a mega job records (solver/sharding.py) belongs to
            # this tenant's solve, never to a flushing thread's
            results, flags = self._dispatcher.pack_alone(jobs, metas, device, mesh)
        else:
            results, flags = self._dispatcher.submit(jobs, metas, device)
        self.last_job_flags = flags
        return results


# -- the fleet engine -------------------------------------------------------------


class TenantOutcome:
    """One tenant's result of one round."""

    __slots__ = ("result", "error", "ms", "pods")

    def __init__(self, result=None, error: Optional[str] = None, ms: float = 0.0, pods: int = 0):
        self.result = result
        self.error = error
        self.ms = ms
        self.pods = pods


class FleetEngine:
    """Runs fleet rounds: {tenant_id: pending pods} in, {tenant_id:
    TenantOutcome} out. ``engine`` (``batched`` | ``solo``) fixes the
    engine; None reads ``KARPENTER_TORCH_FLEET_ENGINE`` each round."""

    def __init__(self, registry, metrics=None, engine: Optional[str] = None):
        if engine is not None and engine not in ENGINES:
            raise ValueError(f"unknown fleet engine {engine!r} (batched | solo)")
        self.registry = registry
        self.metrics = metrics
        self.engine = engine
        self.skeletons = SkeletonPlane()
        # a tenant's warm-state restore (registry.add_tenant) also fills
        # this engine's content plane
        registry.engine = self
        self._mu = threading.Lock()
        self._round = 0
        self.last_round: dict = {}
        self.last_dispatch: dict = {}
        self._label_cap = max(1, int(FLEET_TENANT_LABELS))
        self._labeled: set = set()

    def engine_name(self) -> str:
        return self.engine or fleet_engine_name()

    def _tenant_label(self, tenant_id: str) -> str:
        with self._mu:
            if tenant_id in self._labeled:
                return tenant_id
            if len(self._labeled) < self._label_cap:
                self._labeled.add(tenant_id)
                return tenant_id
            return "_other"

    def _solve_tenant(self, tenant_id: str, pods: list, engine: str, links: Optional[list] = None) -> TenantOutcome:
        handle = self.registry.get(tenant_id)
        if handle is None:
            return TenantOutcome(error=f"unknown tenant {tenant_id!r}", pods=len(pods))
        t0 = time.perf_counter()
        try:
            result = handle.solver.solve(pods)
            out = TenantOutcome(result=result, ms=(time.perf_counter() - t0) * 1000.0, pods=len(pods))
            if links:
                # the submitters' contexts, linked onto the tenant solve's trace
                tid = handle.solver.last_trace_id
                tr = tracer.RING.get(tid) if tid else None
                if tr is not None:
                    for link in links:
                        tr.add_link(link, via="fleet.submit")
        except Exception as err:  # noqa: BLE001 — one tenant's failure must not fail the round
            out = TenantOutcome(
                error=f"{type(err).__name__}: {err}", ms=(time.perf_counter() - t0) * 1000.0, pods=len(pods)
            )
        self.registry.record_solve(tenant_id, len(pods), out.error)
        if self.metrics is not None:
            label = self._tenant_label(tenant_id)
            self.metrics.fleet_solves.inc(tenant=label, engine=engine)
            self.metrics.fleet_pods.inc(len(pods), tenant=label)
        return out

    def solve_round(self, work: Dict[str, list], links: Optional[Dict[str, list]] = None) -> Dict[str, TenantOutcome]:
        """One fleet round over {tenant_id: pods}. ``links``: per tenant,
        the submitters' trace ids to link onto its solve's trace."""
        engine = self.engine_name()
        t0 = time.perf_counter()
        order = sorted(work)
        links = links or {}
        self.registry.plane.activate(engine == "batched")
        for tid in order:
            handle = self.registry.get(tid)
            if handle is not None:
                handle.solver.fleet_plane = self.skeletons if engine == "batched" else None
        if engine == "solo":
            outcomes = {tid: self._solve_tenant(tid, work[tid], engine, links.get(tid)) for tid in order}
            dispatch: dict = {}
        else:
            outcomes, dispatch = self._solve_batched(work, order, engine, links)
        dt = time.perf_counter() - t0
        with self._mu:
            self._round += 1
            self.last_dispatch = dispatch
            self.last_round = {
                "round": self._round,
                "engine": engine,
                "tenants": len(order),
                "pods": sum(len(p) for p in work.values()),
                "ms": round(dt * 1000.0, 3),
                "errors": {t: o.error for t, o in outcomes.items() if o.error},
                "composition": [
                    {"tenant": t, "pods": len(work[t]), "ms": round(outcomes[t].ms, 3)} for t in order
                ],
                "dispatch": dispatch,
            }
        if self.metrics is not None:
            self.metrics.fleet_round_duration.observe(dt, engine=engine)
            if dispatch:
                self.metrics.fleet_batch_occupancy.set(float(dispatch.get("max_occupancy", 0)))
                self.metrics.fleet_padding_waste.set(float(dispatch.get("padding_waste", 0.0)))
        return outcomes

    def _solve_batched(
        self, work: Dict[str, list], order: List[str], engine: str, links: Dict[str, list]
    ) -> Tuple[Dict[str, TenantOutcome], dict]:
        dispatcher = _MegaDispatcher(backends_mod.active_backend())
        outcomes: Dict[str, TenantOutcome] = {}
        out_mu = threading.Lock()
        queue = list(order)
        q_mu = threading.Lock()

        def next_tenant() -> Optional[str]:
            with q_mu:
                return queue.pop(0) if queue else None

        def run_worker() -> None:
            dispatcher.worker_begin()
            backends_mod.set_thread_backend(_CoalescingBackend(dispatcher))
            try:
                while True:
                    tid = next_tenant()
                    if tid is None:
                        return
                    out = self._solve_tenant(tid, work[tid], engine, links.get(tid))
                    with out_mu:
                        outcomes[tid] = out
            finally:
                backends_mod.set_thread_backend(None)
                dispatcher.worker_end()

        n_workers = min(len(order), max(1, int(FLEET_WORKERS)))
        threads = [
            threading.Thread(target=run_worker, name=f"fleet-worker-{i}", daemon=True)
            for i in range(max(n_workers, 1))
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + FLEET_JOIN_TIMEOUT_S
        stragglers = 0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                stragglers += 1
        summary = dispatcher.summary()
        summary["join_timeouts"] = stragglers
        if stragglers:
            with out_mu:
                for tid in order:
                    if tid not in outcomes:
                        outcomes[tid] = TenantOutcome(error="fleet worker join timed out", pods=len(work[tid]))
        return outcomes, summary

    def debug_state(self) -> dict:
        with self._mu:
            last_round = dict(self.last_round)
        return {
            "engine": self.engine_name(),
            "registry": self.registry.debug_state(),
            "catalog_plane": self.registry.plane.debug_state(),
            "skeleton_plane": len(self.skeletons),
            "last_round": last_round,
        }
