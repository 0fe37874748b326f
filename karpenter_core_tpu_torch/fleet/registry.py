"""Tenant registry: per-tenant control-plane handles, strictly isolated.

Counterpart of ``karpenter_core_tpu/fleet/registry.py``. One registry
holds every tenant the fleet serves, all on the registry's one device
(``device=``; None: the card, and it raises without one). Each tenant
gets its own ``TorchScheduler`` with a tenant scope on that device, its
own pinned ``WarmState`` and its own decision-latency tracker. Isolation
is structural:

- a cloud provider or cluster object registered to one tenant is
  refused for any other (generation counters are per object, so shared
  objects are how cross-tenant cache aliasing starts);
- the solver's tenant scope rides every identity- or generation-scoped
  memo key (seeds, job memo, warm-state resolution);
- the only cross-tenant sharing is the content plane (megasolve.py),
  content-addressed by construction.

Tenants read their catalogs through a ``TenantCatalogView``: their own
provider's catalog in solo rounds, the fleet's canonical content-deduped
copy in batched rounds.

With a warm-store directory (``warmstore_dir=``, default
``warmstore.WARMSTORE_DIR``), removing a tenant snapshots its planes and
re-admitting it restores them; ``add_tenant(..., restore_from=path)``
migrates a tenant from another registry. After a restore the admission
loads the libraries the tenant's solves launch
(``prewarm.warmup_compile_only``), so its first round builds nothing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..serving.latency import DecisionLatencyTracker
from ..solver import TorchScheduler
from ..solver.backend import resolve_device
from ..solver.incremental import WarmState

log = logging.getLogger("karpenter.torch.fleet")


class TenantHandle:
    """Everything the fleet holds for one tenant. The counters are guarded
    by the registry's lock."""

    def __init__(
        self,
        tenant_id: str,
        nodepools: list,
        provider,
        view,
        solver: TorchScheduler,
        cluster=None,
        kube_client=None,
        latency: Optional[DecisionLatencyTracker] = None,
    ):
        self.tenant_id = tenant_id
        self.nodepools = list(nodepools)
        self.provider = provider  # the tenant's own provider
        self.view = view  # what the solver reads
        self.solver = solver
        self.cluster = cluster
        self.kube_client = kube_client
        self.latency = latency or DecisionLatencyTracker()
        self.added_at = time.time()
        self.solves = 0
        self.pods_solved = 0
        self.last_error: Optional[str] = None
        # the admission prewarm's outcome, when admitted from a snapshot
        self.prewarm_replay: Optional[dict] = None

    def summary(self) -> dict:
        return {
            "tenant": self.tenant_id,
            "nodepools": [np_.metadata.name for np_ in self.nodepools],
            "solves": self.solves,
            "pods_solved": self.pods_solved,
            "pending": self.latency.pending_count(),
            "decided": self.latency.decided_count(),
            "last_error": self.last_error,
            "prewarm_replay": self.prewarm_replay,
        }


class FleetRegistry:
    """Thread-safe tenant directory; adds and removes are steady-state
    operations (the fleet scheduler runs on through them)."""

    def __init__(self, plane=None, metrics=None, warmstore_dir=None, device=None):
        from ..solver import warmstore
        from .megasolve import CatalogPlane

        self.device = resolve_device(device)
        self._mu = threading.RLock()
        self._tenants: Dict[str, TenantHandle] = {}
        # object-identity ledgers behind the no-sharing rule
        self._provider_owner: Dict[int, str] = {}
        self._cluster_owner: Dict[int, str] = {}
        # tenants mid-admission: reserved under _mu, so a concurrent
        # duplicate add fails fast while the slow part runs unlocked
        self._admitting: set = set()
        self.plane = plane or CatalogPlane()
        self.metrics = metrics
        self.generation = 0  # bumped by add and remove
        self.warmstore_dir = warmstore_dir or warmstore.WARMSTORE_DIR
        self.evicted_snapshots: Dict[str, str] = {}
        # the FleetEngine serving this registry (its constructor attaches
        # it): a tenant's restore also fills its content plane
        self.engine = None

    def _engine_name(self) -> str:
        from .megasolve import fleet_engine_name

        return self.engine.engine_name() if self.engine is not None else fleet_engine_name()

    # -- membership ----------------------------------------------------------

    def add_tenant(
        self,
        tenant_id: str,
        nodepools: list,
        provider,
        cluster=None,
        kube_client=None,
        restore_from: Optional[str] = None,
    ) -> TenantHandle:
        """Register a tenant. ``restore_from`` (a snapshot path, such as
        another registry's ``snapshot_tenant``; else this registry's own
        snapshot taken at the tenant's eviction) restores its planes, so
        its first round is warm."""
        from .megasolve import TenantCatalogView

        tenant_id = str(tenant_id)
        # phase 1, locked: validate and reserve
        with self._mu:
            if tenant_id in self._tenants or tenant_id in self._admitting:
                raise ValueError(f"tenant {tenant_id!r} already registered")
            owner = self._provider_owner.get(id(provider))
            if owner is not None:
                raise ValueError(
                    f"cloud provider already registered to tenant {owner!r} — tenants must not share "
                    "provider objects (per-object generation counters would alias their caches)"
                )
            if cluster is not None:
                c_owner = self._cluster_owner.get(id(cluster))
                if c_owner is not None:
                    raise ValueError(
                        f"cluster already registered to tenant {c_owner!r} — tenants must not share cluster state"
                    )
            self._admitting.add(tenant_id)
            self._provider_owner[id(provider)] = tenant_id
            if cluster is not None:
                self._cluster_owner[id(cluster)] = tenant_id
            path = restore_from or self.evicted_snapshots.pop(tenant_id, None)
            popped_eviction = path is not None and restore_from is None

        # phase 2, unlocked: the solver, the catalog prewarm, the restore
        # and the library loads; a failure rolls the reservation back
        published = False
        try:
            view = TenantCatalogView(provider, self.plane, tenant_id)
            solver = TorchScheduler(
                nodepools, view, device=self.device, kube_client=kube_client, cluster=cluster, tenant=tenant_id
            )
            # one pinned WarmState per tenant: isolation, and a home other
            # tenants' churn cannot evict
            solver.warm_state_pin = WarmState(view)
            handle = TenantHandle(
                tenant_id, nodepools, provider, view, solver, cluster=cluster, kube_client=kube_client
            )
            self.plane.prewarm(tenant_id, provider, nodepools)
            if path is not None:
                solver.fleet_plane = self.engine.skeletons if self.engine is not None else None
                # catalogs resolve as the engine's rounds resolve them, so
                # the restored entries rebind to the objects the first
                # round's encode looks up
                was_active = self.plane.active()
                self.plane.activate(self._engine_name() == "batched")
                try:
                    solver.restore(path)
                finally:
                    self.plane.activate(was_active)
                    solver.fleet_plane = None
                from ..solver import prewarm

                try:
                    handle.prewarm_replay = prewarm.warmup_compile_only(solver)
                except Exception:  # noqa: BLE001 — the prewarm must never fail admission
                    log.exception("tenant %s admission prewarm failed", tenant_id)

            # phase 3, locked: publish
            with self._mu:
                self._tenants[tenant_id] = handle
                self._admitting.discard(tenant_id)
                self.generation += 1
                published = True
            return handle
        finally:
            if not published:
                with self._mu:
                    self._admitting.discard(tenant_id)
                    if self._provider_owner.get(id(provider)) == tenant_id:
                        del self._provider_owner[id(provider)]
                    if cluster is not None and self._cluster_owner.get(id(cluster)) == tenant_id:
                        del self._cluster_owner[id(cluster)]
                    if popped_eviction:
                        # the snapshot file is still there: keep it retryable
                        self.evicted_snapshots.setdefault(tenant_id, path)

    def snapshot_tenant(self, tenant_id: str, directory: Optional[str] = None) -> Optional[str]:
        """Snapshot one tenant's planes → path (None: unknown tenant or
        persistence off). The snapshot carries the tenant scope, so
        another registry's ``add_tenant(..., restore_from=path)``
        migrates the tenant warm."""
        with self._mu:
            handle = self._tenants.get(str(tenant_id))
        if handle is None:
            return None
        was_active = self.plane.active()
        self.plane.activate(self._engine_name() == "batched")
        try:
            return handle.solver.snapshot(directory=directory or self.warmstore_dir)
        finally:
            self.plane.activate(was_active)

    def snapshot_plane(self, directory: Optional[str] = None) -> Optional[str]:
        """Snapshot the canonical-catalog plane → path."""
        from ..solver import warmstore

        return warmstore.snapshot_fleet_plane(self.plane, directory or self.warmstore_dir)

    def restore_plane(self, path: str) -> dict:
        from ..solver import warmstore

        return warmstore.restore_fleet_plane(self.plane, path)

    def remove_tenant(self, tenant_id: str) -> bool:
        """Drop a tenant and its pinned caches; an in-flight round that
        holds the handle finishes its solve. With a warm-store directory
        the tenant's planes are snapshotted first, for its re-admission."""
        tenant_id = str(tenant_id)
        if self.warmstore_dir:
            path = self.snapshot_tenant(tenant_id)
            if path is not None:
                with self._mu:
                    self.evicted_snapshots[tenant_id] = path
        with self._mu:
            handle = self._tenants.pop(tenant_id, None)
            if handle is None:
                return False
            self._provider_owner.pop(id(handle.provider), None)
            if handle.cluster is not None:
                self._cluster_owner.pop(id(handle.cluster), None)
            self.generation += 1
            return True

    # -- lookup ----------------------------------------------------------------

    def get(self, tenant_id: str) -> Optional[TenantHandle]:
        with self._mu:
            return self._tenants.get(str(tenant_id))

    def tenant_ids(self) -> List[str]:
        with self._mu:
            return sorted(self._tenants)

    def __len__(self) -> int:
        with self._mu:
            return len(self._tenants)

    def record_solve(self, tenant_id: str, pods: int, error: Optional[str] = None) -> None:
        with self._mu:
            handle = self._tenants.get(tenant_id)
            if handle is None:
                return
            handle.solves += 1
            handle.pods_solved += pods
            handle.last_error = error

    def debug_state(self) -> dict:
        with self._mu:
            return {
                "generation": self.generation,
                "device": str(self.device),
                "tenants": [h.summary() for _, h in sorted(self._tenants.items())],
            }
