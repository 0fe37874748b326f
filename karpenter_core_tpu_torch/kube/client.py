"""In-memory Kubernetes API store.

Counterpart of ``karpenter_core_tpu/kube/client.py``: the object store
keyed by (kind, namespace, name) with the semantics controllers rely on:
get/list/create/update/delete, label-selector filtering, finalizer-aware
deletion, optimistic concurrency, admission hooks and watch callbacks.
The solver reads it for the bound pods that seed topology counts; the
cluster-state informers watch it; the provisioner creates its NodeClaims
in it.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from .objects import KubeObject, LabelSelector


class Conflict(Exception):
    pass


class NotFound(Exception):
    pass


# watch event types
ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"


class KubeClient:
    """Thread-safe in-memory object store keyed by (kind, namespace, name).

    ``clock`` stamps deletion timestamps; inject the same clock the
    controllers use so timestamp comparisons agree under simulated time.
    """

    # analysis: allow-clock(object-stamps — creation/deletionTimestamp are persisted wall clock by k8s protocol)
    def __init__(self, clock: Callable[[], float] = time.time) -> None:
        self._objects: Dict[str, Dict[tuple, KubeObject]] = defaultdict(dict)
        self._watchers: Dict[str, List[Callable]] = defaultdict(list)
        self._lock = threading.RLock()
        self._rv = 0
        self.clock = clock
        # admission chain (defaulting + validating webhooks / CEL equivalent,
        # ref pkg/webhooks/webhooks.go:57-87): callables run on create/update
        # before the object is stored; they may mutate (defaults) or raise.
        self.admission: List[Callable[[KubeObject], None]] = []

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _key(obj: KubeObject) -> tuple:
        return (obj.namespace, obj.name)

    def _notify(self, event: str, obj: KubeObject) -> None:
        # deliberately outside self._lock: watch callbacks reenter the
        # client (informers re-list, controllers read state) and would
        # deadlock or invert lock order if notified under it
        for cb in list(self._watchers.get(obj.kind, ())):  # analysis: allow-lock-discipline — a copy, notified outside the lock (above)
            cb(event, obj)

    # -- CRUD --------------------------------------------------------------

    def create(self, obj: KubeObject) -> KubeObject:
        for adm in self.admission:
            adm(obj)
        with self._lock:
            kind = obj.kind
            key = self._key(obj)
            if key in self._objects[kind]:
                raise Conflict(f"{kind} {key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[kind][key] = obj
        self._notify(ADDED, obj)
        return obj

    def get(self, kind: str, name: str, namespace: str = "") -> Optional[KubeObject]:
        with self._lock:
            return self._objects[kind].get((namespace, name))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
        filter_fn: Optional[Callable[[KubeObject], bool]] = None,
    ) -> List[KubeObject]:
        with self._lock:
            objs = list(self._objects[kind].values())
        if namespace is not None:
            objs = [o for o in objs if o.namespace == namespace]
        if label_selector is not None:
            objs = [o for o in objs if label_selector.matches(o.metadata.labels)]
        if filter_fn is not None:
            objs = [o for o in objs if filter_fn(o)]
        return objs

    def update(self, obj: KubeObject) -> KubeObject:
        for adm in self.admission:
            adm(obj)
        with self._lock:
            kind = obj.kind
            key = self._key(obj)
            stored = self._objects[kind].get(key)
            if stored is None:
                raise NotFound(f"{kind} {key} not found")
            # optimistic concurrency, apiserver-style: an update carrying a
            # resourceVersion must match the stored one; an unset (0)
            # resourceVersion is an unconditional update. Same-instance
            # updates (the in-memory sharing model) always match.
            if (
                stored is not obj
                and obj.metadata.resource_version
                and obj.metadata.resource_version != stored.metadata.resource_version
            ):
                raise Conflict(
                    f"{kind} {key}: object has been modified "
                    f"(resourceVersion {obj.metadata.resource_version} != "
                    f"{stored.metadata.resource_version})"
                )
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[kind][key] = obj
        self._notify(MODIFIED, obj)
        return obj

    def apply(self, obj: KubeObject) -> KubeObject:
        """Create-or-update convenience. The existence probe holds
        ``_lock`` but the write itself must not: update/create deliver
        watch callbacks through ``_notify``, and holding the lock across
        them would invert the client/controller lock order (see
        ``_notify``). A racing create or delete between probe and write
        is absorbed by retrying in the other mode."""
        for _ in range(3):
            with self._lock:
                exists = self._key(obj) in self._objects[obj.kind]
            try:
                return self.update(obj) if exists else self.create(obj)
            except NotFound:
                continue  # deleted between probe and update → retry as create
            except Conflict:
                if exists:
                    raise  # genuine resourceVersion conflict
                continue  # created between probe and create → retry as update
        return self.update(obj)

    def retry_on_conflict(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        mutate: Callable[[KubeObject], None] = lambda obj: None,
        attempts: int = 5,
    ) -> KubeObject:
        """controller-runtime ``RetryOnConflict`` equivalent: GET, apply
        ``mutate``, UPDATE; on Conflict re-GET the current version and
        retry. The store's controllers share instances and never conflict;
        adapters over a real apiserver (which hand out copies) do."""
        last: Optional[Conflict] = None
        for _ in range(attempts):
            obj = self.get(kind, name, namespace=namespace)
            if obj is None:
                raise NotFound(f"{kind} ({namespace!r}, {name!r}) not found")
            # mutate a copy so a rejected write (conflict, admission)
            # leaves the stored instance untouched — the copy's matching
            # resourceVersion lets a clean retry land
            obj = copy.deepcopy(obj)
            mutate(obj)
            try:
                return self.update(obj)
            except Conflict as err:
                last = err
        raise last if last is not None else Conflict(f"{kind} {name}: retries exhausted")

    def delete(self, obj_or_kind, name: str = "", namespace: str = "") -> bool:
        """Finalizer-aware delete: sets deletionTimestamp when finalizers
        remain, removes otherwise (apiserver semantics the termination
        controllers depend on)."""
        with self._lock:
            if isinstance(obj_or_kind, KubeObject):
                kind, key = obj_or_kind.kind, self._key(obj_or_kind)
            else:
                kind, key = obj_or_kind, (namespace, name)
            obj = self._objects[kind].get(key)
            if obj is None:
                return False
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = self.clock()
                    self._rv += 1
                    obj.metadata.resource_version = self._rv
                    modified = obj
                else:
                    return True
            else:
                del self._objects[kind][key]
                modified = None
        if modified is not None:
            self._notify(MODIFIED, modified)
        else:
            self._notify(DELETED, obj)
        return True

    def remove_finalizer(self, obj: KubeObject, finalizer: str) -> None:
        """Drop a finalizer; if the object is terminating and none remain,
        actually remove it."""
        with self._lock:
            if finalizer in obj.metadata.finalizers:
                obj.metadata.finalizers.remove(finalizer)
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                self._objects[obj.kind].pop(self._key(obj), None)
                gone = True
            else:
                self._rv += 1
                obj.metadata.resource_version = self._rv
                gone = False
        self._notify(DELETED if gone else MODIFIED, obj)

    # -- watches -----------------------------------------------------------

    def watch(self, kind: str, callback: Callable[[str, KubeObject], None]) -> Callable[[], None]:
        """Register a watch callback; returns an unsubscribe fn. New watches
        receive synthetic ADDED events for existing objects (informer
        list+watch semantics)."""
        with self._lock:
            existing = list(self._objects[kind].values())
            self._watchers[kind].append(callback)
        for obj in existing:
            callback(ADDED, obj)

        def unsubscribe():
            with self._lock:
                if callback in self._watchers[kind]:
                    self._watchers[kind].remove(callback)

        return unsubscribe
