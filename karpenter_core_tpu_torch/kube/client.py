"""In-memory Kubernetes API store.

Counterpart of ``karpenter_core_tpu/kube/client.py``: the object store
keyed by (kind, namespace, name) with label-selector listing, which the
solver reads to seed topology-spread domain counts from the pods already
bound in the cluster. The port carries create, get and list; updates,
deletion, admission hooks and watches belong to the controllers, which
are not ported yet.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional

from .objects import KubeObject, LabelSelector


class Conflict(Exception):
    pass


class KubeClient:
    """Thread-safe in-memory object store keyed by (kind, namespace, name)."""

    def __init__(self) -> None:
        self._objects: Dict[str, Dict[tuple, KubeObject]] = defaultdict(dict)
        self._lock = threading.RLock()
        self._rv = 0

    @staticmethod
    def _key(obj: KubeObject) -> tuple:
        return (obj.namespace, obj.name)

    def create(self, obj: KubeObject) -> KubeObject:
        with self._lock:
            key = self._key(obj)
            if key in self._objects[obj.kind]:
                raise Conflict(f"{obj.kind} {key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[obj.kind][key] = obj
        return obj

    def get(self, kind: str, name: str, namespace: str = "") -> Optional[KubeObject]:
        with self._lock:
            return self._objects[kind].get((namespace, name))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> List[KubeObject]:
        with self._lock:
            objs = list(self._objects[kind].values())
        if namespace is not None:
            objs = [o for o in objs if o.namespace == namespace]
        if label_selector is not None:
            objs = [o for o in objs if label_selector.matches(o.metadata.labels)]
        return objs
