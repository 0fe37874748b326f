"""CSI volume counting against per-driver limits (ref
pkg/scheduling/volumeusage.go, storageclass.go).

The reference resolves a pod's PVCs → storage class → CSI driver, then
counts mounted volumes per driver against the node's reported CSI limit.
The port carries the per-node usage a ``StateNode`` holds; resolving a
pod's volumes needs a kube client and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..kube.objects import Pod


class Volumes(Dict[str, Set[str]]):
    """driver name → set of pvc ids (volumeusage.go:40)."""

    def add(self, provisioner: str, pvc_id: str) -> None:
        self.setdefault(provisioner, set()).add(pvc_id)

    def union(self, other: "Volumes") -> "Volumes":
        out = Volumes()
        for k, v in self.items():
            out[k] = set(v)
        for k, v in other.items():
            out.setdefault(k, set()).update(v)
        return out

    def insert(self, other: "Volumes") -> None:
        for k, v in other.items():
            self.setdefault(k, set()).update(v)


class VolumeUsage:
    """Per-node mounted-volume tracking vs CSI limits (volumeusage.go:170+)."""

    def __init__(self, csi_limits: Optional[Dict[str, int]] = None) -> None:
        self.volumes = Volumes()
        self.pod_volumes: Dict[tuple, Volumes] = {}
        self.csi_limits = csi_limits or {}

    def add(self, pod: Pod, volumes: Volumes) -> None:
        self.pod_volumes[(pod.namespace, pod.name)] = volumes
        self.volumes.insert(volumes)

    def exceeds_limits(self, volumes: Volumes) -> Optional[str]:
        """Error string if mounting `volumes` would pass a driver limit."""
        would_be = self.volumes.union(volumes)
        for driver, vols in would_be.items():
            limit = self.csi_limits.get(driver)
            if limit is not None and len(vols) > limit:
                return f"would exceed volume limit for CSI driver {driver}, {len(vols)} > {limit}"
        return None

    def delete_pod(self, namespace: str, name: str) -> None:
        self.pod_volumes.pop((namespace, name), None)
        rebuilt = Volumes()
        for v in self.pod_volumes.values():
            rebuilt.insert(v)
        self.volumes = rebuilt

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage(dict(self.csi_limits))
        # share the per-pod Volumes values (add() assigns them whole and
        # insert/union only read them); the aggregate is rebuilt fresh
        # because insert() mutates its sets in place
        out.pod_volumes = dict(self.pod_volumes)
        for v in out.pod_volumes.values():
            out.volumes.insert(v)
        return out
