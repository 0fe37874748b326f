"""CSI volume counting against per-driver limits (ref
pkg/scheduling/volumeusage.go, storageclass.go).

The reference resolves a pod's PVCs → storage class → CSI driver, then
counts mounted volumes per driver against the node's reported CSI limit.
The port carries the per-node usage a ``StateNode`` holds and the
resolution chain against its ``KubeClient``.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..kube.objects import Pod

DEFAULT_STORAGE_CLASS_ANNOTATION = "storageclass.kubernetes.io/is-default-class"


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


def get_volumes(kube_client, pod: Pod) -> Volumes:
    """Resolve the pod's PVC-backed volumes to CSI drivers
    (volumeusage.go:79 GetVolumes)."""
    vols = Volumes()
    default_sc = _default_storage_class(kube_client)
    for volume in pod.spec.volumes:
        if volume.persistent_volume_claim:
            pvc = kube_client.get("PersistentVolumeClaim", volume.persistent_volume_claim, namespace=pod.namespace)
            if pvc is None:
                raise KeyError(f"pvc {pod.namespace}/{volume.persistent_volume_claim} not found")
            pvc_id = f"{pod.namespace}/{volume.persistent_volume_claim}"
            sc_name = pvc.storage_class_name or default_sc
            volume_name = pvc.volume_name
        elif volume.ephemeral:
            # https://kubernetes.io/docs/concepts/storage/ephemeral-volumes/#persistentvolumeclaim-naming
            pvc_id = f"{pod.namespace}/{pod.name}-{volume.name}"
            sc_name = default_sc
            volume_name = ""
        else:
            continue
        driver = _resolve_driver(kube_client, volume_name, sc_name)
        if driver:
            vols.add(driver, pvc_id)
    return vols


def _default_storage_class(kube_client) -> Optional[str]:
    for sc in kube_client.list("StorageClass"):
        if sc.metadata.annotations.get(DEFAULT_STORAGE_CLASS_ANNOTATION) == "true":
            return sc.name
    return None


def _resolve_driver(kube_client, volume_name: str, storage_class_name: Optional[str]) -> str:
    """Bound PV's driver wins, else the storage class provisioner
    (volumeusage.go:121-160 resolveDriver)."""
    if volume_name:
        pv = kube_client.get("PersistentVolume", volume_name)
        if pv is not None and pv.driver:
            return pv.driver
    if storage_class_name:
        sc = kube_client.get("StorageClass", storage_class_name)
        if sc is not None:
            return sc.provisioner
    return ""


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
