"""Volume topology injection: rewrite a pod's node affinity with the zone
requirements of its bound or dynamic PVCs (ref
pkg/controllers/provisioning/scheduling/volumetopology.go).

Counterpart of ``karpenter_core_tpu/scheduler/volumetopology.py``
without ``validate_persistent_volume_claims``, which belongs to the
provisioner."""

from __future__ import annotations

from typing import List

from ..apis import labels as wk
from ..kube.objects import (
    OP_IN,
    Affinity,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
)


class VolumeTopology:
    def __init__(self, kube_client):
        self.kube_client = kube_client

    def inject(self, pod: Pod) -> None:
        """Add zone requirements from the pod's PVCs into every required
        node-affinity term (volumetopology.go:42 Inject)."""
        requirements: List[NodeSelectorRequirement] = []
        for volume in pod.spec.volumes:
            requirements.extend(self._requirements_for_volume(pod, volume))
        if not requirements:
            return
        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        na = pod.spec.affinity.node_affinity
        if na.required is None:
            na.required = NodeSelector()
        if not na.required.node_selector_terms:
            na.required.node_selector_terms = [NodeSelectorTerm()]
        # zone requirements apply to every OR'd term (volumetopology.go:66-76)
        for term in na.required.node_selector_terms:
            term.match_expressions = term.match_expressions + requirements
        # an in-place spec change without a resource_version bump: drop
        # the pod's scheduling memo (the podcache invariant) so signature
        # grouping sees the injected zone affinity
        pod.__dict__.pop("_karp_memo", None)

    def _requirements_for_volume(self, pod: Pod, volume) -> List[NodeSelectorRequirement]:
        if volume.persistent_volume_claim:
            pvc = self.kube_client.get(
                "PersistentVolumeClaim", volume.persistent_volume_claim, namespace=pod.namespace
            )
            if pvc is None:
                return []
            # bound PV zones win; else the storage class's allowed topologies
            if pvc.volume_name:
                pv = self.kube_client.get("PersistentVolume", pvc.volume_name)
                if pv is not None and pv.zones:
                    return [NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, OP_IN, list(pv.zones))]
            if pvc.storage_class_name:
                sc = self.kube_client.get("StorageClass", pvc.storage_class_name)
                if sc is not None and sc.zones:
                    return [NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, OP_IN, list(sc.zones))]
        return []
