"""kube-node-lease garbage collection (ref
pkg/controllers/leasegarbagecollection/controller.go:53-65): delete
orphaned node leases without owner references.

The port's copy of ``karpenter_core_tpu/lifecycle/lease_gc.py``."""

from __future__ import annotations


class LeaseGarbageCollectionController:
    def __init__(self, kube_client):
        self.kube_client = kube_client

    def reconcile(self) -> int:
        removed = 0
        for lease in self.kube_client.list("Lease", namespace="kube-node-lease"):
            if not lease.metadata.owner_references:
                self.kube_client.delete(lease)
                removed += 1
        return removed
