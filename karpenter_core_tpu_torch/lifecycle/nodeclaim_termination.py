"""NodeClaim termination finalizer (ref
pkg/controllers/nodeclaim/termination/controller.go:66-100): delete Node
objects, then the cloud instance, then drop the finalizer.

The port's copy of ``karpenter_core_tpu/lifecycle/nodeclaim_termination.py``."""

from __future__ import annotations

from typing import Optional

from ..apis import labels as wk
from ..apis.nodeclaim import NodeClaim
from ..cloudprovider.types import CloudProvider, NodeClaimNotFoundError


class NodeClaimTerminationController:
    def __init__(self, kube_client, cloud_provider: CloudProvider, metrics=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.metrics = metrics

    def reconcile(self, node_claim: NodeClaim) -> Optional[str]:
        if node_claim.metadata.deletion_timestamp is None:
            return None
        if wk.TERMINATION_FINALIZER not in node_claim.metadata.finalizers:
            return None
        # delete any nodes linked by provider id; wait for them to go
        nodes = [
            n
            for n in self.kube_client.list("Node")
            if node_claim.status.provider_id
            and n.spec.provider_id == node_claim.status.provider_id
        ]
        if nodes:
            for n in nodes:
                self.kube_client.delete(n)
            return "waiting on node termination"
        if node_claim.status.provider_id:
            try:
                self.cloud_provider.delete(node_claim)
            except NodeClaimNotFoundError:
                pass
        self.kube_client.remove_finalizer(node_claim, wk.TERMINATION_FINALIZER)
        if self.metrics is not None:
            self.metrics.nodeclaims_terminated.inc(
                reason="deleted",
                nodepool=node_claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
            )
        return None

    def reconcile_all(self) -> None:
        for nc in self.kube_client.list("NodeClaim"):
            self.reconcile(nc)
