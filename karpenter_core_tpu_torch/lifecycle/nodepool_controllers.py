"""NodePool counter + hash controllers.

Counterpart of ``karpenter_core_tpu/lifecycle/nodepool_controllers.py``
(ref
pkg/controllers/nodepool/counter/controller.go,
pkg/controllers/nodepool/hash/controller.go)."""

from __future__ import annotations

from ..apis import labels as wk
from ..scheduling import resources


class NodePoolCounterController:
    """counter:61-97 — status.resources = Σ capacity of the pool's state
    nodes."""

    def __init__(self, kube_client, cluster):
        self.kube_client = kube_client
        self.cluster = cluster

    def reconcile(self, nodepool) -> None:
        totals = {}

        def visit(state_node) -> bool:
            nonlocal totals
            if state_node.nodepool_name() == nodepool.name:
                totals = resources.merge(totals, state_node.capacity())
            return True

        self.cluster.for_each_node(visit)
        nodepool.status.resources = totals
        self.kube_client.apply(nodepool)

    def reconcile_all(self) -> None:
        for np in self.kube_client.list("NodePool"):
            self.reconcile(np)


class NodePoolHashController:
    """hash:51-62 — stamp karpenter.sh/nodepool-hash for drift detection."""

    def __init__(self, kube_client):
        self.kube_client = kube_client

    def reconcile(self, nodepool) -> None:
        nodepool.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = nodepool.static_hash()
        self.kube_client.apply(nodepool)

    def reconcile_all(self) -> None:
        for np in self.kube_client.list("NodePool"):
            self.reconcile(np)
