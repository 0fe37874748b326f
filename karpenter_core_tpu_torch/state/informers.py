"""State informers: watch controllers feeding the Cluster cache (ref
pkg/controllers/state/informer/{node,pod,nodeclaim,nodepool,daemonset}.go,
plus CSINode for attach-limit hydration, volumeusage.go): the port's
copy of ``karpenter_core_tpu/state/informers.py``."""

from __future__ import annotations

from ..kube import client as kube


class Informers:
    """Wires KubeClient watches to Cluster.Update*/Delete* — the
    reference's five thin controllers plus the CSINode watch."""

    def __init__(self, kube_client: kube.KubeClient, cluster) -> None:
        self.kube_client = kube_client
        self.cluster = cluster
        self._unsubscribes = []

    def start(self) -> None:
        self._unsubscribes = [
            self.kube_client.watch("Node", self._on_node),
            self.kube_client.watch("NodeClaim", self._on_node_claim),
            self.kube_client.watch("Pod", self._on_pod),
            self.kube_client.watch("DaemonSet", self._on_daemonset),
            self.kube_client.watch("NodePool", self._on_nodepool),
            self.kube_client.watch("CSINode", self._on_csi_node),
        ]

    def stop(self) -> None:
        for unsub in self._unsubscribes:
            unsub()
        self._unsubscribes = []

    # -- handlers ----------------------------------------------------------

    def _on_node(self, event: str, obj) -> None:
        if event == kube.DELETED:
            self.cluster.delete_node(obj.name)
        else:
            self.cluster.update_node(obj)

    def _on_node_claim(self, event: str, obj) -> None:
        if event == kube.DELETED:
            self.cluster.delete_node_claim(obj.name)
        else:
            self.cluster.update_node_claim(obj)

    def _on_pod(self, event: str, obj) -> None:
        if event == kube.DELETED:
            self.cluster.delete_pod(obj.namespace, obj.name)
        else:
            self.cluster.update_pod(obj)

    def _on_daemonset(self, event: str, obj) -> None:
        if event == kube.DELETED:
            self.cluster.delete_daemonset(obj.namespace, obj.name)
        else:
            self.cluster.update_daemonset(obj)

    def _on_nodepool(self, event: str, obj) -> None:
        # any nodepool change can open consolidation options
        # (informer/nodepool.go)
        self.cluster.mark_unconsolidated()

    def _on_csi_node(self, event: str, obj) -> None:
        if event == kube.DELETED:
            self.cluster.delete_csi_node(obj.name)
        else:
            self.cluster.update_csi_node(obj)
