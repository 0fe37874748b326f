"""NodeClaim lifecycle: Launch → Registration → Initialization, with a
Liveness TTL (ref pkg/controllers/nodeclaim/lifecycle/).

The port's copy of ``karpenter_core_tpu/lifecycle/nodeclaim_lifecycle.py``."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..apis import labels as wk
from ..apis.nodeclaim import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
)
from ..cloudprovider.types import (
    CloudProvider,
    InsufficientCapacityError,
    NodeClassNotReadyError,
)
from ..kube.objects import Node, OwnerReference
from ..scheduling.requirements import node_selector_requirements
from ..scheduling.taints import KNOWN_EPHEMERAL_TAINTS, Taints

REGISTRATION_TTL = 15 * 60  # liveness.go:39 registrationTTL


class NodeClaimLifecycleController:
    """lifecycle/controller.go:59-124: adds the termination finalizer then
    runs the four sub-reconcilers."""

    def __init__(
        self,
        kube_client,
        cloud_provider: CloudProvider,
        recorder=None,
        # analysis: allow-clock(registration TTL vs persisted claim creation wall-clock stamps)
        clock: Callable[[], float] = time.time,
        metrics=None,
    ):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.clock = clock
        self.metrics = metrics
        # launch result cache: survives status-patch races (launch.go:40)
        self._launch_cache: Dict[str, NodeClaim] = {}

    def reconcile(self, node_claim: NodeClaim) -> Optional[str]:
        """Returns a requeue reason or None."""
        if node_claim.metadata.deletion_timestamp is not None:
            return None
        if wk.TERMINATION_FINALIZER not in node_claim.metadata.finalizers:
            node_claim.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
        for step in (self._launch, self._registration, self._initialization, self._liveness):
            result = step(node_claim)
            if result == "deleted":
                return None
            if result is not None:
                return result
        self.kube_client.apply(node_claim)
        return None

    def reconcile_all(self) -> None:
        for nc in self.kube_client.list("NodeClaim"):
            self.reconcile(nc)

    # -- launch (launch.go:44) ---------------------------------------------

    def _launch(self, nc: NodeClaim) -> Optional[str]:
        if nc.status_condition_is_true(COND_LAUNCHED):
            # launch is durable in status now; the race-guard cache entry
            # can go (prevents unbounded growth across node churn)
            self._launch_cache.pop(nc.uid, None)
            return None
        created = self._launch_cache.get(nc.uid)
        if created is None:
            try:
                created = self.cloud_provider.create(nc)
            except InsufficientCapacityError as e:
                if self.recorder is not None:
                    from ..events import events as ev

                    self.recorder.publish(ev.insufficient_capacity(nc, e))
                self.kube_client.delete(nc)
                if self.metrics is not None:
                    self.metrics.nodeclaims_terminated.inc(
                        reason="insufficient_capacity",
                        nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                    )
                return "deleted"
            except NodeClassNotReadyError:
                nc.set_condition(COND_LAUNCHED, "False", "LaunchFailed", "node class not ready")
                return "requeue"
            except Exception as e:  # noqa: BLE001 — recorded as failed launch
                nc.set_condition(COND_LAUNCHED, "False", "LaunchFailed", str(e)[:300])
                return f"launching nodeclaim, {e}"
        self._launch_cache[nc.uid] = created
        self._populate_details(nc, created)
        nc.set_condition(COND_LAUNCHED, "True")
        if self.metrics is not None:
            self.metrics.nodeclaims_launched.inc(
                nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
        return None

    @staticmethod
    def _populate_details(nc: NodeClaim, created: NodeClaim) -> None:
        """launch.go:107 PopulateNodeClaimDetails: provider labels, then
        single-value requirement labels, then user labels (priority asc)."""
        req_labels = node_selector_requirements(nc.spec.requirements).labels()
        nc.metadata.labels = {
            **created.metadata.labels,
            **req_labels,
            **nc.metadata.labels,
        }
        nc.metadata.annotations = {**nc.metadata.annotations, **created.metadata.annotations}
        nc.status.provider_id = created.status.provider_id
        nc.status.image_id = created.status.image_id
        nc.status.allocatable = dict(created.status.allocatable)
        nc.status.capacity = dict(created.status.capacity)

    # -- registration (registration.go:42) ---------------------------------

    def _registration(self, nc: NodeClaim) -> Optional[str]:
        if nc.status_condition_is_true(COND_REGISTERED):
            return None
        if not nc.status_condition_is_true(COND_LAUNCHED):
            nc.set_condition(COND_REGISTERED, "False", "NotLaunched", "Node not launched")
            return None
        nodes = [
            n
            for n in self.kube_client.list("Node")
            if n.spec.provider_id == nc.status.provider_id
        ]
        if not nodes:
            nc.set_condition(COND_REGISTERED, "False", "NodeNotFound", "Node not registered with cluster")
            return None
        if len(nodes) > 1:
            nc.set_condition(
                COND_REGISTERED, "False", "MultipleNodesFound", "Invariant violated, matched multiple nodes"
            )
            return None
        node = nodes[0]
        self._sync_node(nc, node)
        nc.set_condition(COND_REGISTERED, "True")
        nc.status.node_name = node.name
        if self.metrics is not None:
            self.metrics.nodeclaims_registered.inc(
                nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
            self.metrics.nodes_created.inc(
                nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
        return None

    def _sync_node(self, nc: NodeClaim, node: Node) -> None:
        """registration.go:80 syncNode: finalizer, owner ref, labels,
        annotations, taint merge, registered label."""
        if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
        node.metadata.owner_references = [
            OwnerReference(
                api_version="karpenter.sh/v1beta1",
                kind="NodeClaim",
                name=nc.name,
                uid=nc.uid,
                controller=True,
                block_owner_deletion=True,
            )
        ]
        node.metadata.labels.update(nc.metadata.labels)
        node.metadata.annotations.update(nc.metadata.annotations)
        node.spec.taints = Taints(node.spec.taints).merge(nc.spec.taints)
        node.spec.taints = Taints(node.spec.taints).merge(nc.spec.startup_taints)
        node.metadata.labels[wk.NODE_REGISTERED_LABEL_KEY] = "true"
        self.kube_client.apply(node)

    # -- initialization (initialization.go:46) -----------------------------

    def _initialization(self, nc: NodeClaim) -> Optional[str]:
        if nc.status_condition_is_true(COND_INITIALIZED):
            return None
        if not nc.status_condition_is_true(COND_LAUNCHED):
            nc.set_condition(COND_INITIALIZED, "False", "NotLaunched", "Node not launched")
            return None
        node = self._node_for(nc)
        if node is None:
            nc.set_condition(COND_INITIALIZED, "False", "NodeNotFound", "Node not registered with cluster")
            return None
        if not _node_ready(node):
            nc.set_condition(COND_INITIALIZED, "False", "NodeNotReady", "Node status is NotReady")
            return None
        for startup in nc.spec.startup_taints:
            if any(startup.match(t) for t in node.spec.taints):
                nc.set_condition(
                    COND_INITIALIZED, "False", "StartupTaintsExist", f"StartupTaint {startup.key} still exists"
                )
                return None
        for known in KNOWN_EPHEMERAL_TAINTS:
            if any(known.match(t) for t in node.spec.taints):
                nc.set_condition(
                    COND_INITIALIZED, "False", "KnownEphemeralTaintsExist", f"Taint {known.key} still exists"
                )
                return None
        for resource_name, qty in nc.spec.resources.requests.items():
            if qty == 0:
                continue
            # extended resources must be registered by device plugins before
            # the node counts as initialized (initialization.go:120-135)
            if node.status.allocatable.get(resource_name, 0) == 0 and resource_name not in (
                "cpu",
                "memory",
                "pods",
                "ephemeral-storage",
            ):
                nc.set_condition(
                    COND_INITIALIZED, "False", "ResourceNotRegistered", f"Resource {resource_name} not registered"
                )
                return None
        node.metadata.labels[wk.NODE_INITIALIZED_LABEL_KEY] = "true"
        self.kube_client.apply(node)
        nc.set_condition(COND_INITIALIZED, "True")
        if self.metrics is not None:
            self.metrics.nodeclaims_initialized.inc(
                nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
        return None

    # -- liveness (liveness.go:32) -----------------------------------------

    def _liveness(self, nc: NodeClaim) -> Optional[str]:
        if nc.status_condition_is_true(COND_REGISTERED):
            return None
        ttl_start = nc.metadata.creation_timestamp
        if self.clock() - ttl_start < REGISTRATION_TTL:
            return None
        # failed to register within the TTL: delete and let provisioning retry
        self._launch_cache.pop(nc.uid, None)
        self.kube_client.delete(nc)
        if self.metrics is not None:
            self.metrics.nodeclaims_terminated.inc(
                reason="liveness",
                nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
            )
        return "deleted"

    def _node_for(self, nc: NodeClaim) -> Optional[Node]:
        for n in self.kube_client.list("Node"):
            if n.spec.provider_id == nc.status.provider_id:
                return n
        return None


def _node_ready(node: Node) -> bool:
    for c in node.status.conditions:
        if c.type == "Ready":
            return c.status == "True"
    return False
