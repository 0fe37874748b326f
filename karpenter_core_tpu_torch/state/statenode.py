"""StateNode: the merged Node + NodeClaim view (ref
pkg/controllers/state/statenode.go), the port's copy of
``karpenter_core_tpu/state/statenode.py``.

A node's identity during its lifecycle is (NodeClaim?, Node?) — the
claim exists first, the node joins later, and either can be missing for
unmanaged nodes. All scheduling reads go through this merged view; the
solve reads labels, taints, initialization, capacity, allocatable,
available and the daemonset request total of each existing node.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..apis import labels as wk
from ..apis.nodeclaim import NodeClaim, NodeClaimSpec, NodeClaimStatus
from ..kube.objects import (
    Condition,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    ResourceList,
    Taint,
)
from ..scheduling import HostPortUsage, VolumeUsage, resources
from ..scheduling.taints import KNOWN_EPHEMERAL_TAINTS
from ..utils import pod as podutils

DISRUPTION_TAINT = podutils.DISRUPTION_NO_SCHEDULE_TAINT


# ---------------------------------------------------------------------------
# structural clones for deep_copy
#
# copy.deepcopy over the full Node/NodeClaim graphs is costly where every
# candidate/simulation pass copies the fleet. These hand-rolled clones
# copy exactly the containers the controllers mutate in place
# (metadata label/annotation/finalizer containers, taint LISTS,
# Condition objects — set_condition rewrites fields on the existing
# object — and capacity/allocatable dicts) and share everything treated
# as immutable after creation (Taint values, NodeSelectorRequirements,
# spec resources/kubelet refs, string/number leaves).


def _clone_meta(md):
    return ObjectMeta(
        name=md.name,
        namespace=md.namespace,
        uid=md.uid,
        labels=dict(md.labels),
        annotations=dict(md.annotations),
        finalizers=list(md.finalizers),
        owner_references=list(md.owner_references),
        creation_timestamp=md.creation_timestamp,
        deletion_timestamp=md.deletion_timestamp,
        resource_version=md.resource_version,
        generation=md.generation,
    )


def _clone_conditions(conds):
    return [
        Condition(
            type=c.type,
            status=c.status,
            reason=c.reason,
            message=c.message,
            last_transition_time=c.last_transition_time,
        )
        for c in conds
    ]


def _clone_node(n: Optional[Node]) -> Optional[Node]:
    if n is None:
        return None
    return Node(
        metadata=_clone_meta(n.metadata),
        spec=NodeSpec(
            provider_id=n.spec.provider_id,
            taints=list(n.spec.taints),
            unschedulable=n.spec.unschedulable,
        ),
        status=NodeStatus(
            capacity=dict(n.status.capacity),
            allocatable=dict(n.status.allocatable),
            conditions=_clone_conditions(n.status.conditions),
            phase=n.status.phase,
        ),
    )


def _clone_node_claim(c: Optional[NodeClaim]) -> Optional[NodeClaim]:
    if c is None:
        return None
    return NodeClaim(
        metadata=_clone_meta(c.metadata),
        spec=NodeClaimSpec(
            taints=list(c.spec.taints),
            startup_taints=list(c.spec.startup_taints),
            requirements=list(c.spec.requirements),
            resources=c.spec.resources,
            kubelet=c.spec.kubelet,
            node_class_ref=c.spec.node_class_ref,
        ),
        status=NodeClaimStatus(
            node_name=c.status.node_name,
            provider_id=c.status.provider_id,
            image_id=c.status.image_id,
            capacity=dict(c.status.capacity),
            allocatable=dict(c.status.allocatable),
            conditions=_clone_conditions(c.status.conditions),
        ),
    )


class StateNode:
    """statenode.go:78 — thread-safety is the Cluster's responsibility."""

    def __init__(self, node: Optional[Node] = None, node_claim: Optional[NodeClaim] = None):
        self.node = node
        self.node_claim = node_claim
        # pod key → requests (statenode.go pod tracking)
        self.pod_requests: Dict[tuple, ResourceList] = {}
        self.pod_limits: Dict[tuple, ResourceList] = {}
        self.daemonset_requests: Dict[tuple, ResourceList] = {}
        self.daemonset_limits: Dict[tuple, ResourceList] = {}
        self.host_port_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()
        self.marked_for_deletion = False
        self.nominated_until: float = 0.0

    # -- identity ----------------------------------------------------------

    def name(self) -> str:
        """NodeClaim name until registered, then Node name (statenode.go:110)."""
        if self.node is None:
            return self.node_claim.name if self.node_claim else ""
        if not self.registered() and self.node_claim is not None:
            return self.node_claim.name
        return self.node.name

    def provider_id(self) -> str:
        if self.node is not None and self.node.spec.provider_id:
            return self.node.spec.provider_id
        if self.node_claim is not None:
            return self.node_claim.status.provider_id
        return ""

    def hostname(self) -> str:
        return self.labels().get(wk.LABEL_HOSTNAME, self.name())

    def managed(self) -> bool:
        """Managed by us ⇔ it has (or had) a NodeClaim / nodepool label."""
        if self.node_claim is not None:
            return True
        return self.node is not None and wk.NODEPOOL_LABEL_KEY in self.node.metadata.labels

    def nodepool_name(self) -> str:
        return self.labels().get(wk.NODEPOOL_LABEL_KEY, "")

    # -- merged views ------------------------------------------------------

    def labels(self) -> Dict[str, str]:
        """Node labels once registered, else claim labels (statenode.go:168)."""
        if not self.registered() and self.node_claim is not None:
            return dict(self.node_claim.metadata.labels)
        if self.node is None:
            return {}
        return dict(self.node.metadata.labels)

    def annotations(self) -> Dict[str, str]:
        if not self.registered() and self.node_claim is not None:
            return dict(self.node_claim.metadata.annotations)
        if self.node is None:
            return {}
        return dict(self.node.metadata.annotations)

    def taints(self) -> List[Taint]:
        """Effective taints; ephemeral startup taints and (pre-init) startup
        taints are ignored for scheduling (statenode.go:183-203)."""
        ephemeral: List[Taint] = list(KNOWN_EPHEMERAL_TAINTS)
        if not self.initialized() and self.managed() and self.node_claim is not None:
            ephemeral += self.node_claim.spec.startup_taints
        if (not self.registered() and self.node_claim is not None) or self.node is None:
            source = self.node_claim.spec.taints if self.node_claim else []
        else:
            source = self.node.spec.taints
        return [t for t in source if not any(t.match(e) and t.value == e.value for e in ephemeral)]

    def registered(self) -> bool:
        if self.managed():
            return (
                self.node is not None
                and self.node.metadata.labels.get(wk.NODE_REGISTERED_LABEL_KEY) == "true"
            )
        return self.node is not None

    def initialized(self) -> bool:
        if self.managed():
            return (
                self.node is not None
                and self.node.metadata.labels.get(wk.NODE_INITIALIZED_LABEL_KEY) == "true"
            )
        return self.node is not None

    def capacity(self) -> ResourceList:
        """Claim capacity until initialized (kubelet may under-report while
        starting), then node capacity (statenode.go:224)."""
        if not self.initialized() and self.node_claim is not None:
            if self.node_claim.status.capacity:
                return dict(self.node_claim.status.capacity)
        if self.node is None:
            return {}
        return dict(self.node.status.capacity)

    def allocatable(self) -> ResourceList:
        if not self.initialized() and self.node_claim is not None:
            if self.node_claim.status.allocatable:
                return dict(self.node_claim.status.allocatable)
        if self.node is None:
            return {}
        return dict(self.node.status.allocatable)

    def available(self) -> ResourceList:
        """Allocatable minus scheduled pod requests (statenode.go:259)."""
        return resources.subtract(self.allocatable(), self.pod_request_total())

    def pod_request_total(self) -> ResourceList:
        return resources.merge(*self.pod_requests.values()) if self.pod_requests else {}

    def pod_limit_total(self) -> ResourceList:
        return resources.merge(*self.pod_limits.values()) if self.pod_limits else {}

    def daemonset_request_total(self) -> ResourceList:
        return resources.merge(*self.daemonset_requests.values()) if self.daemonset_requests else {}

    def daemonset_limit_total(self) -> ResourceList:
        return resources.merge(*self.daemonset_limits.values()) if self.daemonset_limits else {}

    # -- nomination / deletion marks (statenode.go:311-340) ----------------

    def nominate(self, now: float, window: float = 20.0) -> None:
        self.nominated_until = now + window

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now

    # -- pod bookkeeping (cluster.updateNodeUsageFromPod) ------------------

    def update_for_pod(self, pod: Pod) -> None:
        key = (pod.namespace, pod.name)
        self.pod_requests[key] = resources.requests_for_pods(pod)
        self.pod_limits[key] = resources.limits_for_pods(pod)
        if podutils.is_owned_by_daemonset(pod):
            self.daemonset_requests[key] = resources.requests_for_pods(pod)
            self.daemonset_limits[key] = resources.limits_for_pods(pod)
        from ..scheduling.hostports import get_host_ports

        self.host_port_usage.add(pod, get_host_ports(pod))

    def cleanup_pod(self, namespace: str, name: str) -> None:
        key = (namespace, name)
        self.pod_requests.pop(key, None)
        self.pod_limits.pop(key, None)
        self.daemonset_requests.pop(key, None)
        self.daemonset_limits.pop(key, None)
        self.host_port_usage.delete_pod(namespace, name)
        self.volume_usage.delete_pod(namespace, name)

    def deep_copy(self) -> "StateNode":
        out = StateNode(_clone_node(self.node), _clone_node_claim(self.node_claim))
        # flat copies sharing the VALUE dicts: every writer replaces a
        # key's value whole (update_for_pod assigns fresh ResourceLists,
        # cleanup_pod pops) and every reader merges/subtracts into new
        # dicts — values are immutable by discipline, so copying them
        # per node would be pure waste
        out.pod_requests = dict(self.pod_requests)
        out.pod_limits = dict(self.pod_limits)
        out.daemonset_requests = dict(self.daemonset_requests)
        out.daemonset_limits = dict(self.daemonset_limits)
        out.host_port_usage = self.host_port_usage.copy()
        out.volume_usage = self.volume_usage.copy()
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        return out
