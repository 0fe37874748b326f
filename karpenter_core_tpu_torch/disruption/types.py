"""Disruption candidates and commands.

Counterpart of ``karpenter_core_tpu/disruption/types.py`` (ref
pkg/controllers/disruption/types.go)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..apis import labels as wk
from ..apis.nodepool import NodePool
from ..cloudprovider.types import InstanceType
from ..kube.objects import Pod
from ..state.statenode import StateNode
from ..utils import pod as podutils

ACTION_NOOP = "no-op"
ACTION_REPLACE = "replace"
ACTION_DELETE = "delete"

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def pod_eviction_cost(pod: Pod) -> float:
    """helpers.go GetPodEvictionCost: base 1.0, scaled by the deletion-cost
    annotation and pod priority. Memoized on the pod object behind its
    resource_version (the podcache ``_karp_memo`` rv-guard pattern):
    candidate collection evaluates this for every bound pod of every
    candidate on every pass — 50k calls per decision at config-9 scale —
    and any annotation/priority edit moves the rv."""
    cached = getattr(pod, "_karp_evict", None)
    rv = pod.metadata.resource_version
    if cached is not None and cached[0] == rv:
        return cached[1]
    cost = 1.0
    deletion_cost = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if deletion_cost:
        try:
            # higher deletion cost = more expensive to evict
            cost += float(deletion_cost) / 10.0
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += float(pod.spec.priority) / 1e6
    pod._karp_evict = (rv, cost)
    return cost


def disruption_cost(pods: List[Pod]) -> float:
    return sum(pod_eviction_cost(p) for p in pods)


class CandidateError(Exception):
    pass


@dataclass
class Candidate:
    """A node eligible for disruption (types.go:49)."""

    state_node: StateNode
    instance_type: InstanceType
    nodepool: NodePool
    zone: str
    capacity_type: str
    pods: List[Pod]
    disruption_cost: float = 0.0

    def name(self) -> str:
        return self.state_node.name()

    def provider_id(self) -> str:
        return self.state_node.provider_id()

    def annotations(self) -> Dict[str, str]:
        return self.state_node.annotations()

    def price(self) -> Optional[float]:
        offering = self.instance_type.offerings.get(self.capacity_type, self.zone)
        return offering.price if offering else None

    def lifetime_remaining(self, now: float) -> float:
        """Fraction of lifetime left ∈ [0,1] (types.go:139): disruption of
        soon-to-expire nodes is cheap."""
        expire_after = self.nodepool.spec.disruption.expire_after
        if expire_after is None or self.state_node.node is None:
            return 1.0
        age = now - self.state_node.node.metadata.creation_timestamp
        remaining = (expire_after - age) / expire_after
        return min(max(remaining, 0.0), 1.0)


def new_candidate(
    kube_client,
    recorder,
    clock: Callable[[], float],
    node: StateNode,
    nodepool_map: Dict[str, NodePool],
    instance_type_map: Dict[str, Dict[str, InstanceType]],
    queue=None,
    pods_by_node: Optional[Dict[str, List[Pod]]] = None,
    node_owned: bool = False,
) -> Candidate:
    """Build + validate a candidate (types.go:60 NewCandidate); raises
    CandidateError when the node is ineligible.

    ``pods_by_node``: an optional node-name → active-pods index so a
    5k-candidate scan is O(pods) once, not O(candidates × pods).
    ``node_owned``: the caller already owns a fresh copy of ``node``
    (cluster.deep_copy_nodes) — skip the second defensive copy."""
    if node.node is None or node.node_claim is None:
        raise CandidateError("state node doesn't contain both a node and a nodeclaim")
    if node.marked_for_deletion:
        raise CandidateError("state node is marked for deletion")
    if not node.initialized():
        raise CandidateError("state node isn't initialized")
    if queue is not None and queue.has_any(node.provider_id()):
        raise CandidateError("candidate is already being deprovisioned")
    if wk.DO_NOT_DISRUPT_ANNOTATION_KEY in node.annotations():
        raise CandidateError(
            f'disruption is blocked through the "{wk.DO_NOT_DISRUPT_ANNOTATION_KEY}" annotation'
        )
    labels = node.labels()
    for label in (wk.CAPACITY_TYPE_LABEL_KEY, wk.LABEL_TOPOLOGY_ZONE):
        if label not in labels:
            raise CandidateError(f'state node doesn\'t have required label "{label}"')
    nodepool_name = labels.get(wk.NODEPOOL_LABEL_KEY)
    if not nodepool_name:
        raise CandidateError("state node doesn't have the karpenter owner label")
    nodepool = nodepool_map.get(nodepool_name)
    it_map = instance_type_map.get(nodepool_name)
    if nodepool is None or it_map is None:
        raise CandidateError(f'nodepool "{nodepool_name}" can\'t be resolved for state node')
    instance_type = it_map.get(labels.get(wk.LABEL_INSTANCE_TYPE, ""))
    if instance_type is None:
        raise CandidateError(
            f'instance type "{labels.get(wk.LABEL_INSTANCE_TYPE)}" can\'t be resolved'
        )
    if node.nominated(clock()):
        raise CandidateError("state node is nominated for a pending pod")
    if pods_by_node is not None:
        pods = pods_by_node.get(node.node.name, [])
    else:
        pods = [
            p
            for p in kube_client.list("Pod")
            if p.spec.node_name == node.node.name and podutils.is_active(p)
        ]
    candidate = Candidate(
        state_node=node if node_owned else node.deep_copy(),
        instance_type=instance_type,
        nodepool=nodepool,
        capacity_type=labels[wk.CAPACITY_TYPE_LABEL_KEY],
        zone=labels[wk.LABEL_TOPOLOGY_ZONE],
        pods=pods,
    )
    candidate.disruption_cost = disruption_cost(pods) * candidate.lifetime_remaining(clock())
    return candidate


@dataclass
class Command:
    """types.go:147: candidates to remove + replacement claims."""

    candidates: List[Candidate] = field(default_factory=list)
    replacements: List[object] = field(default_factory=list)  # SchedulingNodeClaim

    def action(self) -> str:
        if self.candidates and self.replacements:
            return ACTION_REPLACE
        if self.candidates:
            return ACTION_DELETE
        return ACTION_NOOP

    def __str__(self) -> str:
        names = ", ".join(c.name() for c in self.candidates)
        return f"{self.action()}, terminating {len(self.candidates)} candidates [{names}], replacements {len(self.replacements)}"
