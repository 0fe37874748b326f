"""NodeClaim disruption condition markers: Drifted / Expired / Empty.

Counterpart of ``karpenter_core_tpu/disruption/markers.py`` (ref
pkg/controllers/nodeclaim/disruption/{controller,drift,expiration,
emptiness}.go)."""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..apis import labels as wk
from ..apis.nodeclaim import (
    COND_DRIFTED,
    COND_EMPTY,
    COND_EXPIRED,
    COND_INITIALIZED,
    NodeClaim,
)
from ..apis.nodepool import CONSOLIDATION_POLICY_WHEN_EMPTY, NodePool
from ..scheduling.requirements import label_requirements, node_selector_requirements
from ..utils import pod as podutils

NODEPOOL_DRIFTED = "NodePoolDrifted"
REQUIREMENTS_DRIFTED = "RequirementsDrifted"


class NodeClaimDisruptionController:
    """disruption/controller.go:72-111: composes the three markers."""

    def __init__(
        self,
        kube_client,
        cloud_provider,
        cluster,
        # analysis: allow-clock(expiry vs creation_timestamp — persisted wall-clock stamps by protocol)
        clock: Callable[[], float] = time.time,
        drift_enabled: bool = True,  # the Drift feature gate (options.go:123)
    ):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.clock = clock
        self.drift_enabled = drift_enabled

    def reconcile(self, node_claim: NodeClaim, _index: Optional[dict] = None) -> None:
        if node_claim.metadata.deletion_timestamp is not None:
            return
        nodepool = self.kube_client.get(
            "NodePool", node_claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
        )
        if nodepool is None:
            return
        before = self._conditions_snapshot(node_claim)
        self._drift(nodepool, node_claim)
        self._expiration(nodepool, node_claim)
        self._emptiness(nodepool, node_claim, _index)
        # only write back (and fire watch events) on an actual change
        if self._conditions_snapshot(node_claim) != before:
            self.kube_client.apply(node_claim)

    @staticmethod
    def _conditions_snapshot(nc: NodeClaim) -> tuple:
        return tuple(
            sorted((c.type, c.status, c.reason) for c in nc.status.conditions)
        )

    def reconcile_all(self) -> None:
        # one sweep-level index: pods by node name + nodes by provider id,
        # instead of O(claims × cluster) re-listing
        pods_by_node: dict = {}
        for p in self.kube_client.list("Pod"):
            if p.spec.node_name:
                pods_by_node.setdefault(p.spec.node_name, []).append(p)
        nodes_by_pid = {
            n.spec.provider_id: n for n in self.kube_client.list("Node") if n.spec.provider_id
        }
        index = {"pods_by_node": pods_by_node, "nodes_by_pid": nodes_by_pid}
        for nc in self.kube_client.list("NodeClaim"):
            self.reconcile(nc, index)

    # -- drift (drift.go:49-140) -------------------------------------------

    def _drift(self, nodepool: NodePool, nc: NodeClaim) -> None:
        if not self.drift_enabled:
            nc.clear_condition(COND_DRIFTED)
            return
        reason = self._is_drifted(nodepool, nc)
        if reason:
            nc.set_condition(COND_DRIFTED, "True", reason)
        else:
            nc.clear_condition(COND_DRIFTED)

    def _is_drifted(self, nodepool: NodePool, nc: NodeClaim) -> str:
        static = self._static_drift(nodepool, nc)
        if static:
            return static
        req_drift = self._requirements_drift(nodepool, nc)
        if req_drift:
            return req_drift
        try:
            return self.cloud_provider.is_drifted(nc) or ""
        except Exception:  # analysis: allow-broad-except — provider drift probe is
            # advisory; a failing probe must read as not-drifted, never disrupt
            return ""

    @staticmethod
    def _static_drift(nodepool: NodePool, nc: NodeClaim) -> str:
        """drift.go:114 areStaticFieldsDrifted: nodepool-hash annotation
        mismatch."""
        pool_hash = nodepool.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
        claim_hash = nc.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
        if not pool_hash or not claim_hash:
            return ""
        return NODEPOOL_DRIFTED if pool_hash != claim_hash else ""

    @staticmethod
    def _requirements_drift(nodepool: NodePool, nc: NodeClaim) -> str:
        """drift.go:123 areRequirementsDrifted: nodepool requirements no
        longer compatible with the claim's labels."""
        pool_reqs = node_selector_requirements(nodepool.spec.template.requirements)
        claim_labels = label_requirements(nc.metadata.labels)
        if pool_reqs.compatible(claim_labels, frozenset(wk.WELL_KNOWN_LABELS), hint=False) is not None:
            return REQUIREMENTS_DRIFTED
        return ""

    # -- expiration (expiration.go:42-80) ----------------------------------

    def _expiration(self, nodepool: NodePool, nc: NodeClaim) -> None:
        expire_after = nodepool.spec.disruption.expire_after
        if expire_after is None:
            nc.clear_condition(COND_EXPIRED)
            return
        # expire from the node's creation if registered, else the claim's
        node = self._node_for(nc)
        base = node.metadata.creation_timestamp if node is not None else nc.metadata.creation_timestamp
        if self.clock() - base >= expire_after:
            nc.set_condition(COND_EXPIRED, "True", "TTLExpired")
        else:
            nc.clear_condition(COND_EXPIRED)

    # -- emptiness (emptiness.go:46-90) ------------------------------------

    def _emptiness(self, nodepool: NodePool, nc: NodeClaim, index: Optional[dict] = None) -> None:
        d = nodepool.spec.disruption
        if d.consolidation_policy != CONSOLIDATION_POLICY_WHEN_EMPTY or d.consolidate_after is None:
            nc.clear_condition(COND_EMPTY)
            return
        if not nc.status_condition_is_true(COND_INITIALIZED):
            nc.clear_condition(COND_EMPTY)
            return
        node = self._node_for(nc, index)
        if node is None:
            nc.clear_condition(COND_EMPTY)
            return
        if self.cluster is not None and self.cluster.is_node_nominated(node.spec.provider_id):
            nc.clear_condition(COND_EMPTY)
            return
        if index is not None:
            node_pods = index["pods_by_node"].get(node.name, [])
        else:
            node_pods = [p for p in self.kube_client.list("Pod") if p.spec.node_name == node.name]
        pods = [
            p
            for p in node_pods
            if not podutils.is_owned_by_daemonset(p) and not podutils.is_terminal(p)
        ]
        if pods:
            nc.clear_condition(COND_EMPTY)
        else:
            nc.set_condition(COND_EMPTY, "True")

    def _node_for(self, nc: NodeClaim, index: Optional[dict] = None):
        if not nc.status.provider_id:
            return None
        if index is not None:
            return index["nodes_by_pid"].get(nc.status.provider_id)
        for n in self.kube_client.list("Node"):
            if n.spec.provider_id == nc.status.provider_id:
                return n
        return None
