"""Consistency checks (ref pkg/controllers/nodeclaim/consistency/):
10-minute scans that alarm on impossible states. The port's copy of
``karpenter_core_tpu/lifecycle/consistency.py``, over the port's
``disruption.helpers.PDBLimits``."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..apis import labels as wk
from ..apis.nodeclaim import COND_INITIALIZED, NodeClaim
from ..scheduling import resources


class Check:
    """controller.go:55 Check interface."""

    def check(self, node_claim: NodeClaim, node) -> List[str]:
        raise NotImplementedError


class TerminationCheck(Check):
    """termination.go:41-59: report WHY a deleting claim is stuck — a
    missing termination finalizer (instance may leak), or a PDB blocking
    the node's drain."""

    def __init__(self, kube_client=None):
        self.kube_client = kube_client
        self._pass: Optional[tuple] = None

    def begin_pass(self) -> None:
        """Snapshot PDBs + reschedulable pods once for a reconcile_all
        scan — per-claim construction re-lists the whole cluster per
        deleting claim, a redundant LIST burst during consolidation
        waves."""
        if self.kube_client is None:
            return
        self._pass = self._snapshot()

    def end_pass(self) -> None:
        self._pass = None

    def _snapshot(self) -> tuple:
        # deferred import: disruption.helpers imports from lifecycle
        from ..disruption.helpers import PDBLimits
        from ..utils import pod as podutils

        pods_by_node: dict = {}
        for p in self.kube_client.list("Pod"):
            if p.spec.node_name and podutils.is_reschedulable(p):
                pods_by_node.setdefault(p.spec.node_name, []).append(p)
        return PDBLimits(self.kube_client), pods_by_node

    def check(self, node_claim: NodeClaim, node) -> List[str]:
        if node_claim.metadata.deletion_timestamp is None:
            return []
        issues: List[str] = []
        if wk.TERMINATION_FINALIZER not in node_claim.metadata.finalizers:
            issues.append("nodeClaim is terminating without the termination finalizer")
        if self.kube_client is not None and node is not None:
            pdbs, pods_by_node = self._pass if self._pass is not None else self._snapshot()
            pdb_name, ok = pdbs.can_evict_pods(pods_by_node.get(node.name, []))
            if not ok:
                issues.append(f"can't drain node, PDB {pdb_name} is blocking evictions")
        return issues


class NodeShapeCheck(Check):
    """nodeshape.go:40: real node capacity must be within expectation
    (±10%) of what the claim promised."""

    TOLERANCE = 0.10

    def check(self, node_claim: NodeClaim, node) -> List[str]:
        if node is None or not node_claim.status_condition_is_true(COND_INITIALIZED):
            return []
        issues = []
        for name, expected in node_claim.status.capacity.items():
            actual = node.status.capacity.get(name, 0)
            if expected > 0 and actual < expected * (1 - self.TOLERANCE):
                issues.append(
                    f"expected {resources.to_string({name: expected})} of resource {name}, "
                    f"but found {resources.to_string({name: actual})}"
                )
        return issues


class ConsistencyController:
    """controller.go:62-113."""

    def __init__(self, kube_client, recorder=None, checks: Optional[List[Check]] = None, metrics=None):
        self.kube_client = kube_client
        self.recorder = recorder
        self.checks = checks or [TerminationCheck(kube_client), NodeShapeCheck()]
        self.metrics = metrics

    def reconcile(self, node_claim: NodeClaim) -> List[str]:
        node = None
        for n in self.kube_client.list("Node"):
            if node_claim.status.provider_id and n.spec.provider_id == node_claim.status.provider_id:
                node = n
                break
        issues: List[str] = []
        for check in self.checks:
            issues.extend(check.check(node_claim, node))
        for issue in issues:
            if self.recorder is not None:
                from ..events import events as ev

                self.recorder.publish(ev.consistency_check_failed(node_claim, issue))
            if self.metrics is not None:
                self.metrics.consistency_errors.inc()
        return issues

    def reconcile_all(self) -> List[str]:
        for check in self.checks:
            begin = getattr(check, "begin_pass", None)
            if begin is not None:
                begin()
        try:
            out = []
            for nc in self.kube_client.list("NodeClaim"):
                out.extend(self.reconcile(nc))
            return out
        finally:
            for check in self.checks:
                end = getattr(check, "end_pass", None)
                if end is not None:
                    end()
