"""Node termination: taint → drain → evict → provider delete → drop
finalizer (ref pkg/controllers/node/termination/, terminator/).

The port's copy of ``karpenter_core_tpu/lifecycle/node_termination.py``;
disruption reads its ``pdb_disruptions_allowed``."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..apis import labels as wk
from ..cloudprovider.types import CloudProvider, NodeClaimNotFoundError
from ..kube.objects import EFFECT_NO_SCHEDULE, Node, Pod, Taint
from ..utils import pod as podutils

LB_EXCLUDE_LABEL = "node.kubernetes.io/exclude-from-external-load-balancers"


class NodeDrainError(Exception):
    pass


def pdb_disruptions_allowed(kube_client, pdb) -> int:
    """Dynamic budget, like the real PDB controller: recomputed from the
    current health of matching pods so evictions consume it and healthy
    replacements replenish it. Falls back to the static field when neither
    minAvailable nor maxUnavailable is set."""
    matching = [
        p
        for p in kube_client.list("Pod", namespace=pdb.namespace)
        if pdb.selector.matches(p.metadata.labels)
    ]
    healthy = sum(
        1
        for p in matching
        if p.status.phase == "Running" and p.metadata.deletion_timestamp is None
    )
    if pdb.min_available is not None:
        return healthy - pdb.min_available
    if pdb.max_unavailable is not None:
        unavailable = len(matching) - healthy
        return pdb.max_unavailable - unavailable
    return pdb.disruptions_allowed


class EvictionQueue:
    """Rate-limited eviction queue honoring PDBs (ref
    terminator/eviction.go:65-150). Our in-memory PDB model exposes
    ``disruptions_allowed``; a blocked eviction stays queued (the 429
    path)."""

    def __init__(self, kube_client, recorder=None):
        self.kube_client = kube_client
        self.recorder = recorder
        self._queued: List[tuple] = []

    def add(self, *pods: Pod) -> None:
        for p in pods:
            key = (p.namespace, p.name)
            if key not in self._queued:
                self._queued.append(key)

    def evict(self, pod: Pod) -> bool:
        """True if the eviction was admitted (eviction.go:101 Evict).

        do-not-disrupt is NOT honored here: it gates voluntary disruption
        candidacy (disruption engine), not the termination drain — refusing
        would deadlock node finalization (ref terminator/eviction.go)."""
        for pdb in self.kube_client.list("PodDisruptionBudget", namespace=pod.namespace):
            if pdb.selector.matches(pod.metadata.labels):
                if pdb_disruptions_allowed(self.kube_client, pdb) <= 0:
                    return False  # the PDB 429 path
        self.kube_client.delete(pod)
        if self.recorder is not None:
            from ..events import events as ev

            self.recorder.publish(ev.evict(pod))
        return True

    def reconcile(self) -> None:
        remaining = []
        for ns, name in self._queued:
            pod = self.kube_client.get("Pod", name, namespace=ns)
            if pod is None:
                continue
            if not self.evict(pod):
                remaining.append((ns, name))
        self._queued = remaining


class Terminator:
    """terminator/terminator.go: Taint (:50), Drain (:81)."""

    # analysis: allow-clock(stuck-pod age vs persisted deletionTimestamp wall-clock stamps)
    def __init__(self, kube_client, eviction_queue: EvictionQueue, clock: Callable[[], float] = time.time):
        self.kube_client = kube_client
        self.eviction_queue = eviction_queue
        self.clock = clock

    def taint(self, node: Node) -> None:
        """Cordon with the disruption taint + LB exclusion (terminator.go:50-77)."""
        taint = podutils.DISRUPTION_NO_SCHEDULE_TAINT
        if not any(taint.match(t) for t in node.spec.taints):
            node.spec.taints.append(
                Taint(key=taint.key, value=taint.value, effect=taint.effect)
            )
        node.metadata.labels[LB_EXCLUDE_LABEL] = "true"
        self.kube_client.apply(node)

    STUCK_TERMINATING = 60.0  # pods terminating longer than this are stuck

    def drain(self, node: Node, grace_period: Optional[float] = None) -> None:
        """Evict all evictable pods; raises NodeDrainError while pods remain
        (terminator.go:81-110). Terminating pods still block the drain —
        deleting the instance under a gracefully-shutting-down pod would
        hard-kill it — unless they've been stuck past the threshold."""
        pods = [
            p for p in self.kube_client.list("Pod") if p.spec.node_name == node.name
        ]
        draining = []
        # graceful-node-shutdown eviction waves (terminator.go:113-146):
        # (critical?, daemonset?) → pods, evicted one group per pass
        waves = {
            (False, False): [],
            (False, True): [],
            (True, False): [],
            (True, True): [],
        }
        for p in pods:
            if podutils.is_owned_by_node(p):
                continue  # static pods
            if podutils.is_terminal(p):
                continue
            if podutils.tolerates_disruption_no_schedule_taint(p):
                # tolerating the disruption taint means "stay until node
                # deletion" — never evicted, never blocks (terminator.go:91)
                continue
            if podutils.is_terminating(p):
                if self.clock() - p.metadata.deletion_timestamp > self.STUCK_TERMINATING:
                    continue  # stuck terminating; don't block forever
                # still blocks the drain but does NOT occupy its wave:
                # the next wave starts while this pod shuts down
                # (terminator.go:115-117 skips terminating pods when
                # grouping, deliberately — do not "fix" this)
                draining.append(p)
                continue
            draining.append(p)
            waves[(podutils.is_critical(p), podutils.is_owned_by_daemonset(p))].append(p)
        for key in ((False, False), (False, True), (True, False), (True, True)):
            if waves[key]:
                self.eviction_queue.add(*waves[key])
                break
        if draining:
            self.eviction_queue.reconcile()
            raise NodeDrainError(f"{len(draining)} pods are waiting to be evicted")


class NodeTerminationController:
    """node/termination/controller.go:76-108 finalizer flow."""

    def __init__(self, kube_client, cloud_provider: CloudProvider, terminator: Terminator, recorder=None, metrics=None):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.terminator = terminator
        self.recorder = recorder
        self.metrics = metrics

    def reconcile(self, node: Node) -> Optional[str]:
        if node.metadata.deletion_timestamp is None:
            return None
        if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return None
        # delete any owning NodeClaims first (controller.go:83)
        for nc in self.kube_client.list("NodeClaim"):
            if nc.status.provider_id and nc.status.provider_id == node.spec.provider_id:
                self.kube_client.delete(nc)
        self.terminator.taint(node)
        try:
            self.terminator.drain(node)
        except NodeDrainError as e:
            if self.recorder is not None:
                from ..events import events as ev

                self.recorder.publish(ev.node_failed_to_drain(node, e))
            return str(e)
        # drained: delete the instance then drop the finalizer
        claims = [
            nc
            for nc in self.kube_client.list("NodeClaim")
            if nc.status.provider_id == node.spec.provider_id
        ]
        try:
            if claims:
                self.cloud_provider.delete(claims[0])
            else:
                from ..apis.nodeclaim import NodeClaim

                stub = NodeClaim()
                stub.status.provider_id = node.spec.provider_id
                self.cloud_provider.delete(stub)
        except NodeClaimNotFoundError:
            pass
        self.kube_client.remove_finalizer(node, wk.TERMINATION_FINALIZER)
        if self.metrics is not None:
            self.metrics.nodes_terminated.inc(
                nodepool=node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
        return None

    def reconcile_all(self) -> None:
        for node in self.kube_client.list("Node"):
            self.reconcile(node)
