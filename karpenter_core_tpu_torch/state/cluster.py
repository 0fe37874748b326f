"""Cluster: the in-memory mirror of nodes/nodeclaims/pods/daemonsets
(ref pkg/controllers/state/cluster.go): the port's copy of
``karpenter_core_tpu/state/cluster.py``.

All durable state stays in the (in-memory) apiserver — this cache is
rebuilt from watches on restart and gated by ``synced()``. The
provisioner snapshots its nodes (``deep_copy_nodes``) for each solve;
the greedy scheduler's topology walks its bound pods with required
anti-affinity; nominations land on its nodes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..apis.nodeclaim import NodeClaim
from ..kube.client import KubeClient
from ..kube.objects import DaemonSet, Node, Pod
from ..utils import pod as podutils
from .statenode import StateNode


class Cluster:
    # analysis: allow-clock(nomination/consolidation stamps are exchanged with kube-object wall-clock stamps)
    def __init__(self, kube_client: KubeClient, cloud_provider=None, clock: Callable[[], float] = time.time):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.clock = clock
        self._mu = threading.RLock()
        # providerID → StateNode (cluster.go:48-68)
        self.nodes: Dict[str, StateNode] = {}
        self.bindings: Dict[tuple, str] = {}  # pod key → node name
        self.node_name_to_provider_id: Dict[str, str] = {}
        self.node_claim_name_to_provider_id: Dict[str, str] = {}
        self.daemonset_pods: Dict[tuple, Pod] = {}
        self.anti_affinity_pods: Dict[tuple, Pod] = {}
        # node name → {csi driver: attachable-volume limit}, applied to
        # the state node's volume usage (volumeusage.go CSINode hydration)
        self._csi_limits_by_node: Dict[str, Dict[str, int]] = {}
        self._unsynced_start: Optional[float] = None
        self._consolidation_timestamp: float = clock()
        # monotonic mutation counter: bumped on every state change the
        # solver's cross-tick caches could observe (nodes, claims, pod
        # bindings, daemonsets, CSI limits, deletion marks). The
        # reference's incremental solve scopes its topology seed cache to
        # this value — unchanged generation proves the cluster-derived
        # inputs of a warm solve are unchanged.
        self._generation: int = 0

    def generation(self) -> int:
        with self._mu:
            return self._generation

    def _bump(self) -> None:
        # callers hold self._mu (RLock) — every mutator below does
        self._generation += 1

    # -- sync gate (cluster.go:89) -----------------------------------------

    def synced(self) -> bool:
        """True when the in-memory state covers at least everything the
        apiserver has (superset check)."""
        node_claims = self.kube_client.list("NodeClaim")
        nodes = self.kube_client.list("Node")
        with self._mu:
            state_claims = set(self.node_claim_name_to_provider_id)
            state_nodes = set(self.node_name_to_provider_id)
        for nc in node_claims:
            if not nc.status.provider_id:
                return False
            if nc.name not in state_claims:
                return False
        for n in nodes:
            if n.name not in state_nodes:
                return False
        return True

    # -- iteration ---------------------------------------------------------

    def for_each_node(self, fn: Callable[[StateNode], bool]) -> None:
        with self._mu:
            nodes = sorted(self.nodes.values(), key=lambda n: n.name())
        for n in nodes:
            if not fn(n):
                return

    def deep_copy_nodes(self) -> List[StateNode]:
        """Snapshot for scheduling (provisioner.go:310 deep copy)."""
        with self._mu:
            return [n.deep_copy() for n in self.nodes.values()]

    def for_pods_with_anti_affinity(self, fn: Callable[[Pod, Optional[Node]], bool]) -> None:
        """Each bound pod with required anti-affinity (cluster.go:128)."""
        with self._mu:
            items = list(self.anti_affinity_pods.items())
        for key, pod in items:
            with self._mu:
                node_name = self.bindings.get(key)
            if node_name is None:
                continue
            node = self.kube_client.get("Node", node_name)
            if node is None:
                continue
            if not fn(pod, node):
                return

    # -- nomination (cluster.go:172-194) -----------------------------------

    def is_node_nominated(self, provider_id: str) -> bool:
        with self._mu:
            n = self.nodes.get(provider_id)
            return n is not None and n.nominated(self.clock())

    def nominate_node_for_pod(self, provider_id: str) -> None:
        with self._mu:
            n = self.nodes.get(provider_id)
            if n is not None:
                n.nominate(self.clock())

    # -- deletion marks (cluster.go:195-219) -------------------------------

    def mark_for_deletion(self, *provider_ids: str) -> None:
        with self._mu:
            self._bump()
            for pid in provider_ids:
                n = self.nodes.get(pid)
                if n is not None:
                    n.marked_for_deletion = True

    def unmark_for_deletion(self, *provider_ids: str) -> None:
        with self._mu:
            self._bump()
            for pid in provider_ids:
                n = self.nodes.get(pid)
                if n is not None:
                    n.marked_for_deletion = False

    # -- nodeclaim / node updates (cluster.go:220-271) ---------------------

    def update_node_claim(self, node_claim: NodeClaim) -> None:
        with self._mu:
            self._bump()
            if node_claim.status.provider_id:
                old = self.nodes.get(node_claim.status.provider_id)
                state = StateNode(old.node if old else None, node_claim)
                self._carry_pods(old, state)
                self.nodes[node_claim.status.provider_id] = state
                self.node_claim_name_to_provider_id[node_claim.name] = node_claim.status.provider_id
                self._trigger_consolidation(old, state)
            else:
                # still tracked for Synced(); no state node until launch
                self.node_claim_name_to_provider_id.setdefault(node_claim.name, "")

    def delete_node_claim(self, name: str) -> None:
        with self._mu:
            self._bump()
            pid = self.node_claim_name_to_provider_id.pop(name, None)
            if pid:
                state = self.nodes.get(pid)
                if state is not None:
                    if state.node is None:
                        del self.nodes[pid]
                    else:
                        state.node_claim = None
            self.mark_unconsolidated()

    def update_node(self, node: Node) -> None:
        with self._mu:
            self._bump()
            pid = node.spec.provider_id or node.name
            old_pid = self.node_name_to_provider_id.get(node.name)
            old = self.nodes.get(pid) or (self.nodes.get(old_pid) if old_pid else None)
            if old_pid and old_pid != pid:
                # the node's provider id changed (e.g. stamped after
                # registration) — drop the stale entry or it double-counts
                self.nodes.pop(old_pid, None)
            state = StateNode(node, old.node_claim if old else None)
            self._carry_pods(old, state)
            # the CSINode cache is the single source of truth for attach
            # limits: it survives claim-only state (which never enters
            # node_name_to_provider_id, so update_csi_node can't reach
            # it) and clears stale limits after CSINode deletion. On a
            # cache miss (node re-created before its CSINode event
            # replays) fall back to the stored CSINode so a still-live
            # registration isn't treated as unlimited.
            limits = self._csi_limits_by_node.get(node.name)
            if limits is None:
                csi = self.kube_client.get("CSINode", node.name)
                if csi is not None:
                    limits = {
                        d.name: d.allocatable_count
                        for d in csi.drivers
                        if d.allocatable_count is not None
                    }
                    self._csi_limits_by_node[node.name] = limits
            state.volume_usage.csi_limits = dict(limits or {})
            self.nodes[pid] = state
            self.node_name_to_provider_id[node.name] = pid
            # re-link nodeclaim by provider id
            for nc_name, nc_pid in self.node_claim_name_to_provider_id.items():
                if nc_pid == pid and state.node_claim is None:
                    nc = self.kube_client.get("NodeClaim", nc_name)
                    if nc is not None:
                        state.node_claim = nc
            # replay pod bindings observed before this node arrived (watch
            # ordering can deliver bound pods first)
            if old is None:
                for (ns, name), bound_node in list(self.bindings.items()):
                    if bound_node == node.name and (ns, name) not in state.pod_requests:
                        pod = self.kube_client.get("Pod", name, namespace=ns)
                        if pod is not None:
                            state.update_for_pod(pod)
            self._trigger_consolidation(old, state)

    def delete_node(self, name: str) -> None:
        with self._mu:
            self._bump()
            # drop cached CSI attach limits so a re-created node with the
            # same name can't inherit stale limits before its CSINode event
            self._csi_limits_by_node.pop(name, None)
            pid = self.node_name_to_provider_id.pop(name, None)
            if pid:
                state = self.nodes.get(pid)
                if state is not None:
                    if state.node_claim is None:
                        del self.nodes[pid]
                    else:
                        state.node = None
            self.mark_unconsolidated()

    @staticmethod
    def _carry_pods(old: Optional[StateNode], new: StateNode) -> None:
        if old is None:
            return
        new.pod_requests = dict(old.pod_requests)
        new.pod_limits = dict(old.pod_limits)
        new.daemonset_requests = dict(old.daemonset_requests)
        new.daemonset_limits = dict(old.daemonset_limits)
        new.host_port_usage = old.host_port_usage
        new.volume_usage = old.volume_usage
        new.marked_for_deletion = old.marked_for_deletion
        new.nominated_until = old.nominated_until

    def _trigger_consolidation(self, old: Optional[StateNode], new: StateNode) -> None:
        """State transitions that may open consolidation opportunities
        (cluster.go:559)."""
        if old is None or old.initialized() != new.initialized() or old.marked_for_deletion != new.marked_for_deletion:
            self.mark_unconsolidated()

    # -- pod updates (cluster.go:273-297) ----------------------------------

    def update_pod(self, pod: Pod) -> None:
        with self._mu:
            self._bump()
            if podutils.is_terminal(pod):
                self._remove_pod_usage((pod.namespace, pod.name))
            else:
                self._cleanup_old_bindings(pod)
                if pod.spec.node_name:
                    # the binding is recorded even when the node isn't known
                    # yet; update_node replays it on arrival
                    self.bindings[(pod.namespace, pod.name)] = pod.spec.node_name
                    pid = self.node_name_to_provider_id.get(pod.spec.node_name, pod.spec.node_name)
                    state = self.nodes.get(pid)
                    if state is not None:
                        state.update_for_pod(pod)
            self._track_anti_affinity(pod)

    def _track_anti_affinity(self, pod: Pod) -> None:
        if podutils.has_required_pod_anti_affinity(pod):
            self.anti_affinity_pods[(pod.namespace, pod.name)] = pod
        else:
            self.anti_affinity_pods.pop((pod.namespace, pod.name), None)

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._mu:
            self._bump()
            self.anti_affinity_pods.pop((namespace, name), None)
            self._remove_pod_usage((namespace, name))
            self.mark_unconsolidated()

    def _remove_pod_usage(self, key: tuple) -> None:
        node_name = self.bindings.pop(key, None)
        if node_name:
            pid = self.node_name_to_provider_id.get(node_name, node_name)
            state = self.nodes.get(pid)
            if state is not None:
                state.cleanup_pod(*key)

    def _cleanup_old_bindings(self, pod: Pod) -> None:
        key = (pod.namespace, pod.name)
        old_node = self.bindings.get(key)
        if old_node is not None and old_node != pod.spec.node_name:
            pid = self.node_name_to_provider_id.get(old_node, old_node)
            state = self.nodes.get(pid)
            if state is not None:
                state.cleanup_pod(*key)
            del self.bindings[key]

    # -- daemonsets (cluster.go:339-375) -------------------------------------

    def update_csi_node(self, csi_node) -> None:
        """Hydrate per-driver attachable-volume limits onto the matching
        state node (CSINode is named after its Node)."""
        limits = {
            d.name: d.allocatable_count
            for d in csi_node.drivers
            if d.allocatable_count is not None
        }
        with self._mu:
            self._bump()
            self._csi_limits_by_node[csi_node.name] = limits
            pid = self.node_name_to_provider_id.get(csi_node.name)
            state = self.nodes.get(pid) if pid else None
            if state is not None:
                state.volume_usage.csi_limits = dict(limits)

    def delete_csi_node(self, name: str) -> None:
        with self._mu:
            self._bump()
            self._csi_limits_by_node.pop(name, None)
            pid = self.node_name_to_provider_id.get(name)
            state = self.nodes.get(pid) if pid else None
            if state is not None:
                state.volume_usage.csi_limits = {}

    def update_daemonset(self, daemonset: DaemonSet) -> None:
        with self._mu:
            self._bump()
            pod = Pod(spec=daemonset.pod_template_spec)
            pod.metadata.namespace = daemonset.namespace
            pod.metadata.name = f"{daemonset.name}-pod"
            self.daemonset_pods[(daemonset.namespace, daemonset.name)] = pod

    def delete_daemonset(self, namespace: str, name: str) -> None:
        with self._mu:
            self._bump()
            self.daemonset_pods.pop((namespace, name), None)

    def get_daemonset_pods(self) -> List[Pod]:
        with self._mu:
            return list(self.daemonset_pods.values())

    # -- consolidation timestamp (cluster.go:299-326) ------------------------

    def mark_unconsolidated(self) -> float:
        now = self.clock()
        # under the (reentrant) mutex: callers inside update paths already
        # hold it, but external callers (disruption controller) race the
        # watch threads without it
        with self._mu:
            self._consolidation_timestamp = now
        return now

    def consolidation_state(self) -> float:
        with self._mu:
            return self._consolidation_timestamp

    def reset(self) -> None:
        """Testing support (cluster.go:328). The generation counter must
        stay monotonic ACROSS resets: ``__init__`` would restart it at 0,
        and a warm solver whose seed cache was stamped at generation g
        would treat a post-reset cluster that mutated back up to g as
        unchanged — serving seed counts from the pre-reset world."""
        gen = self.generation()
        self.__init__(self.kube_client, self.cloud_provider, self.clock)
        with self._mu:
            self._generation = gen + 1
