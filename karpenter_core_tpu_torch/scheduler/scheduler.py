"""The greedy per-pod scheduler (ref
pkg/controllers/provisioning/scheduling/scheduler.go): the port's copy
of ``karpenter_core_tpu/scheduler/scheduler.py``.

It is the correctness oracle of the batched solve (``TorchScheduler``,
whose packing is held to it) and the solve's fallback for the groups
the tensor path does not take. With a ``recorder`` it publishes failure
and nomination events, and with a ``cluster`` it nominates the existing
nodes it placed pods on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..apis import labels as wk
from ..apis.nodepool import NodePool
from ..cloudprovider.types import InstanceType
from ..kube.objects import EFFECT_PREFER_NO_SCHEDULE, Pod, ResourceList
from ..scheduling import Taints, resources
from ..scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    has_preferred_node_affinity,
    label_requirements,
    pod_requirements,
    strict_pod_requirements,
)
from ..state.statenode import StateNode
from ..utils import pod as podutils
from .existingnode import ExistingNode
from .nodeclaim import NodeClaimTemplate, SchedulingNodeClaim
from .preferences import Preferences
from .queue import Queue
from .topology import Topology


@dataclass
class SchedulerOptions:
    """simulation_mode suppresses nomination events/logging during
    consolidation simulation (scheduler.go:44)."""

    simulation_mode: bool = False


@dataclass
class Results:
    """Scheduling outcome (scheduler.go:102)."""

    new_node_claims: List[SchedulingNodeClaim] = field(default_factory=list)
    existing_nodes: List[ExistingNode] = field(default_factory=list)
    pod_errors: Dict[str, str] = field(default_factory=dict)  # pod uid → error
    _pods_by_uid: Dict[str, Pod] = field(default_factory=dict)

    def all_non_pending_pods_scheduled(self) -> bool:
        """Pods that were already pending before simulation don't block
        consolidation (scheduler.go:111)."""
        return not [
            uid
            for uid, err in self.pod_errors.items()
            if not podutils.is_provisionable(self._pods_by_uid[uid])
        ]

    def non_pending_pod_scheduling_errors(self) -> str:
        errs = {
            uid: err
            for uid, err in self.pod_errors.items()
            if not podutils.is_provisionable(self._pods_by_uid[uid])
        }
        if not errs:
            return "No Pod Scheduling Errors"
        parts = []
        for uid, err in list(errs.items())[:5]:
            p = self._pods_by_uid[uid]
            parts.append(f"{p.namespace}/{p.name} => {err}")
        msg = "not all pods would schedule, " + " ".join(parts)
        if len(errs) > 5:
            msg += f" and {len(errs) - 5} other(s)"
        return msg


class Scheduler:
    """scheduler.go:49 NewScheduler + Solve."""

    def __init__(
        self,
        kube_client,
        node_claim_templates: List[NodeClaimTemplate],
        nodepools: List[NodePool],
        cluster,
        state_nodes: List[StateNode],
        topology: Topology,
        instance_types: Dict[str, List[InstanceType]],
        daemonset_pods: List[Pod],
        recorder=None,
        opts: Optional[SchedulerOptions] = None,
    ):
        self.kube_client = kube_client
        self.node_claim_templates = node_claim_templates
        self.topology = topology
        self.cluster = cluster
        self.instance_types = instance_types
        self.recorder = recorder
        self.opts = opts or SchedulerOptions()
        self.new_node_claims: List[SchedulingNodeClaim] = []
        self.existing_nodes: List[ExistingNode] = []

        # any NodePool with a PreferNoSchedule taint enables the matching
        # relaxation (scheduler.go:54-63)
        tolerate_prefer_no_schedule = any(
            t.effect == EFFECT_PREFER_NO_SCHEDULE
            for np in nodepools
            for t in np.spec.template.taints
        )
        self.preferences = Preferences(tolerate_prefer_no_schedule)

        self.nodepools = {np.name: np for np in nodepools}
        # NodePool limits tracked pessimistically (scheduler.go:76-80)
        self.remaining_resources: Dict[str, ResourceList] = {
            np.name: dict(np.spec.limits) for np in nodepools if np.spec.limits
        }
        self.daemon_overhead = _daemon_overhead(node_claim_templates, daemonset_pods)
        self._calculate_existing_node_claims(state_nodes, daemonset_pods)

    # -- solve (scheduler.go:140) ------------------------------------------

    def solve(self, pods: List[Pod]) -> Results:
        errors: Dict[str, str] = {}
        pods_by_uid = {p.uid: p for p in pods}
        q = Queue(*pods)
        while True:
            pod, ok = q.pop()
            if not ok:
                break
            err = self._add(pod)
            errors[pod.uid] = err
            if err is None:
                continue
            relaxed = self.preferences.relax(pod)
            q.push(pod, relaxed)
            if relaxed:
                self.topology.update(pod)

        for claim in self.new_node_claims:
            claim.finalize_scheduling()
        if not self.opts.simulation_mode:
            self._record_results(pods_by_uid, q.list(), errors)
        errors = {uid: e for uid, e in errors.items() if e is not None}
        return Results(
            new_node_claims=self.new_node_claims,
            existing_nodes=self.existing_nodes,
            pod_errors=errors,
            _pods_by_uid=pods_by_uid,
        )

    def _record_results(self, pods_by_uid, failed, errors) -> None:
        if self.recorder is None:
            return
        from ..events import events as ev

        for pod in failed:
            self.recorder.publish(ev.pod_failed_to_schedule(pod, errors.get(pod.uid)))
        for existing in self.existing_nodes:
            if existing.pods and self.cluster is not None:
                self.cluster.nominate_node_for_pod(existing.provider_id())
            for pod in existing.pods:
                self.recorder.publish(ev.nominate_pod(pod, existing.name()))

    # -- add one pod (scheduler.go:238) ------------------------------------

    def _add(self, pod: Pod) -> Optional[str]:
        # topology outcomes per claim depend only on per-domain counts and
        # the claim's concrete value set per key, so compute the admissible
        # domains once and skip claims that would be rejected anyway
        # (loops 1-2 discard the per-claim error strings, so skipping is
        # behavior-identical)
        strict_reqs = (
            strict_pod_requirements(pod)
            if has_preferred_node_affinity(pod)
            else pod_requirements(pod)
        )
        adm = self.topology.admissible_by_key(pod, strict_reqs)

        def claim_viable(reqs) -> bool:
            if adm is None:
                return True
            for key, allowed in adm.items():
                r = reqs.get_req(key)
                if r.complement:
                    continue  # NotIn/Exists/Gt/Lt: no concrete value set
                if allowed.isdisjoint(r.values):
                    return False
            return True

        # 1. in-flight real nodes
        for node in self.existing_nodes:
            if not claim_viable(node.requirements):
                continue
            if node.add(self.kube_client, pod) is None:
                return None

        # 2. already-planned claims, fewest pods first (scheduler.go:247)
        self.new_node_claims.sort(key=lambda c: len(c.pods))
        pod_requests = resources.requests_for_pods(pod)
        for claim in self.new_node_claims:
            if not claim_viable(claim.requirements):
                continue
            if claim.add(pod, pod_requests=pod_requests) is None:
                return None

        # 3. a new claim per template, in weight order
        errs = []
        for template in self.node_claim_templates:
            instance_types = self.instance_types.get(template.nodepool_name, [])
            remaining = self.remaining_resources.get(template.nodepool_name)
            if remaining is not None:
                instance_types = _filter_by_remaining_resources(instance_types, remaining)
                if not instance_types:
                    errs.append(
                        f'all available instance types exceed limits for nodepool: "{template.nodepool_name}"'
                    )
                    continue
            claim = SchedulingNodeClaim(
                template, self.topology, self.daemon_overhead[template.nodepool_name], instance_types
            )
            err = claim.add(pod, pod_requests=pod_requests)
            if err is not None:
                errs.append(
                    f'incompatible with nodepool "{template.nodepool_name}", '
                    f"daemonset overhead={resources.to_string(self.daemon_overhead[template.nodepool_name])}, {err}"
                )
                continue
            self.new_node_claims.append(claim)
            if template.nodepool_name in self.remaining_resources:
                # pessimistic: assume the largest surviving instance type
                # launches (scheduler.go:343 subtractMax)
                self.remaining_resources[template.nodepool_name] = _subtract_max(
                    self.remaining_resources[template.nodepool_name], claim.instance_type_options
                )
            return None
        return "; ".join(errs) if errs else "no nodepool matched"

    # -- existing nodes (scheduler.go:287) ---------------------------------

    def _calculate_existing_node_claims(
        self, state_nodes: List[StateNode], daemonset_pods: List[Pod]
    ) -> None:
        for node in state_nodes:
            daemons = []
            for p in daemonset_pods:
                if Taints(node.taints()).tolerates(p) is not None:
                    continue
                if label_requirements(node.labels()).compatible(pod_requirements(p), hint=False) is not None:
                    continue
                daemons.append(p)
            self.existing_nodes.append(
                ExistingNode(node, self.topology, resources.requests_for_pods(*daemons))
            )
            pool = node.labels().get(wk.NODEPOOL_LABEL_KEY, "")
            if pool in self.remaining_resources:
                self.remaining_resources[pool] = resources.subtract(
                    self.remaining_resources[pool], node.capacity()
                )
        # initialized nodes first so consolidation packs onto ready capacity
        # (scheduler.go:310-321)
        self.existing_nodes.sort(key=lambda n: (not n.initialized(), n.name()))


def _daemon_overhead(
    templates: List[NodeClaimTemplate], daemonset_pods: List[Pod]
) -> Dict[str, ResourceList]:
    """Per-template daemonset resource overhead (scheduler.go:324)."""
    overhead = {}
    for template in templates:
        daemons = []
        for p in daemonset_pods:
            if Taints(template.spec.taints).tolerates(p) is not None:
                continue
            if template.requirements.compatible(
                pod_requirements(p), ALLOW_UNDEFINED_WELL_KNOWN_LABELS, hint=False
            ) is not None:
                continue
            daemons.append(p)
        overhead[template.nodepool_name] = resources.requests_for_pods(*daemons)
    return overhead


def _subtract_max(remaining: ResourceList, instance_types: List[InstanceType]) -> ResourceList:
    """Pessimistic limit tracking: subtract the element-wise max capacity
    over possible instance types (scheduler.go:347 subtractMax)."""
    if not instance_types:
        return remaining
    it_max = resources.max_resources(*(it.capacity for it in instance_types))
    return {k: v - it_max.get(k, 0) for k, v in remaining.items()}


def _filter_by_remaining_resources(
    instance_types: List[InstanceType], remaining: ResourceList
) -> List[InstanceType]:
    """Drop instance types whose launch would breach NodePool limits
    (scheduler.go:367 filterByRemainingResources)."""
    out = []
    for it in instance_types:
        viable = True
        for name, rem in remaining.items():
            if it.capacity.get(name, 0) > rem:
                viable = False
        if viable:
            out.append(it)
    return out
