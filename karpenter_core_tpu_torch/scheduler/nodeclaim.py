"""In-flight scheduling NodeClaim and NodeClaimTemplate (ref
pkg/controllers/provisioning/scheduling/nodeclaim.go,
nodeclaimtemplate.go): the port's copy of
``karpenter_core_tpu/scheduler/nodeclaim.py``."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..apis import labels as wk
from ..apis.nodeclaim import NodeClaim, NodeClaimResources, NodeClaimSpec
from ..apis.nodepool import NodePool
from ..cloudprovider.types import InstanceType, order_by_price
from ..kube.objects import OP_IN, OwnerReference, Pod, ResourceList, next_name
from ..scheduling import HostPortUsage, Requirement, Requirements, Taints, resources
from ..scheduling.hostports import get_host_ports
from ..scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    has_preferred_node_affinity,
    label_requirements,
    node_selector_requirements,
    pod_requirements,
    strict_pod_requirements,
)
from .topology import Topology

_hostname_counter = itertools.count(1)

MAX_INSTANCE_TYPES = 100  # nodeclaimtemplate.go:55 ToNodeClaim slice cap


class NodeClaimTemplate:
    """Per-NodePool template with pre-built requirements
    (nodeclaimtemplate.go:33)."""

    def __init__(self, nodepool: NodePool):
        self.nodepool_name = nodepool.name
        self.spec = nodepool.spec.template
        self.labels = dict(self.spec.metadata.labels)
        self.labels[wk.NODEPOOL_LABEL_KEY] = nodepool.name
        self.annotations = dict(self.spec.metadata.annotations)
        self.instance_type_options: List[InstanceType] = []
        self.requirements = Requirements()
        self.requirements.add(*node_selector_requirements(self.spec.requirements).values_list())
        self.requirements.add(*label_requirements(self.labels).values_list())
        self.taints = Taints(self.spec.taints)

    def to_node_claim(self, nodepool: NodePool, requirements: Requirements,
                      instance_types: List[InstanceType], requests: ResourceList) -> NodeClaim:
        """Stamp a NodeClaim CR (nodeclaimtemplate.go:55 ToNodeClaim):
        instance types capped at the 100 cheapest."""
        selected = order_by_price(instance_types, requirements)[:MAX_INSTANCE_TYPES]
        reqs = Requirements(*requirements.values_list())
        reqs.add(Requirement(wk.LABEL_INSTANCE_TYPE, OP_IN, [it.name for it in selected]))
        nc = NodeClaim()
        nc.metadata.name = next_name(self.nodepool_name)
        nc.metadata.labels = dict(self.labels)
        nc.metadata.annotations = {
            **self.annotations,
            wk.NODEPOOL_HASH_ANNOTATION_KEY: nodepool.static_hash(),
        }
        nc.metadata.owner_references = [
            OwnerReference(
                api_version="karpenter.sh/v1beta1",
                kind="NodePool",
                name=nodepool.name,
                uid=nodepool.uid,
                block_owner_deletion=True,
            )
        ]
        nc.spec = NodeClaimSpec(
            taints=list(self.spec.taints),
            startup_taints=list(self.spec.startup_taints),
            requirements=[r.to_node_selector_requirement() for r in reqs.values()],
            resources=NodeClaimResources(requests=dict(requests)),
            kubelet=self.spec.kubelet,
            node_class_ref=self.spec.node_class_ref,
        )
        return nc


def _max_allocatable(instance_types: List[InstanceType]) -> ResourceList:
    """Elementwise max allocatable over the surviving options — the
    add() fast screen's upper bound."""
    out: ResourceList = {}
    for it in instance_types:
        for name, value in it.allocatable().items():
            if value > out.get(name, 0):
                out[name] = value
    return out


class SchedulingNodeClaim:
    """A node we're planning to create: constraints + compatible pods +
    surviving instance types (nodeclaim.go:35)."""

    def __init__(
        self,
        template: NodeClaimTemplate,
        topology: Topology,
        daemon_resources: ResourceList,
        instance_types: List[InstanceType],
    ):
        hostname = f"hostname-placeholder-{next(_hostname_counter):04d}"
        topology.register(wk.LABEL_HOSTNAME, hostname)
        self.template = template
        self.nodepool_name = template.nodepool_name
        self.requirements = Requirements(*template.requirements.values_list())
        self.requirements.add(Requirement(wk.LABEL_HOSTNAME, OP_IN, [hostname]))
        self.instance_type_options = list(instance_types)
        self._max_alloc = _max_allocatable(self.instance_type_options)
        self.requests: ResourceList = dict(daemon_resources)
        self.daemon_resources = daemon_resources
        self.topology = topology
        self.host_port_usage = HostPortUsage()
        self.pods: List[Pod] = []

    def add(self, pod: Pod, pod_requests: Optional[ResourceList] = None) -> Optional[str]:
        """Try to place the pod; returns error string on failure without
        mutating state (nodeclaim.go:65 Add). ``pod_requests`` lets the
        scheduler's claim loop compute the pod's requests once across
        the many claims it probes."""
        if pod_requests is None:
            pod_requests = resources.requests_for_pods(pod)
        # fast resource screen: if some resource overflows the MAXIMUM
        # remaining allocatable across all surviving options, no option
        # fits — skip the per-attempt requirement algebra entirely (the
        # dominant cost when a pod probes hundreds of full claims)
        max_alloc = self._max_alloc
        requests = self.requests
        for name, value in pod_requests.items():
            if requests.get(name, 0) + value > max_alloc.get(name, 0):
                return "no instance type has sufficient remaining capacity"
        # taints
        err = Taints(self.template.spec.taints).tolerates(pod)
        if err:
            return err
        # host ports
        host_ports = get_host_ports(pod)
        err = self.host_port_usage.conflicts(pod, host_ports)
        if err:
            return f"checking host port usage, {err}"

        claim_requirements = Requirements(*self.requirements.values_list())
        pod_reqs = pod_requirements(pod)

        # nodeclaim affinity requirements
        err = claim_requirements.compatible(pod_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
        if err:
            return f"incompatible requirements, {err}"
        claim_requirements.add(*pod_reqs.values_list())

        strict_reqs = pod_reqs
        if has_preferred_node_affinity(pod):
            # preferences must not shrink the pod's domain choices
            # (nodeclaim.go:86-91)
            strict_reqs = strict_pod_requirements(pod)

        # topology
        from .topology import TopologyError

        try:
            topology_requirements = self.topology.add_requirements(
                strict_reqs, claim_requirements, pod, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            )
        except TopologyError as e:
            return str(e)
        err = claim_requirements.compatible(topology_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
        if err:
            return err
        claim_requirements.add(*topology_requirements.values_list())

        # instance types
        requests = resources.merge(self.requests, pod_requests)
        filtered = filter_instance_types_by_requirements(
            self.instance_type_options, claim_requirements, requests
        )
        if not filtered.remaining:
            cumulative = resources.merge(self.daemon_resources, pod_requests)
            return (
                f"no instance type satisfied resources {resources.to_string(cumulative)} "
                f"and requirements {claim_requirements!r} ({filtered.failure_reason()})"
            )

        # commit
        self.pods.append(pod)
        self.instance_type_options = filtered.remaining
        self._max_alloc = _max_allocatable(filtered.remaining)
        self.requests = requests
        self.requirements = claim_requirements
        self.topology.record(pod, claim_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
        self.host_port_usage.add(pod, host_ports)
        return None

    def finalize_scheduling(self) -> None:
        """Strip the placeholder hostname before launch (nodeclaim.go:123)."""
        self.requirements.pop(wk.LABEL_HOSTNAME, None)

    def to_node_claim(self, nodepool: NodePool) -> NodeClaim:
        return self.template.to_node_claim(
            nodepool, self.requirements, self.instance_type_options, self.requests
        )


@dataclass
class FilterResults:
    """Instance-type filter outcome with per-criterion tracking for rich
    failure messages (nodeclaim.go:144)."""

    remaining: List[InstanceType] = field(default_factory=list)
    requirements_met: bool = False
    fits: bool = False
    has_offering: bool = False
    requirements_and_fits: bool = False
    requirements_and_offering: bool = False
    fits_and_offering: bool = False
    requests: ResourceList = field(default_factory=dict)

    def failure_reason(self) -> str:
        if self.remaining:
            return ""
        r = self
        if not r.requirements_met and not r.fits and not r.has_offering:
            return "no instance type met the scheduling requirements or had enough resources or had a required offering"
        if not r.requirements_met and not r.fits:
            return "no instance type met the scheduling requirements or had enough resources"
        if not r.requirements_met and not r.has_offering:
            return "no instance type met the scheduling requirements or had a required offering"
        if not r.fits and not r.has_offering:
            return "no instance type had enough resources or had a required offering"
        if not r.requirements_met:
            return "no instance type met all requirements"
        if not r.fits:
            msg = "no instance type has enough resources"
            if r.requests.get("cpu", 0) >= 10**6 * 10**9:
                msg += " (CPU request >= 1 Million, m vs M typo?)"
            return msg
        if not r.has_offering:
            return "no instance type has the required offering"
        if r.requirements_and_fits:
            return "no instance type which met the scheduling requirements and had enough resources, had a required offering"
        if r.fits_and_offering:
            return "no instance type which had enough resources and the required offering met the scheduling requirements"
        if r.requirements_and_offering:
            return "no instance type which met the scheduling requirements and the required offering had the required resources"
        return "no instance type met the requirements/resources/offering tuple"


def _compatible(it: InstanceType, requirements: Requirements) -> bool:
    return it.requirements.intersects(requirements) is None


def _fits(it: InstanceType, requests: ResourceList) -> bool:
    return resources.fits(requests, it.allocatable())


def _has_offering(it: InstanceType, requirements: Requirements) -> bool:
    for o in it.offerings.available():
        if (
            not requirements.has(wk.LABEL_TOPOLOGY_ZONE)
            or requirements.get_req(wk.LABEL_TOPOLOGY_ZONE).has(o.zone)
        ) and (
            not requirements.has(wk.CAPACITY_TYPE_LABEL_KEY)
            or requirements.get_req(wk.CAPACITY_TYPE_LABEL_KEY).has(o.capacity_type)
        ):
            return True
    return False


def filter_instance_types_by_requirements(
    instance_types: List[InstanceType], requirements: Requirements, requests: ResourceList
) -> FilterResults:
    """No short-circuit: each criterion is tracked independently so the
    error message can name what excluded everything (nodeclaim.go:225).

    The hot path evaluates the three criteria as vectors against the
    tensor path's cached catalog encodings (solver.oracle_bridge) —
    per-pod-per-claim Python set algebra dominated the diverse-mix
    profile; the exact per-type loop remains as the fallback for
    shapes the bridge doesn't vectorize (Gt/Lt bounds, unregistered
    type lists)."""
    from ..solver.oracle_bridge import fast_filter, register_filtered

    results = FilterResults(requests=requests)
    vec = fast_filter(instance_types, requirements, requests)
    if vec is not None:
        compat, fits, offering = vec
        results.requirements_met = bool(compat.any())
        results.fits = bool(fits.any())
        results.has_offering = bool(offering.any())
        results.requirements_and_fits = bool((compat & fits & ~offering).any())
        results.requirements_and_offering = bool((compat & offering & ~fits).any())
        results.fits_and_offering = bool((fits & offering & ~compat).any())
        keep = compat & fits & offering
        results.remaining = [instance_types[j] for j in np.flatnonzero(keep)]
        register_filtered(instance_types, keep, results.remaining)
        return results
    for it in instance_types:
        it_compat = _compatible(it, requirements)
        it_fits = _fits(it, requests)
        it_offering = _has_offering(it, requirements)
        results.requirements_met |= it_compat
        results.fits |= it_fits
        results.has_offering |= it_offering
        results.requirements_and_fits |= it_compat and it_fits and not it_offering
        results.requirements_and_offering |= it_compat and it_offering and not it_fits
        results.fits_and_offering |= it_fits and it_offering and not it_compat
        if it_compat and it_fits and it_offering:
            results.remaining.append(it)
    return results
