"""Scheduling against in-flight/existing nodes (ref
pkg/controllers/provisioning/scheduling/existingnode.go): the port's
copy of ``karpenter_core_tpu/scheduler/existingnode.py``."""

from __future__ import annotations

from typing import List, Optional

from ..apis import labels as wk
from ..kube.objects import OP_IN, Pod, ResourceList
from ..scheduling import Requirement, Requirements, Taints, resources
from ..scheduling.hostports import get_host_ports
from ..scheduling.requirements import (
    has_preferred_node_affinity,
    label_requirements,
    pod_requirements,
    strict_pod_requirements,
)
from ..scheduling.volumes import get_volumes
from ..state.statenode import StateNode
from .topology import Topology, TopologyError


class ExistingNode:
    """A deep-copied StateNode being packed during scheduling
    (existingnode.go:31)."""

    def __init__(self, state_node: StateNode, topology: Topology, daemon_resources: ResourceList):
        self.state_node = state_node
        self.topology = topology
        self.pods: List[Pod] = []
        # remaining daemon resources = expected total minus already scheduled,
        # floored at zero (existingnode.go:43-52)
        remaining = resources.subtract(daemon_resources, state_node.daemonset_request_total())
        self.requests = {k: max(v, 0) for k, v in remaining.items()}
        self.requirements = label_requirements(state_node.labels())
        hostname = state_node.hostname()
        self.requirements.add(Requirement(wk.LABEL_HOSTNAME, OP_IN, [hostname]))
        topology.register(wk.LABEL_HOSTNAME, hostname)

    # pass-throughs
    def name(self) -> str:
        return self.state_node.name()

    def provider_id(self) -> str:
        return self.state_node.provider_id()

    def initialized(self) -> bool:
        return self.state_node.initialized()

    def add(self, kube_client, pod: Pod) -> Optional[str]:
        """Try to place the pod on this node (existingnode.go:64)."""
        err = Taints(self.state_node.taints()).tolerates(pod)
        if err:
            return err
        try:
            volumes = get_volumes(kube_client, pod) if kube_client is not None else None
        except KeyError as e:
            return str(e)
        host_ports = get_host_ports(pod)
        if volumes is not None:
            err = self.state_node.volume_usage.exceeds_limits(volumes)
            if err:
                return f"checking volume usage, {err}"
        err = self.state_node.host_port_usage.conflicts(pod, host_ports)
        if err:
            return f"checking host port usage, {err}"

        # resources first: in-flight nodes can't grow (existingnode.go:83)
        requests = resources.merge(self.requests, resources.requests_for_pods(pod))
        if not resources.fits(requests, self.state_node.available()):
            return "exceeds node resources"

        node_requirements = Requirements(*self.requirements.values_list())
        pod_reqs = pod_requirements(pod)
        err = node_requirements.compatible(pod_reqs)
        if err:
            return err
        node_requirements.add(*pod_reqs.values_list())

        strict_reqs = pod_reqs
        if has_preferred_node_affinity(pod):
            strict_reqs = strict_pod_requirements(pod)

        try:
            topology_requirements = self.topology.add_requirements(strict_reqs, node_requirements, pod)
        except TopologyError as e:
            return str(e)
        err = node_requirements.compatible(topology_requirements)
        if err:
            return err
        node_requirements.add(*topology_requirements.values_list())

        # commit
        self.pods.append(pod)
        self.requests = requests
        self.requirements = node_requirements
        self.topology.record(pod, node_requirements)
        self.state_node.host_port_usage.add(pod, host_ports)
        if volumes is not None:
            self.state_node.volume_usage.add(pod, volumes)
        return None
