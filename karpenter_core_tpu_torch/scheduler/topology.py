"""Topology-spread domain counting.

Counterpart of the counting half of
``karpenter_core_tpu/scheduler/topology.py`` (ref topology.go,
topologygroup.go, topologynodefilter.go): a TopologyGroup's identity,
selector and node filter, and the per-domain count of the pods already
bound in the cluster that match it. The solver seeds its spread quotas
with these counts; the oracle's per-pod domain walk (``Topology``) is
not ported yet.
"""

from __future__ import annotations

from typing import AbstractSet, Dict, List, Optional, Set

from ..apis import labels as wk
from ..kube.objects import LabelSelector, Pod
from ..scheduling import Requirements
from ..scheduling.requirements import label_requirements, node_selector_requirements
from ..utils import pod as podutils

TOPOLOGY_TYPE_SPREAD = "topology spread"
TOPOLOGY_TYPE_POD_AFFINITY = "pod affinity"
TOPOLOGY_TYPE_POD_ANTI_AFFINITY = "pod anti-affinity"


class TopologyNodeFilter:
    """OR of requirement sets restricting which nodes count for a spread
    (topologynodefilter.go:31). Empty filter matches everything."""

    def __init__(self, requirements: Optional[List[Requirements]] = None):
        self.requirements = requirements or []

    @classmethod
    def for_pod(cls, pod: Pod) -> "TopologyNodeFilter":
        selector_reqs = label_requirements(pod.spec.node_selector)
        a = pod.spec.affinity
        if a is None or a.node_affinity is None or a.node_affinity.required is None:
            return cls([selector_reqs])
        filters = []
        for term in a.node_affinity.required.node_selector_terms:
            reqs = Requirements()
            reqs.add(*selector_reqs.values_list())
            reqs.add(*node_selector_requirements(term.match_expressions).values_list())
            filters.append(reqs)
        return cls(filters)

    def matches_labels(self, labels: Dict[str, str]) -> bool:
        return self.matches_requirements(label_requirements(labels))

    def matches_requirements(
        self, requirements: Requirements, allow_undefined: AbstractSet[str] = frozenset()
    ) -> bool:
        if not self.requirements:
            return True
        return any(
            requirements.compatible(req, allow_undefined, hint=False) is None
            for req in self.requirements
        )

    def key(self) -> tuple:
        return tuple(
            tuple(
                sorted(
                    (k, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
                    for k, r in reqs.items()
                )
            )
            for reqs in self.requirements
        )


class TopologyGroup:
    """Pod counts per domain for one constraint (topologygroup.go:56):
    the parts that counting reads."""

    def __init__(
        self,
        topology_type: str,
        key: str,
        pod: Optional[Pod],
        namespaces: Set[str],
        selector: Optional[LabelSelector],
        max_skew: int,
        min_domains: Optional[int],
        domains: Set[str],
    ):
        self.type = topology_type
        self.key = key
        self.namespaces = set(namespaces)
        self.selector = selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        self.domains: Dict[str, int] = {d: 0 for d in domains}
        self.node_filter = (
            TopologyNodeFilter.for_pod(pod)
            if topology_type == TOPOLOGY_TYPE_SPREAD and pod is not None
            else TopologyNodeFilter()
        )

    def selects(self, pod: Pod) -> bool:
        if pod.namespace not in self.namespaces:
            return False
        if self.selector is None:
            # a nil LabelSelector selects nothing (metav1 semantics)
            return False
        return self.selector.matches(pod.metadata.labels)


def _ignored_for_topology(p: Pod) -> bool:
    return not podutils.is_scheduled(p) or podutils.is_terminal(p) or podutils.is_terminating(p)


def count_matching_pods_by_domain(kube_client, tg: TopologyGroup, excluded_uids) -> Dict[str, int]:
    """Per-domain count of the bound pods matching a topology group's
    selector, namespaces and node filter (topology.go:238 countDomains).
    Pods of the batch being solved (``excluded_uids``), unscheduled,
    terminal and terminating pods do not count."""
    counts: Dict[str, int] = {}
    if kube_client is None:
        return counts
    pods: List[Pod] = []
    for ns in tg.namespaces:
        pods.extend(
            kube_client.list("Pod", namespace=ns, label_selector=tg.selector or LabelSelector())
        )
    for p in pods:
        if _ignored_for_topology(p) or p.uid in excluded_uids:
            continue
        node = kube_client.get("Node", p.spec.node_name)
        if node is None:
            continue
        domain = node.metadata.labels.get(tg.key)
        if domain is None and tg.key == wk.LABEL_HOSTNAME:
            # the node may not be labeled yet: its name is the domain
            # (topology.go:272-279)
            domain = node.name
        if domain is None:
            continue
        if not tg.node_filter.matches_labels(node.metadata.labels):
            continue
        counts[domain] = counts.get(domain, 0) + 1
    return counts
