"""Topology engine: spread constraints, pod affinity/anti-affinity
(ref pkg/controllers/provisioning/scheduling/topology.go,
topologygroup.go, topologynodefilter.go): the port's copy of
``karpenter_core_tpu/scheduler/topology.py``.

The batched solve reads the counting half (a group's identity, selector
and node filter, and ``count_matching_pods_by_domain``, which seeds its
spread and affinity quotas); the greedy scheduler walks the domains pod
by pod through ``Topology``, which with a ``cluster`` (state.cluster)
also tracks the inverse anti-affinity of the pods already bound there.
"""

from __future__ import annotations

from typing import AbstractSet, Dict, List, Optional, Set, Tuple

from ..apis import labels as wk
from ..kube.objects import (
    LabelSelector,
    OP_DOES_NOT_EXIST,
    OP_IN,
    Pod,
)
from ..scheduling import Requirement, Requirements
from ..scheduling.requirements import label_requirements, node_selector_requirements
from ..utils import pod as podutils

TOPOLOGY_TYPE_SPREAD = "topology spread"
TOPOLOGY_TYPE_POD_AFFINITY = "pod affinity"
TOPOLOGY_TYPE_POD_ANTI_AFFINITY = "pod anti-affinity"

MAX_INT32 = (1 << 31) - 1


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
        return any(requirements.compatible(req, allow_undefined, hint=False) is None for req in self.requirements)

    def key(self) -> tuple:
        return tuple(
            tuple(sorted((k, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than) for k, r in reqs.items()))
            for reqs in self.requirements
        )


class TopologyGroup:
    """Pod counts per domain for one constraint (topologygroup.go:56)."""

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
        self.owners: Set[str] = set()  # pod UIDs governed by this group
        self.node_filter = (
            TopologyNodeFilter.for_pod(pod)
            if topology_type == TOPOLOGY_TYPE_SPREAD and pod is not None
            else TopologyNodeFilter()
        )

    # -- identity (topologygroup.go:142 Hash) ------------------------------

    def hash_key(self) -> tuple:
        return (
            self.type,
            self.key,
            frozenset(self.namespaces),
            self.selector.key() if self.selector else None,
            self.max_skew,
            self.node_filter.key(),
        )

    # -- domain selection (topologygroup.go:93 Get) ------------------------

    def get(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type == TOPOLOGY_TYPE_SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TOPOLOGY_TYPE_POD_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains)

    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1

    def counts(
        self, pod: Pod, requirements: Requirements, allow_undefined: AbstractSet[str] = frozenset()
    ) -> bool:
        """Would this pod count against the group on a node with these
        requirements? (topologygroup.go:114)"""
        return self.selects(pod) and self.node_filter.matches_requirements(
            requirements, allow_undefined
        )

    def register(self, *domains: str) -> None:
        for d in domains:
            self.domains.setdefault(d, 0)

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    def selects(self, pod: Pod) -> bool:
        if pod.namespace not in self.namespaces:
            return False
        if self.selector is None:
            # nil LabelSelector selects nothing in metav1 semantics...
            # except the reference builds groups from the pod's own
            # constraints where nil selector matches nothing
            return False
        return self.selector.matches(pod.metadata.labels)

    # -- internals ---------------------------------------------------------

    def _next_domain_spread(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """Min-count domain within maxSkew of the global min
        (topologygroup.go:163)."""
        min_count = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        min_domain = None
        min_domain_count = MAX_INT32
        for domain, count in self.domains.items():
            if node_domains.has(domain):
                if self_selecting:
                    count += 1
                if count - min_count <= self.max_skew and count < min_domain_count:
                    min_domain = domain
                    min_domain_count = count
        if min_domain is None:
            return Requirement(self.key, OP_DOES_NOT_EXIST)
        return Requirement(self.key, OP_IN, [min_domain])

    def _domain_min_count(self, domains: Requirement) -> int:
        """Global min count over pod-supported domains; hostname topologies
        have min 0 (we can always create a node) (topologygroup.go:192)."""
        if self.key == wk.LABEL_HOSTNAME:
            return 0
        min_count = MAX_INT32
        supported = 0
        for domain, count in self.domains.items():
            if domains.has(domain):
                supported += 1
                if count < min_count:
                    min_count = count
        if self.min_domains is not None and supported < self.min_domains:
            min_count = 0
        return min_count

    def _next_domain_affinity(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """Domains already holding a matching pod; bootstrap for
        self-selecting pods (topologygroup.go:215)."""
        options = Requirement(self.key, OP_DOES_NOT_EXIST)
        for domain, count in self.domains.items():
            if pod_domains.has(domain) and count > 0:
                options.insert(domain)
        if options.len() == 0 and self.selects(pod):
            intersected = pod_domains.intersection(node_domains)
            for domain in self.domains:
                if intersected.has(domain):
                    options.insert(domain)
                    break
            for domain in self.domains:
                if pod_domains.has(domain):
                    options.insert(domain)
                    break
        return options

    def _next_domain_anti_affinity(self, domains: Requirement) -> Requirement:
        """Domains with zero matching pods (topologygroup.go:248)."""
        options = Requirement(self.key, OP_DOES_NOT_EXIST)
        for domain, count in self.domains.items():
            if domains.has(domain) and count == 0:
                options.insert(domain)
        return options

    def admissible_domains(self, pod: Pod, pod_domains: Requirement) -> Optional[Set[str]]:
        """The single-valued node domains {d} for which get() would return
        a non-empty requirement — i.e. the claims this group could accept
        the pod on, as a function of per-domain counts only. Returns None
        when the outcome is not claim-independent (affinity bootstrap,
        where get() may offer a domain outside node_domains)."""
        if self.type == TOPOLOGY_TYPE_SPREAD:
            min_count = self._domain_min_count(pod_domains)
            bump = 1 if self.selects(pod) else 0
            return {
                d
                for d, c in self.domains.items()
                if (c + bump) - min_count <= self.max_skew
            }
        if self.type == TOPOLOGY_TYPE_POD_AFFINITY:
            anchored = {
                d for d, c in self.domains.items() if c > 0 and pod_domains.has(d)
            }
            if anchored:
                return anchored
            if self.selects(pod):
                return None  # bootstrap: get() falls back past node_domains
            return set()
        return {d for d, c in self.domains.items() if c == 0 and pod_domains.has(d)}


def _ignored_for_topology(p: Pod) -> bool:
    return not podutils.is_scheduled(p) or podutils.is_terminal(p) or podutils.is_terminating(p)


def count_matching_pods_by_domain(
    kube_client, tg: TopologyGroup, excluded_uids
) -> Dict[str, int]:
    """Per-domain count of existing pods matching a topology group's
    selector/namespaces/node filter (topology.go:238 countDomains).
    Shared by the oracle's seeding and the tensor path's
    (solver/topology_tensor.py) so the two can't drift."""
    counts: Dict[str, int] = {}
    if kube_client is None:
        return counts
    pods: List[Pod] = []
    for ns in tg.namespaces:
        pods.extend(
            kube_client.list(
                "Pod", namespace=ns, label_selector=tg.selector or LabelSelector()
            )
        )
    for p in pods:
        if _ignored_for_topology(p) or p.uid in excluded_uids:
            continue
        node = kube_client.get("Node", p.spec.node_name)
        if node is None:
            continue
        domain = node.metadata.labels.get(tg.key)
        if domain is None and tg.key == wk.LABEL_HOSTNAME:
            # node may not be labeled yet; fall back to node name
            # (topology.go:272-279)
            domain = node.name
        if domain is None:
            continue
        if not tg.node_filter.matches_labels(node.metadata.labels):
            continue
        counts[domain] = counts.get(domain, 0) + 1
    return counts


class Topology:
    """All topology groups for one scheduling batch (topology.go:42)."""

    def __init__(
        self,
        kube_client,
        cluster,
        domains: Dict[str, Set[str]],
        pods: List[Pod],
    ):
        self.kube_client = kube_client
        self.cluster = cluster
        self.domain_universe = domains
        self.topologies: Dict[tuple, TopologyGroup] = {}
        self.inverse_topologies: Dict[tuple, TopologyGroup] = {}
        self._owner_index: Dict[str, List[TopologyGroup]] = {}
        # (namespace, labels) → groups selecting such pods, invalidated
        # by generation when a group is registered: record() runs per
        # landed pod and a full selector scan there dominated profiles
        self._select_cache: Dict[tuple, Tuple[int, List[TopologyGroup]]] = {}
        self._groups_generation = 0
        # pods being scheduled don't count against existing topologies
        # (topology.go:71-75)
        self.excluded_pods: Set[str] = {p.uid for p in pods}
        self._update_inverse_affinities()
        for p in pods:
            self.update(p)

    # -- group registration ------------------------------------------------

    def update(self, pod: Pod) -> None:
        """(Re)register the pod as owner of its constraint groups; called
        after relaxation to drop stale ownership (topology.go:91)."""
        # ownership only ever lands via this method, which also indexes
        # it — so the index is a complete view for removal
        for tg in self._owner_index.get(pod.uid, ()):
            tg.remove_owner(pod.uid)

        if podutils.has_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod, None)

        groups = self._new_for_topologies(pod) + self._new_for_affinities(pod)
        # dedup by hash key: two of a pod's terms can hash to the same
        # group (e.g. identical required+preferred affinity terms), and
        # the old full-dict scan naturally returned each group once
        owned: Dict[tuple, TopologyGroup] = {}
        for tg in groups:
            key = tg.hash_key()
            existing = self.topologies.get(key)
            if existing is None:
                self._count_domains(tg)
                self.topologies[key] = tg
                self._groups_generation += 1
            else:
                tg = existing
            tg.add_owner(pod.uid)
            owned[key] = tg
        # pod → owned groups index: _matching_topologies runs per
        # pod-per-claim attempt, and a full scan of every group there
        # dominated the diverse-mix profile
        self._owner_index[pod.uid] = list(owned.values())

    def _groups_selecting(self, pod: Pod) -> List[TopologyGroup]:
        """Groups whose selector/namespaces match the pod, cached per
        (namespace, labels) — selects() depends on nothing else."""
        key = (pod.namespace, tuple(sorted(pod.metadata.labels.items())))
        hit = self._select_cache.get(key)
        if hit is not None and hit[0] == self._groups_generation:
            return hit[1]
        out = [tg for tg in self.topologies.values() if tg.selects(pod)]
        if len(self._select_cache) > 4096:
            self._select_cache.clear()
        self._select_cache[key] = (self._groups_generation, out)
        return out

    def record(
        self, pod: Pod, requirements: Requirements, allow_undefined: AbstractSet[str] = frozenset()
    ) -> None:
        """Commit domain counts once the pod lands (topology.go:125)."""
        for tg in self._groups_selecting(pod):
            if tg.node_filter.matches_requirements(requirements, allow_undefined):
                domains = requirements.get_req(tg.key)
                if tg.type == TOPOLOGY_TYPE_POD_ANTI_AFFINITY:
                    tg.record(*sorted(domains.values))
                elif domains.len() == 1:
                    tg.record(next(iter(domains.values)))
        for tg in self.inverse_topologies.values():
            if tg.is_owned_by(pod.uid):
                tg.record(*sorted(requirements.get_req(tg.key).values))

    def add_requirements(
        self,
        pod_requirements: Requirements,
        node_requirements: Requirements,
        pod: Pod,
        allow_undefined: AbstractSet[str] = frozenset(),
    ) -> Requirements:
        """Tighten node requirements to topology-admissible domains; raises
        on unsatisfiable (topology.go:154)."""
        requirements = Requirements(*node_requirements.values_list())
        for tg in self._matching_topologies(pod, node_requirements, allow_undefined):
            pod_domains = pod_requirements.get_req(tg.key)
            node_domains = node_requirements.get_req(tg.key)
            domains = tg.get(pod, pod_domains, node_domains)
            if domains.len() == 0:
                raise TopologyError(
                    f"unsatisfiable topology constraint for {tg.type}, key={tg.key} "
                    f"(counts = {tg.domains}, podDomains = {pod_domains!r}, "
                    f"nodeDomains = {node_domains!r})"
                )
            requirements.add(domains)
        return requirements

    def register(self, topology_key: str, domain: str) -> None:
        """Make a new domain (e.g. a new hostname) known (topology.go:175)."""
        for tg in self.topologies.values():
            if tg.key == topology_key:
                tg.register(domain)
        for tg in self.inverse_topologies.values():
            if tg.key == topology_key:
                tg.register(domain)

    def admissible_by_key(
        self, pod: Pod, pod_requirements: Requirements
    ) -> Optional[Dict[str, Set[str]]]:
        """Per topology key, the domain values on which some claim could
        still accept this pod; None when no group constrains it claim-
        independently. get()'s per-claim outcome depends only on
        per-domain counts and the claim's value set for the key, so the
        scheduler's claim loop computes this once per pod and skips
        claims whose concrete values are disjoint from the admissible
        set, instead of paying add()'s requirement/topology machinery
        per doomed attempt (which dominated the diverse-mix profile)."""
        result: Optional[Dict[str, Set[str]]] = None

        def fold(tg: TopologyGroup) -> None:
            nonlocal result
            dom = tg.admissible_domains(pod, pod_requirements.get_req(tg.key))
            if dom is None:
                return
            if result is None:
                result = {tg.key: dom}
            elif tg.key in result:
                result[tg.key] &= dom
            else:
                result[tg.key] = dom

        for tg in self._owner_index.get(pod.uid, ()):
            fold(tg)
        # inverse groups are always anti-affinity with an empty node
        # filter (built that way in _update_inverse_anti_affinity), so
        # their per-claim membership reduces to selects(pod)
        for tg in self.inverse_topologies.values():
            if tg.selects(pod):
                fold(tg)
        return result

    # -- internals ---------------------------------------------------------

    def _update_inverse_affinities(self) -> None:
        """Track existing pods with anti-affinity: they block domains for
        pods they select (topology.go:190)."""
        if self.cluster is None:
            return

        def visit(pod: Pod, node) -> bool:
            if pod.uid not in self.excluded_pods:
                self._update_inverse_anti_affinity(
                    pod, node.metadata.labels if node is not None else None
                )
            return True

        self.cluster.for_pods_with_anti_affinity(visit)

    def _update_inverse_anti_affinity(self, pod: Pod, node_labels: Optional[Dict[str, str]]) -> None:
        """Only required inverse anti-affinities are tracked
        (topology.go:207)."""
        assert pod.spec.affinity and pod.spec.affinity.pod_anti_affinity
        for term in pod.spec.affinity.pod_anti_affinity.required:
            namespaces = self._build_namespace_list(pod.namespace, term.namespaces, term.namespace_selector)
            tg = TopologyGroup(
                TOPOLOGY_TYPE_POD_ANTI_AFFINITY,
                term.topology_key,
                pod,
                namespaces,
                term.label_selector,
                MAX_INT32,
                None,
                self.domain_universe.get(term.topology_key, set()),
            )
            key = tg.hash_key()
            existing = self.inverse_topologies.get(key)
            if existing is None:
                self.inverse_topologies[key] = tg
            else:
                tg = existing
            if node_labels and tg.key in node_labels:
                tg.record(node_labels[tg.key])
            tg.add_owner(pod.uid)

    def _count_domains(self, tg: TopologyGroup) -> None:
        """Count existing matching pods into the group (topology.go:238)."""
        for domain, n in count_matching_pods_by_domain(
            self.kube_client, tg, self.excluded_pods
        ).items():
            tg.domains[domain] = tg.domains.get(domain, 0) + n

    def _new_for_topologies(self, p: Pod) -> List[TopologyGroup]:
        groups = []
        for cs in p.spec.topology_spread_constraints:
            groups.append(
                TopologyGroup(
                    TOPOLOGY_TYPE_SPREAD,
                    cs.topology_key,
                    p,
                    {p.namespace},
                    cs.label_selector,
                    cs.max_skew,
                    cs.min_domains,
                    self.domain_universe.get(cs.topology_key, set()),
                )
            )
        return groups

    def _new_for_affinities(self, p: Pod) -> List[TopologyGroup]:
        """Both hard and soft affinity terms become groups; soft ones are
        dropped via relaxation (topology.go:302)."""
        groups = []
        a = p.spec.affinity
        if a is None:
            return groups
        terms: List[Tuple[str, object]] = []
        if a.pod_affinity is not None:
            terms += [(TOPOLOGY_TYPE_POD_AFFINITY, t) for t in a.pod_affinity.required]
            terms += [(TOPOLOGY_TYPE_POD_AFFINITY, t.pod_affinity_term) for t in a.pod_affinity.preferred]
        if a.pod_anti_affinity is not None:
            terms += [(TOPOLOGY_TYPE_POD_ANTI_AFFINITY, t) for t in a.pod_anti_affinity.required]
            terms += [
                (TOPOLOGY_TYPE_POD_ANTI_AFFINITY, t.pod_affinity_term)
                for t in a.pod_anti_affinity.preferred
            ]
        for topology_type, term in terms:
            namespaces = self._build_namespace_list(p.namespace, term.namespaces, term.namespace_selector)
            groups.append(
                TopologyGroup(
                    topology_type,
                    term.topology_key,
                    p,
                    namespaces,
                    term.label_selector,
                    MAX_INT32,
                    None,
                    self.domain_universe.get(term.topology_key, set()),
                )
            )
        return groups

    def _build_namespace_list(
        self, namespace: str, namespaces: List[str], selector: Optional[LabelSelector]
    ) -> Set[str]:
        """Pod's namespace + listed + selected (topology.go:341)."""
        if not namespaces and selector is None:
            return {namespace}
        if selector is None:
            return set(namespaces)
        selected = set(namespaces)
        if self.kube_client is not None:
            for ns in self.kube_client.list("Namespace", label_selector=selector):
                selected.add(ns.name)
        return selected

    def _matching_topologies(
        self, p: Pod, requirements: Requirements, allow_undefined: AbstractSet[str]
    ) -> List[TopologyGroup]:
        """Groups owning p (indexed — update() maintains it), plus
        inverse groups selecting p (topology.go:366)."""
        matching = list(self._owner_index.get(p.uid, ()))
        matching += [
            tg
            for tg in self.inverse_topologies.values()
            if tg.counts(p, requirements, allow_undefined)
        ]
        return matching


class TopologyError(Exception):
    pass
