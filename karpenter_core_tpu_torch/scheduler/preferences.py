"""Preference relaxation ladder (ref
pkg/controllers/provisioning/scheduling/preferences.go): the port's copy
of ``karpenter_core_tpu/scheduler/preferences.py``.

When a pod can't schedule, soft constraints are peeled off one per
round, in a fixed order, and the pod is re-queued.
"""

from __future__ import annotations

from typing import Optional

from ..kube.objects import (
    EFFECT_PREFER_NO_SCHEDULE,
    Pod,
    SCHEDULE_ANYWAY,
    Toleration,
)


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        # only added when some NodePool actually has a PreferNoSchedule taint
        # (scheduler.go:54-63)
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        """Try each relaxation; True if one applied (preferences.go:38)."""
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for fn in relaxations:
            if fn(pod) is not None:
                # in-place spec mutation without a resource_version bump:
                # drop the pod's scheduling memo (solver.podcache) so the
                # next solve re-derives its signature from the relaxed spec
                pod.__dict__.pop("_karp_memo", None)
                return True
        return False

    @staticmethod
    def _remove_preferred_node_affinity_term(pod: Pod) -> Optional[str]:
        a = pod.spec.affinity
        if a is None or a.node_affinity is None or not a.node_affinity.preferred:
            return None
        terms = sorted(a.node_affinity.preferred, key=lambda t: -t.weight)
        removed = terms[0]
        a.node_affinity.preferred = terms[1:]
        return f"removing preferred node affinity term weight={removed.weight}"

    @staticmethod
    def _remove_required_node_affinity_term(pod: Pod) -> Optional[str]:
        a = pod.spec.affinity
        if (
            a is None
            or a.node_affinity is None
            or a.node_affinity.required is None
            or not a.node_affinity.required.node_selector_terms
        ):
            return None
        terms = a.node_affinity.required.node_selector_terms
        # OR semantics: drop the first term only if others remain
        # (preferences.go:84)
        if len(terms) > 1:
            a.node_affinity.required.node_selector_terms = terms[1:]
            return "removing required node affinity term[0]"
        return None

    @staticmethod
    def _remove_topology_spread_schedule_anyway(pod: Pod) -> Optional[str]:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == SCHEDULE_ANYWAY:
                # swap-remove, like the reference (preferences.go:95)
                last = len(pod.spec.topology_spread_constraints) - 1
                pod.spec.topology_spread_constraints[i] = pod.spec.topology_spread_constraints[last]
                pod.spec.topology_spread_constraints.pop()
                return f"removing ScheduleAnyway topology spread on {tsc.topology_key}"
        return None

    @staticmethod
    def _remove_preferred_pod_affinity_term(pod: Pod) -> Optional[str]:
        a = pod.spec.affinity
        if a is None or a.pod_affinity is None or not a.pod_affinity.preferred:
            return None
        terms = sorted(a.pod_affinity.preferred, key=lambda t: -t.weight)
        a.pod_affinity.preferred = terms[1:]
        return "removing preferred pod affinity term[0]"

    @staticmethod
    def _remove_preferred_pod_anti_affinity_term(pod: Pod) -> Optional[str]:
        a = pod.spec.affinity
        if a is None or a.pod_anti_affinity is None or not a.pod_anti_affinity.preferred:
            return None
        terms = sorted(a.pod_anti_affinity.preferred, key=lambda t: -t.weight)
        a.pod_anti_affinity.preferred = terms[1:]
        return "removing preferred pod anti-affinity term[0]"

    @staticmethod
    def _tolerate_prefer_no_schedule_taints(pod: Pod) -> Optional[str]:
        toleration = Toleration(operator="Exists", effect=EFFECT_PREFER_NO_SCHEDULE)
        for t in pod.spec.tolerations:
            if t.match_toleration(toleration):
                return None
        pod.spec.tolerations.append(toleration)
        return "adding toleration for PreferNoSchedule taints"
