"""Event constructors (refs: provisioning/scheduling/events.go,
disruption/events/events.go, node/terminator/events/events.go,
nodeclaim/lifecycle/events.go): the port's copy of
``karpenter_core_tpu/events/events.py``."""

from __future__ import annotations

from .recorder import Event, NORMAL, WARNING


def pod_failed_to_schedule(pod, err) -> Event:
    return Event(
        involved_object=pod,
        type=WARNING,
        reason="FailedScheduling",
        message=f"Failed to schedule pod, {err}",
        dedupe_timeout=300.0,  # scheduling/events.go 5 min
        dedupe_values=(pod.namespace, pod.name, str(err)),
    )


def nominate_pod(pod, node_name) -> Event:
    return Event(
        involved_object=pod,
        type=NORMAL,
        reason="Nominated",
        message=f"Pod should schedule on: {node_name}",
        dedupe_values=(pod.namespace, pod.name, node_name),
    )


def disrupt_node(node, method, reason="") -> Event:
    return Event(
        involved_object=node,
        type=NORMAL,
        reason=f"Disrupt{method}",
        message=f"Disrupting node via {method} {reason}".strip(),
        dedupe_values=(node.name, method),
    )


def blocked(obj, reason: str, message: str) -> Event:
    return Event(
        involved_object=obj,
        type=NORMAL,
        reason=f"DisruptionBlocked",
        message=message,
        dedupe_values=(getattr(obj, "name", ""), reason),
    )


def evict(pod) -> Event:
    return Event(
        involved_object=pod,
        type=NORMAL,
        reason="Evicted",
        message="Evicted pod",
        dedupe_values=(pod.namespace, pod.name),
    )


def node_failed_to_drain(node, err) -> Event:
    return Event(
        involved_object=node,
        type=WARNING,
        reason="FailedDraining",
        message=f"Failed to drain node, {err}",
        dedupe_values=(node.name,),
    )


def insufficient_capacity(node_claim, err) -> Event:
    return Event(
        involved_object=node_claim,
        type=WARNING,
        reason="InsufficientCapacityError",
        message=f"NodeClaim {node_claim.name} event: {err}",
        dedupe_values=(node_claim.name,),
    )


def consistency_check_failed(obj, message: str) -> Event:
    return Event(
        involved_object=obj,
        type=WARNING,
        reason="FailedConsistencyCheck",
        message=message,
        dedupe_values=(getattr(obj, "name", ""), message),
    )
