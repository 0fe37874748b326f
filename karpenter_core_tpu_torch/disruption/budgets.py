"""Disruption-budget enforcement.

Counterpart of ``karpenter_core_tpu/disruption/budgets.py`` (the reference's accepted design,
designs/disruption-controls.md — its controller carries the API at
apis/v1beta1/nodepool.go:84-118 plus a TODO at
controllers/disruption/controller.go:121; this build implements it).

Per NodePool and reconcile pass:

    allowed   = most restrictive active budget's nodes value
                (int, or percent of the pool's current nodes, ceil)
    disrupting = pool nodes already being voluntarily disrupted
                 (disruption-tainted, marked for deletion, or queued)
    remaining  = max(0, allowed - disrupting)

Methods consume a snapshot of the map while selecting candidates, so a
command never disrupts more nodes per pool than its remaining budget.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

from ..apis import labels as wk
from ..apis.nodepool import Budget
from ..utils import pod as podutils
from ..utils.cron import budget_is_active

DEFAULT_BUDGET = Budget(nodes="10%")  # nodepool.go:87 kubebuilder default


def resolve_nodes_value(nodes: str, total: int) -> int:
    """A budget's ``nodes``: absolute count or percent of the pool's
    current nodes (ceil, so "10%" of a small pool still allows 1)."""
    value = str(nodes).strip()
    if value.endswith("%"):
        try:
            pct = float(value[:-1])
        except ValueError:
            return total
        return math.ceil(total * pct / 100.0)
    try:
        return max(0, int(value))
    except ValueError:
        return total


def allowed_disruptions(nodepool, total: int, now: float) -> int:
    """Most restrictive active budget; no active budget = no cap."""
    budgets = nodepool.spec.disruption.budgets or [DEFAULT_BUDGET]
    values = [
        resolve_nodes_value(b.nodes, total)
        for b in budgets
        if budget_is_active(b.schedule, b.duration, now)
    ]
    return min(values) if values else total


def _is_disrupting(state_node, queue) -> bool:
    if state_node.marked_for_deletion:
        return True
    # externally-initiated drains (kubectl delete node) consume budget
    # too — filter_candidates already excludes them for the same reason
    if (
        state_node.node is not None
        and state_node.node.metadata.deletion_timestamp is not None
    ):
        return True
    if queue is not None and queue.has_any(state_node.provider_id()):
        return True
    taint = podutils.DISRUPTION_NO_SCHEDULE_TAINT
    return any(taint.match(t) for t in state_node.taints())


def build_disruption_budgets(
    cluster, kube_client, clock: Callable[[], float], queue=None
) -> Dict[str, int]:
    """Remaining voluntary disruptions per NodePool for this pass."""
    now = clock()
    totals: Dict[str, int] = {}
    disrupting: Dict[str, int] = {}

    # read-only scan: budgets only count labels/taints/deletion marks, so
    # iterate the live snapshot (for_each_node) instead of deep-copying
    # every node+pod — the copy was half the steady no-op pass's
    # deep_copy cost at config-9 scale (r06→r07 ledger creep clawback)
    def _count(state_node) -> bool:
        pool = state_node.labels().get(wk.NODEPOOL_LABEL_KEY)
        if not pool:
            return True
        totals[pool] = totals.get(pool, 0) + 1
        if _is_disrupting(state_node, queue):
            disrupting[pool] = disrupting.get(pool, 0) + 1
        return True

    cluster.for_each_node(_count)
    remaining: Dict[str, int] = {}
    for nodepool in kube_client.list("NodePool"):
        total = totals.get(nodepool.name, 0)
        allowed = allowed_disruptions(nodepool, total, now)
        remaining[nodepool.name] = max(0, allowed - disrupting.get(nodepool.name, 0))
    return remaining
