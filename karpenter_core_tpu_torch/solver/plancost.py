"""Plan-cost evaluation: dollars, bounds, optimality gap.

Counterpart of ``karpenter_core_tpu/solver/plancost.py``, whole; the
relaxation bound runs the port's LP backend on ``device`` (None: the
card).

Node-count parity against the greedy oracle proves the solver opens no more
nodes than the greedy oracle — it says nothing about what the fleet
*costs*. This module prices emitted plans and certifies how far they
can possibly be from optimal:

- ``fleet_cost(plans)`` — $/hr of the emitted fleet: the sum of each
  plan's offering price, exactly what the provisioner will pay.
- ``relaxation_lower_bound(plans, instance_types)`` — a certified lower
  bound on the $/hr of ANY feasible plan that schedules the same pods
  onto these instance types, from the LP dual (backends/lp.py
  ``dual_bound``). The bound deliberately relaxes in the safe
  direction everywhere: full (un-daemon-adjusted) allocatable, each
  type's cheapest offering price unconditionally, no viability masks
  beyond resource fit — every loosening can only LOWER the bound, so
  ``bound ≤ fleet_cost`` holds for every emitted plan by weak duality
  (the property tests/test_torch_lp.py holds the inequality on
  randomized workloads).
- ``optimality_gap(cost, bound)`` — (cost − bound) / bound, the number
  the benches report alongside node counts: how much of the fleet
  price is *provably* irreducible vs potentially-recoverable slack.
  The gap conflates true suboptimality with bound looseness (integer
  slack the relaxation cannot see), so it is an upper bound on the
  recoverable dollars.

The optimality tier generalizes the objective beyond $/hr:
``cost_weights()`` parses ``COST_WEIGHTS`` into weighted
terms — offering price, disruption cost (``pod_eviction_cost``),
topology-spread slack, consolidation headroom — and
``pareto_report(plans)`` evaluates every term per solve regardless of
weights, so the trade-off surface is visible even when only price is
optimized. Price stays the DOMINANT objective everywhere plans are
chosen: the LP guard admits a candidate on strict price improvement
only, and the non-price weights act as tie-breaks (headroom) and
reporting weights, never as license to emit a costlier plan. The
weights ride the LP backend's ``job_token`` so two weight settings can
never alias one memoized skeleton stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

#: fixed weight order — weights_token() must be stable across processes
_WEIGHT_NAMES = ("price", "disruption", "spread", "headroom")
# the weight vector as "price=1,disruption=0.5,spread=0.1,headroom=0.2"
# — the JAX package's KARPENTER_TPU_COST_WEIGHTS default: price only
COST_WEIGHTS = ""
# the pod annotation that raises a pod's eviction cost (helpers.go)
POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def pod_eviction_cost(pod) -> float:
    """helpers.go GetPodEvictionCost: base 1.0, scaled by the deletion-cost
    annotation and pod priority (the JAX package's
    ``disruption.types.pod_eviction_cost``, memoized on the pod behind its
    resource_version)."""
    cached = getattr(pod, "_karp_evict", None)
    rv = pod.metadata.resource_version
    if cached is not None and cached[0] == rv:
        return cached[1]
    cost = 1.0
    deletion_cost = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if deletion_cost:
        try:
            # higher deletion cost = more expensive to evict
            cost += float(deletion_cost) / 10.0
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += float(pod.spec.priority) / 1e6
    pod._karp_evict = (rv, cost)
    return cost


def cost_weights() -> dict:
    """The multi-objective weight vector, parsed fresh per read from
    ``COST_WEIGHTS``. Defaults to price-only (1, 0, 0, 0). Unknown names
    and malformed entries are ignored, negatives clamp to 0: a typo must
    degrade to the default, never fail a solve."""
    weights = {name: 0.0 for name in _WEIGHT_NAMES}
    weights["price"] = 1.0
    for part in COST_WEIGHTS.split(","):
        if "=" not in part:
            continue
        name, _, val = part.partition("=")
        name = name.strip().lower()
        if name not in weights:
            continue
        try:
            weights[name] = max(0.0, float(val))
        except ValueError:
            continue
    return weights


def weights_token() -> tuple:
    """The weights as a deterministic tuple in ``_WEIGHT_NAMES`` order —
    the component the LP backend folds into ``job_token`` so a weight
    change is a different memo stream, never an aliased one."""
    w = cost_weights()
    return tuple(round(w[name], 9) for name in _WEIGHT_NAMES)


def weights_active() -> bool:
    """True when any non-price objective carries weight."""
    w = cost_weights()
    return any(w[name] > 0.0 for name in _WEIGHT_NAMES if name != "price")


def fleet_cost(plans: Sequence) -> float:
    """$/hr of the emitted fleet — the sum of each NodePlan's offering
    price (SolverResult.total_price over an explicit plan list)."""
    return float(sum(p.price for p in plans))


def optimality_gap(cost: float, bound: float) -> Optional[float]:
    """(cost − bound)/bound, or None when the bound is degenerate."""
    if bound is None or bound <= 0 or not np.isfinite(bound):
        return None
    return max(0.0, (float(cost) - float(bound)) / float(bound))


def relaxation_lower_bound(
    plans: Sequence,
    instance_types: Sequence,
    iters: int = 256,
    device=None,
) -> float:
    """Certified $/hr lower bound for the pods of ``plans`` on
    ``instance_types`` (pass the union catalog when plans span pools —
    more types only loosens, which is the safe direction).

    Sound against ``fleet_cost(plans)`` because every emitted plan is
    feasible in the relaxation: each node's pods fit its (quantized)
    type capacity, and each node's offering price is ≥ its type's
    cheapest offering price."""
    from .backends import lp as lp_mod
    from .encode import build_axis_from_capacities, build_requests_matrix, quantize_capacity

    instance_types = list(instance_types)
    if not plans or not instance_types:
        return 0.0
    requests: List[dict] = []
    for plan in plans:
        pod_requests = getattr(plan, "_pod_requests", None) or []
        requests.extend(pod_requests)
    if not requests:
        return 0.0
    axis = build_axis_from_capacities([it.capacity for it in instance_types])
    alloc = np.stack(
        [quantize_capacity(it.allocatable(), axis) for it in instance_types]
    ).astype(np.float64)
    prices = np.array(
        [
            min(
                (o.price for o in it.offerings if o.available),
                default=float("inf"),
            )
            for it in instance_types
        ],
        dtype=np.float64,
    )
    reqs = build_requests_matrix(requests, axis).astype(np.float64)
    return lp_mod.dual_bound(reqs, alloc, prices, iters=iters, device=device)


def cost_block(result, instance_types: Sequence, iters: int = 256, device=None) -> dict:
    """The bench-facing rollup: plan cost, relaxation bound, gap —
    ``result`` is a SolverResult (new node plans only; existing-node
    placements are free)."""
    cost = fleet_cost(result.node_plans)
    bound = relaxation_lower_bound(result.node_plans, instance_types, iters=iters, device=device)
    gap = optimality_gap(cost, bound)
    return {
        "plan_cost_per_hr": round(cost, 4),
        "lp_bound_per_hr": round(bound, 4),
        "opt_gap_pct": round(gap * 100.0, 2) if gap is not None else None,
    }


def pareto_report(plans: Sequence) -> Optional[dict]:
    """Per-solve multi-objective report: every objective
    evaluated on the emitted plans, plus the active weights and the
    weighted scalarization. Reporting only — plan choice happens in the
    backends under the price-dominant guard; this surfaces what that
    choice cost along the other axes.

    Objectives (all "smaller is better" except headroom):

    - ``price`` — fleet_cost, $/hr.
    - ``disruption`` — Σ pod_eviction_cost over the plans' pods: what
      consolidating these placements away would cost later. Falls back to pod count where pod objects aren't resolved.
    - ``spread_slack`` — max−min of the per-zone new-node counts: how
      unbalanced the plan leaves the zone topology (0 = perfectly
      spread or single-zone).
    - ``headroom`` — mean free-capacity fraction across opened nodes
      (dominant resource axis): consolidation room the plan keeps.

    ``weighted_total`` folds them with cost_weights(), headroom entering
    as its complement (1 − headroom) so every term is a cost."""
    plans = list(plans)
    if not plans:
        return None
    weights = cost_weights()
    price = fleet_cost(plans)
    disruption = 0.0
    zone_counts: dict = {}
    headroom_fracs: List[float] = []
    # plans repeat a handful of types — resolve each type's allocatable
    # dict once per report, not once per opened node (this runs on the
    # warm solve path, where per-plan Python work is the latency)
    alloc_memo: dict = {}
    for plan in plans:
        pods = getattr(plan, "pods", None)
        if pods:
            disruption += float(sum(pod_eviction_cost(p) for p in pods))
        else:
            disruption += float(len(getattr(plan, "pod_indices", ()) or ()))
        zone = getattr(plan, "zone", None) or ""
        zone_counts[zone] = zone_counts.get(zone, 0) + 1
        it = getattr(plan, "instance_type", None)
        reqs = getattr(plan, "requests", None)
        if it is None or not reqs:
            continue
        try:
            alloc = alloc_memo.get(id(it))
            if alloc is None:
                alloc = [
                    (res, float(cap))
                    for res, cap in it.allocatable().items()
                    if float(cap) > 0
                ]
                alloc_memo[id(it)] = alloc
            used = max(
                (float(reqs.get(res, 0.0)) / cap for res, cap in alloc),
                default=0.0,
            )
        except (TypeError, ValueError):
            continue
        headroom_fracs.append(min(max(1.0 - used, 0.0), 1.0))
    spread_slack = (
        float(max(zone_counts.values()) - min(zone_counts.values()))
        if len(zone_counts) > 1
        else 0.0
    )
    headroom = (
        sum(headroom_fracs) / len(headroom_fracs) if headroom_fracs else None
    )
    weighted = (
        weights["price"] * price
        + weights["disruption"] * disruption
        + weights["spread"] * spread_slack
        + weights["headroom"] * (1.0 - (headroom if headroom is not None else 1.0))
    )
    return {
        "price_per_hr": round(price, 4),
        "disruption_cost": round(disruption, 4),
        "spread_slack": round(spread_slack, 4),
        "headroom": round(headroom, 4) if headroom is not None else None,
        "weights": {name: weights[name] for name in _WEIGHT_NAMES},
        "weighted_total": round(weighted, 4),
    }
