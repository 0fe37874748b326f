"""Disruption helpers: candidate filtering, scheduling simulation, price
filtering, PDB limits.

Counterpart of ``karpenter_core_tpu/disruption/helpers.py`` (ref
pkg/controllers/disruption/helpers.go, pdblimits.go). A provisioner that
runs the batched solver runs its simulations on a long-lived
``TorchScheduler`` on the provisioner's device."""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..apis import labels as wk
from ..cloudprovider.types import InstanceType
from ..kube.objects import Pod
from ..scheduler.builder import NodePoolsNotFoundError, build_scheduler
from ..scheduler.scheduler import Results, SchedulerOptions
from ..utils import pod as podutils
from .types import Candidate, CandidateError, new_candidate


class CandidateDeletingError(Exception):
    pass


class PDBLimits:
    """pdblimits.go:36: can the pods be evicted without violating a PDB?"""

    def __init__(self, kube_client):
        self.kube_client = kube_client
        self.pdbs = kube_client.list("PodDisruptionBudget")
        # a PDBLimits instance is a point-in-time snapshot (one per
        # filter/consistency pass), so each PDB's dynamic budget — a full
        # namespace Pod LIST to compute — is resolved at most once
        self._allowed: dict = {}

    def _disruptions_allowed(self, pdb) -> int:
        from ..lifecycle.node_termination import pdb_disruptions_allowed

        key = (pdb.namespace, pdb.name)
        allowed = self._allowed.get(key)
        if allowed is None:
            allowed = pdb_disruptions_allowed(self.kube_client, pdb)
            self._allowed[key] = allowed
        return allowed

    def can_evict_pods(self, pods: List[Pod]) -> Tuple[str, bool]:
        for pod in pods:
            for pdb in self.pdbs:
                if pdb.namespace == pod.namespace and pdb.selector.matches(pod.metadata.labels):
                    if self._disruptions_allowed(pdb) < 1:
                        return f"{pdb.namespace}/{pdb.name}", False
        return "", True


def has_do_not_disrupt_pod(candidate: Candidate) -> Optional[Pod]:
    for p in candidate.pods:
        # rv-memoized (active ∧ do-not-disrupt) — see disruption_screen_flags
        if podutils.disruption_screen_flags(p)[1]:
            return p
    return None


def filter_candidates(kube_client, recorder, candidates: List[Candidate]) -> List[Candidate]:
    """helpers.go:47 filterCandidates: deleting nodes, PDB-blocked nodes and
    do-not-disrupt pods all block voluntary disruption."""
    pdbs = PDBLimits(kube_client)
    out = []
    for cn in candidates:
        if cn.state_node.node is not None and cn.state_node.node.metadata.deletion_timestamp is not None:
            continue
        pdb_name, ok = pdbs.can_evict_pods(cn.pods)
        if not ok:
            _blocked(recorder, cn, f'PDB "{pdb_name}" prevents pod evictions')
            continue
        blocked_pod = has_do_not_disrupt_pod(cn)
        if blocked_pod is not None:
            _blocked(recorder, cn, f'Pod "{blocked_pod.namespace}/{blocked_pod.name}" has do not evict annotation')
            continue
        out.append(cn)
    return out


def cap_by_budgets(
    candidates: List[Candidate], budgets, recorder=None
) -> List[Candidate]:
    """Enforce per-NodePool disruption budgets on an ordered candidate
    list: keep candidates (highest priority first) while their pool has
    remaining budget. ``budgets`` is the pass's remaining-allowance map
    (budgets.build_disruption_budgets); None disables capping. Dropped
    candidates get a Blocked event naming the budget."""
    if budgets is None:
        return candidates
    remaining = dict(budgets)  # local: only the executed command consumes
    kept: List[Candidate] = []
    for cn in candidates:
        pool = cn.nodepool.name
        left = remaining.get(pool)
        if left is None:  # pool unknown to the pass snapshot: no cap
            kept.append(cn)
            continue
        if left > 0:
            remaining[pool] = left - 1
            kept.append(cn)
        else:
            _blocked(
                recorder, cn, f'Disruption budget for nodepool "{pool}" is exhausted'
            )
    return kept


def _blocked(recorder, candidate: Candidate, message: str) -> None:
    if recorder is not None:
        from ..events import events as ev

        recorder.publish(ev.blocked(candidate.state_node.node, message, message))


def get_candidates(
    cluster,
    kube_client,
    recorder,
    clock: Callable[[], float],
    cloud_provider,
    should_disrupt: Callable[[Candidate], bool],
    queue=None,
) -> List[Candidate]:
    """helpers.go GetCandidates: scan cluster state for disruptable nodes."""
    nodepool_map = {np.name: np for np in kube_client.list("NodePool")}
    instance_type_map: Dict[str, Dict[str, InstanceType]] = {}
    for name, np_ in nodepool_map.items():
        try:
            instance_type_map[name] = {it.name: it for it in cloud_provider.get_instance_types(np_)}
        except Exception as e:  # noqa: BLE001 — one bad pool must not stop disruption
            logging.getLogger("karpenter.disruption").debug(
                "skipping nodepool %s: instance-type fetch failed: %s", name, e
            )
            continue
    pods_by_node: Dict[str, list] = {}
    for p in kube_client.list("Pod"):
        if p.spec.node_name and podutils.disruption_screen_flags(p)[0]:
            pods_by_node.setdefault(p.spec.node_name, []).append(p)
    candidates = []
    for node in cluster.deep_copy_nodes():
        try:
            cn = new_candidate(
                kube_client,
                recorder,
                clock,
                node,
                nodepool_map,
                instance_type_map,
                queue,
                pods_by_node=pods_by_node,
                node_owned=True,  # deep_copy_nodes returned fresh copies
            )
        except CandidateError:
            continue
        if should_disrupt(cn):
            candidates.append(cn)
    return candidates


def simulate_scheduling(
    kube_client, cluster, provisioner, candidates: List[Candidate], trace_ctx=None
) -> Results:
    """helpers.go:73 simulateScheduling: run the scheduler in simulation
    mode over pending + candidate + deleting-node pods minus the candidate
    nodes, rejecting placements on uninitialized nodes.

    When the provisioner runs the batched solver, the simulation does
    too: the displaced pods pack onto the surviving fleet via the tensor
    existing-capacity path (the C++ or the card's first-fit) instead of
    the greedy O(P·M) per-pod loop — the same engine the provisioning
    path uses, so decisions agree by construction.

    ``trace_ctx``: the originating decision's TraceContext
    when the probe runs on a thread other than the one that opened the
    disruption pass's root — the probe's spans adopt it so they land
    under the decision instead of orphaning. On the same thread the
    ``trace_root`` below already joins the active trace and ``adopt``
    degrades to a plain span."""
    from ..tracing import tracer

    with tracer.adopt(trace_ctx, "disrupt.simulate.adopt", candidates=len(candidates)):
        with tracer.trace_root(
            "disrupt.simulate", is_solve=True, candidates=len(candidates)
        ):
            return _simulate(kube_client, cluster, provisioner, candidates)


def _simulate(kube_client, cluster, provisioner, candidates: List[Candidate]) -> Results:
    candidate_names = {c.name() for c in candidates}
    nodes = cluster.deep_copy_nodes()
    deleting = [n for n in nodes if n.marked_for_deletion]
    state_nodes = [
        n for n in nodes if not n.marked_for_deletion and n.name() not in candidate_names
    ]
    if any(n.name() in candidate_names for n in deleting):
        raise CandidateDeletingError()

    pods: List[Pod] = provisioner.get_pending_pods()
    for c in candidates:
        pods.extend(p for p in c.pods if podutils.is_reschedulable(p))
    for n in deleting:
        for ns, name in n.pod_requests:
            p = kube_client.get("Pod", name, namespace=ns)
            if p is not None and podutils.is_reschedulable(p):
                pods.append(p)

    nodepools = [
        np_ for np_ in kube_client.list("NodePool") if np_.metadata.deletion_timestamp is None
    ]
    if not nodepools:
        raise NodePoolsNotFoundError("no nodepools found")
    if getattr(provisioner, "use_tpu_solver", False):
        return _simulate_tpu(
            kube_client, cluster, provisioner, pods, state_nodes, nodepools,
            sim_drained=tuple(sorted(c.provider_id() for c in candidates)),
        )
    scheduler = build_scheduler(
        kube_client,
        cluster,
        nodepools,
        provisioner.cloud_provider,
        pods,
        state_nodes=state_nodes,
        daemonset_pods=cluster.get_daemonset_pods(),
        recorder=None,
        opts=SchedulerOptions(simulation_mode=True),
    )
    results = scheduler.solve(pods)
    # placements that depend on uninitialized nodes don't count
    # (helpers.go:108-115)
    for existing in results.existing_nodes:
        if not existing.initialized():
            for p in existing.pods:
                results.pod_errors[p.uid] = (
                    f"would schedule against a non-initialized node {existing.name()}"
                )
                results._pods_by_uid[p.uid] = p
    return results


class PlanReplacementClaim:
    """Adapts a batched-solver NodePlan to the SchedulingNodeClaim surface the
    disruption decision core and provisioner.create consume: the plan
    pins one instance type (what would actually launch), so price
    filtering and the spot/OD guards operate on that type."""

    def __init__(self, plan, nodepool, pods: List[Pod]):
        from ..scheduler.nodeclaim import NodeClaimTemplate
        from ..scheduling import Requirements

        self.template = NodeClaimTemplate(nodepool)
        self.nodepool_name = plan.nodepool_name
        self.pods = pods
        self.requirements = Requirements(
            *(plan.requirements.values_list() if plan.requirements else ())
        )
        self.instance_type_options = [plan.instance_type]
        self.requests = dict(plan.requests or {})

    def to_node_claim(self, nodepool):
        return self.template.to_node_claim(
            nodepool, self.requirements, self.instance_type_options, self.requests
        )


def _sim_scheduler(kube_client, cluster, provisioner, nodepools):
    """The long-lived simulation TorchScheduler, cached on the
    provisioner while the nodepool set and the device are unchanged (the
    reuse pattern of Provisioner._schedule_tpu, on a separate instance
    so a probe never races the live solve's per-solve state). Reuse is
    what makes probes warm: the scheduler's provider-keyed caches
    (route, compat rows, job, merge, seeds) persist across simulations
    AND are shared with the live path — content-addressed, so sharing
    is free. The device is part of the key: a CPU simulation never
    shares a scheduler with a card one."""
    from ..solver import TorchScheduler

    device = getattr(provisioner, "device", None)
    key = (id(kube_client), id(cluster), str(device)) + tuple(
        (id(np_), np_.metadata.resource_version) for np_ in nodepools
    )
    cached = getattr(provisioner, "_sim_tpu_solver", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    solver = TorchScheduler(
        nodepools, provisioner.cloud_provider, kube_client=kube_client, cluster=cluster,
        device=device,
    )
    try:
        # the held nodepool list keeps the key's id()s stable
        provisioner._sim_tpu_solver = (key, solver, list(nodepools))
    except Exception:  # noqa: BLE001 — slotted/fake provisioner: fresh per probe
        pass
    return solver


def _simulate_tpu(
    kube_client, cluster, provisioner, pods: List[Pod], state_nodes, nodepools,
    sim_drained: tuple = (),
) -> Results:
    """Batched-solver simulation: one tensor solve over displaced pods +
    surviving fleet; NodePlans adapt to replacement claims.
    ``sim_drained`` (sorted drained provider ids) keys the solve's
    delta-sensitive memos — see TorchScheduler.solve."""
    solver = _sim_scheduler(kube_client, cluster, provisioner, nodepools)
    sr = solver.solve(
        pods,
        state_nodes=state_nodes,
        daemonset_pods=cluster.get_daemonset_pods(),
        sim_drained=sim_drained,
    )
    results = sr.oracle_results or Results()
    results.pod_errors.update(sr.pod_errors)
    results._pods_by_uid.update({p.uid: p for p in pods})
    nodepool_by_name = {np_.name: np_ for np_ in nodepools}
    for plan in sr.node_plans:
        plan_pods = [pods[i] for i in plan.pod_indices]
        results.new_node_claims.append(
            PlanReplacementClaim(plan, nodepool_by_name[plan.nodepool_name], plan_pods)
        )
    # placements that depend on uninitialized nodes don't count
    # (helpers.go:108-115) — tensor placements and oracle ones alike
    for plan in sr.existing_plans:
        if not plan.state_node.initialized():
            for i in plan.pod_indices:
                p = pods[i]
                results.pod_errors[p.uid] = (
                    f"would schedule against a non-initialized node {plan.state_node.name()}"
                )
                results._pods_by_uid[p.uid] = p
    for existing in results.existing_nodes:
        if not existing.initialized():
            for p in existing.pods:
                results.pod_errors[p.uid] = (
                    f"would schedule against a non-initialized node {existing.name()}"
                )
                results._pods_by_uid[p.uid] = p
    return results


def filter_by_price(
    instance_types: List[InstanceType], requirements, max_price: float
) -> List[InstanceType]:
    """Keep instance types with an allowed offering cheaper than max_price
    (consolidation.go filterByPrice)."""
    out = []
    for it in instance_types:
        offerings = it.offerings.available().requirements(requirements)
        cheapest = offerings.cheapest()
        if cheapest is not None and cheapest.price < max_price:
            out.append(it)
    return out


def get_candidate_prices(candidates: List[Candidate]) -> float:
    """Sum of candidate offering prices (consolidation.go
    getCandidatePrices)."""
    total = 0.0
    for c in candidates:
        price = c.price()
        if price is None:
            raise ValueError(
                f"unable to determine offering for {c.instance_type.name}/{c.capacity_type}/{c.zone}"
            )
        total += price
    return total


def instance_types_are_subset(lhs: List[InstanceType], rhs: List[InstanceType]) -> bool:
    rhs_names = {it.name for it in rhs}
    return all(it.name in rhs_names for it in lhs)


def map_candidates(proposed: List[Candidate], current: List[Candidate]) -> List[Candidate]:
    """Intersect proposed command candidates with fresh state (validation.go
    mapCandidates)."""
    current_by_id = {c.provider_id(): c for c in current}
    return [current_by_id[c.provider_id()] for c in proposed if c.provider_id() in current_by_id]
