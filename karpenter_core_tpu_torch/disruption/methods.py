"""Disruption methods, run in priority order by the controller.

Counterpart of ``karpenter_core_tpu/disruption/methods.py`` (ref
pkg/controllers/disruption/{expiration,drift,emptiness,
emptynodeconsolidation,multinodeconsolidation,
singlenodeconsolidation,validation}.go)."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..apis import labels as wk
from ..apis.nodeclaim import COND_DRIFTED, COND_EMPTY, COND_EXPIRED
from ..apis.nodepool import CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
from ..scheduling import Requirement
from ..kube.objects import OP_IN
from .helpers import (
    CandidateDeletingError,
    _blocked,
    cap_by_budgets,
    filter_by_price,
    filter_candidates,
    get_candidate_prices,
    instance_types_are_subset,
    map_candidates,
    simulate_scheduling,
)
from .types import ACTION_DELETE, ACTION_NOOP, ACTION_REPLACE, Candidate, Command

CONSOLIDATION_TTL = 15.0  # consolidation.go:25
MULTI_NODE_CONSOLIDATION_TIMEOUT = 60.0  # multinodeconsolidation.go:34
SINGLE_NODE_CONSOLIDATION_TIMEOUT = 180.0  # singlenodeconsolidation.go:29
MAX_PARALLEL = 100  # multinodeconsolidation.go:58
# with the prefix screen, the O(log N) per-probe simulations that
# forced the reference's 100-candidate cap become one kernel launch;
# the cap rises to bound only the post-screen oracle verification
MAX_PARALLEL_TPU_SCREEN = 1000
# the candidate caps (the JAX package's KARPENTER_TPU_DISRUPT_MAX_CANDIDATES
# and _MAX_CANDIDATES_TPU defaults); tests monkeypatch them
MAX_CANDIDATES = MAX_PARALLEL
MAX_CANDIDATES_TPU = MAX_PARALLEL_TPU_SCREEN


def max_parallel() -> int:
    """Candidate cap for simulation-per-probe paths (the binary-search
    fallback and the non-screen engine), the reference's bound by
    default. Every path that pays a full scheduling simulation per probe
    consults THIS cap, including the fallback below a failed screen (the
    screen cap must not leak into probe sizing)."""
    return max(2, int(MAX_CANDIDATES))


def max_parallel_tpu_screen() -> int:
    """Candidate cap for the one-launch screen paths."""
    return max(2, int(MAX_CANDIDATES_TPU))


class Method:
    """types.go:38 Method interface."""

    type_name = ""
    consolidation_type = ""

    def should_disrupt(self, candidate: Candidate) -> bool:
        raise NotImplementedError

    def compute_command(self, candidates: List[Candidate]) -> Command:
        raise NotImplementedError

    def _engine(self):
        """The controller-shared batched engine (disruption/engine.py),
        constructed lazily for tests that build methods from a bare
        ctx. Shared by the consolidation family and the
        condition cohorts, so the whole ordered chain rides one memo
        plane."""
        eng = getattr(self.ctx, "engine", None)
        if eng is None:
            from .engine import BatchedDisruptionEngine

            eng = BatchedDisruptionEngine(self.ctx)
            try:
                self.ctx.engine = eng
            except Exception:  # noqa: BLE001 — frozen/legacy ctx: engine stays local
                pass
        return eng


class ConditionMethod(Method):
    """Expiration / Drift / Emptiness: act on status conditions set by the
    marker controller; replacements are counted by simulation. The
    simulate loop dispatches through the batched engine —
    ``engine.condition_command`` is probe-for-probe the sequential loop
    (``_simulate_in_order``, retained as the plan-identity oracle under
    ``KARPENTER_TORCH_DISRUPT_ENGINE=sequential``) with the cohort
    screened in one launch and known-blocked drains memoized."""

    condition = ""
    needs_replacement = True

    def __init__(self, ctx):
        self.ctx = ctx
        # per-decision observability (mirrors ConsolidationBase): the
        # batched cohort pass's screen/memo stats, read by the
        # controller's _observe_decision and /debug/traces root args
        self.last_decision_stats: Optional[dict] = None

    def should_disrupt(self, candidate: Candidate) -> bool:
        nc = candidate.state_node.node_claim
        return nc is not None and nc.status_condition_is_true(self.condition)

    def _condition_time(self, candidate: Candidate) -> float:
        nc = candidate.state_node.node_claim
        cond = nc.get_condition(self.condition) if nc is not None else None
        # should_disrupt guarantees the condition exists; if filtering ever
        # changes, sort condition-less candidates last, not first
        return cond.last_transition_time if cond is not None else float("inf")

    def compute_command(self, candidates: List[Candidate]) -> Command:
        candidates = filter_candidates(self.ctx.kube_client, self.ctx.recorder, candidates)
        if not candidates:
            return Command()
        # earliest condition transition disrupts first — "most expired" /
        # "earliest drifted" (drift.go:62-71, expiration.go:66-75)
        candidates.sort(key=self._condition_time)
        candidates = cap_by_budgets(candidates, self.ctx.budgets, self.ctx.recorder)
        if not candidates:
            return Command()
        if not self.needs_replacement:
            return Command(candidates=candidates)
        # all EMPTY candidates disrupt in one command — they need no
        # scheduling simulation (drift.go:86-93, expiration.go:90-97;
        # the reference's candidate pods pre-exclude daemonset/node-owned
        # pods, node.go:40-46 — ours hold all active pods, so filter here)
        from ..utils import pod as podutils

        empty = [
            c
            for c in candidates
            if not any(podutils.is_reschedulable(p) for p in c.pods)
        ]
        if empty:
            return Command(candidates=empty)
        from .engine import engine_mode

        if engine_mode() == "batched":
            engine = self._engine()
            cmd = engine.condition_command(self, candidates)
            self.last_decision_stats = engine.last_engine_stats
            return cmd
        return self._simulate_in_order(candidates)

    def _simulate_in_order(self, candidates: List[Candidate]) -> Command:
        # non-empty: one at a time, launching replacement capacity for
        # displaced pods (expiration.go:80-123, drift.go:75-121)
        for candidate in candidates:
            try:
                results = simulate_scheduling(
                    self.ctx.kube_client, self.ctx.cluster, self.ctx.provisioner, [candidate]
                )
            except CandidateDeletingError:
                continue
            if not results.all_non_pending_pods_scheduled():
                _blocked(
                    self.ctx.recorder,
                    candidate,
                    "Scheduling simulation failed to schedule all pods",
                )
                continue
            return Command(candidates=[candidate], replacements=results.new_node_claims)
        return Command()


class Expiration(ConditionMethod):
    condition = COND_EXPIRED
    type_name = "expiration"


class Drift(ConditionMethod):
    condition = COND_DRIFTED
    type_name = "drift"


class Emptiness(ConditionMethod):
    """Fast path: Empty-condition nodes delete without simulation
    (emptiness.go:42-65)."""

    condition = COND_EMPTY
    needs_replacement = False
    type_name = "emptiness"

    def should_disrupt(self, candidate: Candidate) -> bool:
        if not super().should_disrupt(candidate):
            return False
        d = candidate.nodepool.spec.disruption
        if d.consolidate_after is None:
            return False
        nc = candidate.state_node.node_claim
        cond = nc.get_condition(COND_EMPTY)
        return self.ctx.clock() - cond.last_transition_time >= d.consolidate_after


class ConsolidationBase(Method):
    """consolidation.go:27 shared base."""

    type_name = "consolidation"

    def __init__(self, ctx):
        self.ctx = ctx
        self.last_consolidation_state = -1.0
        self._budget_dropped = 0
        # per-decision observability: the screen/repack bounds sandwich
        # (and, on the batched engine, the whole family's stats) — read
        # by the controller, bench config 9, and /debug/traces root args
        self.last_decision_stats: Optional[dict] = None

    def is_consolidated(self) -> bool:
        return self.last_consolidation_state == self.ctx.cluster.consolidation_state()

    def mark_consolidated(self) -> None:
        # budgets are time-varying: candidates dropped by an exhausted
        # budget are pending work the cluster state won't re-signal, so
        # the nothing-to-do dedup must not latch while any were dropped
        if self._budget_dropped:
            return
        self.last_consolidation_state = self.ctx.cluster.consolidation_state()

    def should_disrupt(self, candidate: Candidate) -> bool:
        """consolidation.go:73 ShouldDisrupt."""
        if candidate.annotations().get(wk.DO_NOT_CONSOLIDATE_ANNOTATION_KEY) == "true":
            return False
        d = candidate.nodepool.spec.disruption
        return d.consolidation_policy == CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED

    def sort_and_filter(self, candidates: List[Candidate]) -> List[Candidate]:
        candidates = filter_candidates(self.ctx.kube_client, self.ctx.recorder, candidates)
        candidates = sorted(candidates, key=lambda c: c.disruption_cost)
        # cheapest-to-disrupt keep their place under the per-pool budget cap
        capped = cap_by_budgets(candidates, self.ctx.budgets, self.ctx.recorder)
        self._budget_dropped = len(candidates) - len(capped)
        return capped

    # -- the decision core (consolidation.go:113 computeConsolidation) -----

    def compute_consolidation(self, candidates: List[Candidate]) -> Command:
        try:
            results = simulate_scheduling(
                self.ctx.kube_client, self.ctx.cluster, self.ctx.provisioner, candidates
            )
        except CandidateDeletingError:
            return Command()
        if not results.all_non_pending_pods_scheduled():
            return Command()
        if not results.new_node_claims:
            return Command(candidates=candidates)
        if len(results.new_node_claims) != 1:
            return Command()

        replacement = results.new_node_claims[0]
        candidate_price = get_candidate_prices(candidates)
        replacement.instance_type_options = filter_by_price(
            replacement.instance_type_options, replacement.requirements, candidate_price
        )
        if not replacement.instance_type_options:
            return Command()

        # spot→spot replacement is disallowed; force OD→spot when allowed
        # (consolidation.go:142-169)
        all_spot = all(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in candidates)
        ct_req = replacement.requirements.get_req(wk.CAPACITY_TYPE_LABEL_KEY)
        if all_spot and ct_req.has(wk.CAPACITY_TYPE_SPOT):
            return Command()
        if ct_req.has(wk.CAPACITY_TYPE_SPOT) and ct_req.has(wk.CAPACITY_TYPE_ON_DEMAND):
            replacement.requirements.add(
                Requirement(wk.CAPACITY_TYPE_LABEL_KEY, OP_IN, [wk.CAPACITY_TYPE_SPOT])
            )
        return Command(candidates=candidates, replacements=[replacement])

    def validate(self, cmd: Command) -> bool:
        v = Validation(self.ctx, self.should_disrupt)
        return v.is_valid(cmd)


class EmptyNodeConsolidation(ConsolidationBase):
    """emptynodeconsolidation.go: delete all empty candidates at once."""

    consolidation_type = "empty"

    def compute_command(self, candidates: List[Candidate]) -> Command:
        if self.is_consolidated():
            return Command()
        candidates = self.sort_and_filter(candidates)
        empty = [c for c in candidates if not c.pods or all(_ignorable(p) for p in c.pods)]
        if not empty:
            self.mark_consolidated()
            return Command()
        # re-check after the TTL that the nodes are still empty
        # (emptynodeconsolidation.go validation loop)
        if self.ctx.validation_sleep is not None:
            self.ctx.validation_sleep(CONSOLIDATION_TTL)
        still_empty = []
        for c in empty:
            pods = [
                p
                for p in self.ctx.kube_client.list("Pod")
                if p.spec.node_name == c.state_node.name() and not _ignorable(p)
            ]
            if not pods and not self.ctx.cluster.is_node_nominated(c.provider_id()):
                still_empty.append(c)
        return Command(candidates=still_empty)


class MultiNodeConsolidation(ConsolidationBase):
    """multinodeconsolidation.go — with the prefix screen replacing the
    log(N)-simulations binary search when available."""

    consolidation_type = "multi"

    def __init__(self, ctx, use_tpu_screen: bool = True):
        super().__init__(ctx)
        self.use_tpu_screen = use_tpu_screen

    def compute_command(self, candidates: List[Candidate]) -> Command:
        from .engine import engine_mode

        if self.is_consolidated():
            return Command()
        candidates = self.sort_and_filter(candidates)
        cap = max_parallel_tpu_screen() if self.use_tpu_screen else max_parallel()
        max_n = min(len(candidates), cap)
        if self.use_tpu_screen and engine_mode() == "batched":
            engine = self._engine()
            cmd = engine.multi_command(self, candidates, max_n)
            self.last_decision_stats = engine.last_engine_stats
        else:
            cmd = self.first_n_consolidation(candidates, max_n)
        if cmd.action() == ACTION_NOOP:
            self.mark_consolidated()
            return cmd
        if not self.validate(cmd):
            return Command()
        return cmd

    def first_n_consolidation(self, candidates: List[Candidate], max_n: int) -> Command:
        """multinodeconsolidation.go:66 firstNConsolidationOption. With the
        screen we jump straight to the largest capacity-feasible prefix
        and walk down on simulation failure; without it, binary search."""
        if len(candidates) < 2:
            return Command()
        max_n = min(max_n, len(candidates))
        deadline = self.ctx.clock() + MULTI_NODE_CONSOLIDATION_TIMEOUT

        order = None
        if self.use_tpu_screen:
            from ..tracing import tracer
            from . import tpu_repack

            # two one-launch bounds bracket the answer: the capacity
            # screen is optimistic (upper), the true batched repack is
            # conservative (lower) — together they replace the
            # reference's O(log N) simulation probes with usually ≤3
            # verification solves
            with tracer.span("disrupt.screen", candidates=max_n):
                k_hi = tpu_repack.screen_prefixes(self.ctx, candidates[:max_n])
            with tracer.span("disrupt.repack", candidates=max_n):
                k_lo = tpu_repack.repack_prefixes(self.ctx, candidates[:max_n])
            self.last_decision_stats = {
                "engine": "sequential",
                "candidates": max_n,
                "screen_upper_k": k_hi,
                "repack_lower_k": k_lo,
            }
            # the screen is a sound necessary condition (capacity; same
            # argument the single-node scan uses to prune), and screen
            # infeasibility is upward-closed — a bigger prefix only adds
            # load and removes surviving free space. k_hi == 0 therefore
            # PROVES no multi-node prefix can consolidate: no-op without
            # a single simulation (unless the differently-quantized
            # repack bound disagrees — then its prefix is still tried)
            if k_hi == 0 and k_lo < 2:
                return Command()
            # descending: the two bounds use different capacity sets, so
            # k_lo can exceed the screen's k_hi — unsorted tries would
            # attempt (and return) a smaller prefix before the largest
            # feasible one
            tries = sorted(
                {k for k in (k_hi, k_hi - 1, k_hi - 2, k_lo) if k >= 2}, reverse=True
            )
            if tries:
                order = tries
        if order is None:
            # no usable screen result: the raised screen cap would make each
            # binary-search probe a near-1000-candidate simulation — fall
            # back to the simulation-sized cap (MAX_CANDIDATES; the
            # reference's bound, multinodeconsolidation.go:58)
            return self._binary_search(candidates, min(max_n, max_parallel()), deadline)

        attempted_min = order[0]
        for k in order[:4]:  # bounded verification attempts
            if self.ctx.clock() > deadline:
                break
            cmd = self._attempt(candidates[:k])
            if cmd is not None:
                return cmd
            attempted_min = min(attempted_min, k)
        # both bounds over-estimated; binary search the untried sizes
        # below the smallest prefix we actually attempted, capped so each
        # probe's simulation stays reference-sized (raising
        # MAX_CANDIDATES raises probe sizing too)
        return self._binary_search(
            candidates, min(max_n, attempted_min - 1, max_parallel()), deadline
        )

    def _attempt(self, prefix: List[Candidate]) -> Optional[Command]:
        cmd = self.compute_consolidation(prefix)
        if cmd.action() == ACTION_REPLACE:
            cmd.replacements[0].instance_type_options = filter_out_same_type(
                cmd.replacements[0], prefix
            )
            if not cmd.replacements[0].instance_type_options:
                return None
            return cmd
        if cmd.action() == ACTION_DELETE:
            return cmd
        return None

    def _binary_search(self, candidates: List[Candidate], max_n: int, deadline: float) -> Command:
        lo_, hi = 1, max_n - 1
        last = Command()
        while lo_ <= hi:
            if self.ctx.clock() > deadline:
                return last
            mid = (lo_ + hi) // 2
            cmd = self._attempt(candidates[: mid + 1])
            if cmd is not None:
                last = cmd
                lo_ = mid + 1
            else:
                hi = mid - 1
        return last


class SingleNodeConsolidation(ConsolidationBase):
    """singlenodeconsolidation.go: linear scan, first success wins — with
    a one-launch feasibility screen pruning the scan."""

    consolidation_type = "single"

    def __init__(self, ctx, use_tpu_screen: bool = True):
        super().__init__(ctx)
        self.use_tpu_screen = use_tpu_screen

    def compute_command(self, candidates: List[Candidate]) -> Command:
        from .engine import engine_mode

        if self.is_consolidated():
            return Command()
        candidates = self.sort_and_filter(candidates)
        if self.use_tpu_screen and engine_mode() == "batched":
            engine = self._engine()
            cmd = engine.single_command(self, candidates)
            self.last_decision_stats = engine.last_engine_stats
            return cmd
        if self.use_tpu_screen and len(candidates) > 1:
            # capacity screen for ALL candidates in one kernel launch;
            # screen-infeasible ones cannot consolidate, so the linear
            # simulation scan (the 3-minute budget) skips them entirely
            from .tpu_repack import screen_singles

            feasible = screen_singles(self.ctx, candidates)
            candidates = [c for c, ok in zip(candidates, feasible) if ok]
        deadline = self.ctx.clock() + SINGLE_NODE_CONSOLIDATION_TIMEOUT
        for candidate in candidates:
            if self.ctx.clock() > deadline:
                return Command()
            cmd = self.compute_consolidation([candidate])
            if cmd.action() == ACTION_NOOP:
                continue
            if not self.validate(cmd):
                return Command()
            return cmd
        self.mark_consolidated()
        return Command()


class Validation:
    """validation.go: wait out the TTL, rebuild candidates, re-simulate."""

    def __init__(self, ctx, should_disrupt: Callable[[Candidate], bool]):
        self.ctx = ctx
        self.should_disrupt = should_disrupt

    def is_valid(self, cmd: Command) -> bool:
        if self.ctx.validation_sleep is not None:
            self.ctx.validation_sleep(CONSOLIDATION_TTL)
        from .helpers import get_candidates

        fresh = get_candidates(
            self.ctx.cluster,
            self.ctx.kube_client,
            self.ctx.recorder,
            self.ctx.clock,
            self.ctx.cloud_provider,
            self.should_disrupt,
            self.ctx.queue,
        )
        mapped = filter_candidates(
            self.ctx.kube_client, self.ctx.recorder, map_candidates(cmd.candidates, fresh)
        )
        if len(mapped) != len(cmd.candidates):
            return False
        for c in mapped:
            if self.ctx.cluster.is_node_nominated(c.provider_id()):
                return False
        return self._validate_command(cmd, mapped)

    def _validate_command(self, cmd: Command, candidates: List[Candidate]) -> bool:
        """validation.go:110 ValidateCommand."""
        if not candidates:
            return False
        try:
            results = simulate_scheduling(
                self.ctx.kube_client, self.ctx.cluster, self.ctx.provisioner, candidates
            )
        except CandidateDeletingError:
            return False
        if not results.all_non_pending_pods_scheduled():
            return False
        if not results.new_node_claims:
            return not cmd.replacements
        if len(results.new_node_claims) > 1:
            return False
        if not cmd.replacements:
            return False
        # the original replacement's instance types must cover the new
        # simulation's needs (validation.go tail: subset + price re-check)
        return instance_types_are_subset(
            results.new_node_claims[0].instance_type_options,
            cmd.replacements[0].instance_type_options,
        ) or instance_types_are_subset(
            cmd.replacements[0].instance_type_options,
            results.new_node_claims[0].instance_type_options,
        )


def filter_out_same_type(replacement, consolidated: List[Candidate]):
    """multinodeconsolidation.go:142 filterOutSameType: price-sanity — the
    replacement must be cheaper than the cheapest existing instance of any
    type it shares with the candidates."""
    import math

    existing_types = set()
    prices_by_type = {}
    for c in consolidated:
        existing_types.add(c.instance_type.name)
        offering = c.instance_type.offerings.get(c.capacity_type, c.zone)
        if offering is None:
            continue
        prices_by_type[c.instance_type.name] = min(
            prices_by_type.get(c.instance_type.name, math.inf), offering.price
        )
    max_price = math.inf
    for it in replacement.instance_type_options:
        if it.name in existing_types:
            max_price = min(max_price, prices_by_type.get(it.name, math.inf))
    return filter_by_price(replacement.instance_type_options, replacement.requirements, max_price)


def _ignorable(pod) -> bool:
    from ..utils import pod as podutils

    return (
        podutils.is_owned_by_daemonset(pod)
        or podutils.is_terminal(pod)
        or podutils.is_terminating(pod)
    )
