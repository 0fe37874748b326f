"""Disruption controller: the 10 s singleton loop running Methods in
order.

Counterpart of ``karpenter_core_tpu/disruption/controller.py`` (ref
pkg/controllers/disruption/controller.go). The screens, the repack bound
and the simulations run on the provisioner's device."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..apis import labels as wk
from ..kube.objects import EFFECT_NO_SCHEDULE, Taint
from ..provisioning.provisioner import LaunchOptions
from ..tracing import tracer
from ..utils import pod as podutils
from .budgets import build_disruption_budgets
from .engine import BatchedDisruptionEngine
from .helpers import get_candidates
from .methods import (
    Drift,
    Emptiness,
    EmptyNodeConsolidation,
    Expiration,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from .orchestration import OrchestrationQueue
from .types import ACTION_NOOP, Command


@dataclass
class DisruptionContext:
    """Shared dependencies for methods (the `consolidation` struct,
    consolidation.go:28)."""

    kube_client: object
    cluster: object
    provisioner: object
    cloud_provider: object
    recorder: object
    queue: OrchestrationQueue
    # analysis: allow-clock(condition-stamps — compared against persisted last_transition_time wall-clock stamps)
    clock: Callable[[], float] = time.time
    # test hook: replaces the 15 s validation wait (consolidation.go:42);
    # None skips waiting entirely
    validation_sleep: Optional[Callable[[float], None]] = None
    # remaining voluntary disruptions per nodepool, rebuilt each pass
    # (disruption-controls.md); None = budgets not enforced (legacy tests)
    budgets: Optional[dict] = None
    # the controller-shared batched disruption engine (engine.py);
    # methods construct one lazily when absent (bare-ctx tests)
    engine: Optional[object] = None


class DisruptionController:
    """controller.go:72-136."""

    def __init__(
        self,
        kube_client,
        cluster,
        provisioner,
        cloud_provider,
        recorder=None,
        # analysis: allow-clock(condition-stamps — fans to DisruptionContext, compared against persisted wall-clock stamps)
        clock: Callable[[], float] = time.time,
        queue: Optional[OrchestrationQueue] = None,
        validation_sleep: Optional[Callable[[float], None]] = None,
        use_tpu_screen: bool = True,
        metrics=None,
    ):
        self.kube_client = kube_client
        self.cluster = cluster
        self.clock = clock
        self.metrics = metrics
        self.queue = queue or OrchestrationQueue(kube_client, cluster, recorder, clock, metrics)
        self.ctx = DisruptionContext(
            kube_client=kube_client,
            cluster=cluster,
            provisioner=provisioner,
            cloud_provider=cloud_provider,
            recorder=recorder,
            queue=self.queue,
            clock=clock,
            validation_sleep=validation_sleep,
        )
        # the controller-shared batched engine (engine.py): one instance
        # so its delta-keyed bounds/verdict memos persist across passes
        if use_tpu_screen:
            self.ctx.engine = BatchedDisruptionEngine(self.ctx)
        # method order is the disruption priority (controller.go:72-85)
        self.methods = [
            Expiration(self.ctx),
            Drift(self.ctx),
            Emptiness(self.ctx),
            EmptyNodeConsolidation(self.ctx),
            MultiNodeConsolidation(self.ctx, use_tpu_screen=use_tpu_screen),
            SingleNodeConsolidation(self.ctx, use_tpu_screen=use_tpu_screen),
        ]
        # per-decision bounds/engine stats of the last pass that computed
        # any (bench config 9 and /debug/traces read this)
        self.last_decision_stats: Optional[dict] = None
        # the last pass's trace (the serving pipeline's disruption stage
        # flight-records it per pass)
        self.last_trace = None

    def reconcile(self) -> Optional[str]:
        """One pass; returns the executed method name or None. The pass
        is span-traced (disrupt.{collect,screen,repack,verify,execute})
        into the same solver_phase_duration bridge the solve path feeds;
        passes that ran a simulation land in /debug/traces with the
        engine's subset/bounds stats as root args."""
        if not self.cluster.synced():
            return None
        sink = self.metrics.solver_phase_duration if self.metrics is not None else None
        with tracer.trace_root("disrupt", metrics_sink=sink, buffer_if="solve") as tr:
            self.last_trace = tr
            return self._reconcile(tr)

    def _reconcile(self, tr) -> Optional[str]:
        self._cleanup_stale_taints()
        # per-pass remaining disruption allowance per nodepool; methods
        # cap candidate selection against a snapshot of this map
        self.ctx.budgets = build_disruption_budgets(
            self.cluster, self.kube_client, self.clock, self.queue
        )
        for method in self.methods:
            with tracer.span("disrupt.collect", method=method.type_name):
                candidates = get_candidates(
                    self.cluster,
                    self.kube_client,
                    self.ctx.recorder,
                    self.clock,
                    self.ctx.cloud_provider,
                    method.should_disrupt,
                    self.queue,
                )
            if self.metrics is not None:
                self.metrics.eligible_nodes.set(
                    len(candidates), method=method.type_name
                )
            if not candidates:
                continue
            t0 = time.perf_counter()
            method.last_decision_stats = None
            cmd = method.compute_command(candidates)
            self._observe_decision(method, time.perf_counter() - t0, tr)
            if cmd.action() == ACTION_NOOP:
                continue
            if tr is not None:
                tr.contains_solve = True  # executing passes always buffer
            with tracer.span("disrupt.execute", method=method.type_name):
                self._execute(cmd, method)
            return method.type_name
        return None

    def _observe_decision(self, method, elapsed: float, tr) -> None:
        """Surface one decision's screen-bounds sandwich + subset
        counters (metrics, /debug/traces root args, last_decision_stats)."""
        if self.metrics is not None:
            self.metrics.disruption_evaluation_duration.observe(
                elapsed, method=method.type_name
            )
        stats = getattr(method, "last_decision_stats", None)
        if not stats:
            return
        self.last_decision_stats = stats
        if tr is not None:
            # a decision ran (screens dispatched, maybe zero sims): the
            # pass is buffer-worthy even when the screen proved the
            # no-op without a simulation
            tr.contains_solve = True
            tr.args.setdefault("disrupt", {})[
                getattr(method, "consolidation_type", "") or method.type_name
            ] = stats
        if self.metrics is not None:
            screened = stats.get("subsets_screened")
            if screened:
                self.metrics.disruption_subsets.inc(screened, stage="screened")
            verified = stats.get("subsets_verified")
            if verified:
                self.metrics.disruption_subsets.inc(verified, stage="verified")

    # -- execute (controller.go:177-213) -----------------------------------

    def _execute(self, cmd: Command, method) -> None:
        # 1. cordon candidates with the disruption taint
        for c in cmd.candidates:
            node = self.kube_client.get("Node", c.name())
            if node is not None:
                taint = podutils.DISRUPTION_NO_SCHEDULE_TAINT
                if not any(taint.match(t) for t in node.spec.taints):
                    node.spec.taints.append(
                        Taint(key=taint.key, value=taint.value, effect=taint.effect)
                    )
                self.kube_client.apply(node)
        # 2. launch replacements
        replacement_names: List[str] = []
        if cmd.replacements:
            replacement_names, errs = self.ctx.provisioner.create_node_claims(
                cmd.replacements, LaunchOptions(reason=method.type_name)
            )
            if errs:
                # roll back: un-cordon AND delete any partially created
                # replacements so an aborted command leaks no capacity
                # (controller.go:189-199)
                for name in replacement_names:
                    nc = self.kube_client.get("NodeClaim", name)
                    if nc is not None:
                        self.kube_client.delete(nc)
                for c in cmd.candidates:
                    node = self.kube_client.get("Node", c.name())
                    if node is not None:
                        node.spec.taints = [
                            t for t in node.spec.taints if t.key != wk.DISRUPTION_TAINT_KEY
                        ]
                        self.kube_client.apply(node)
                return
        # 3. mark for deletion + hand to orchestration
        self.cluster.mark_for_deletion(*[c.provider_id() for c in cmd.candidates])
        self.queue.add(cmd, replacement_names, method.type_name, getattr(method, "consolidation_type", ""))
        if self.ctx.recorder is not None:
            from ..events import events as ev

            for c in cmd.candidates:
                self.ctx.recorder.publish(
                    ev.disrupt_node(c.state_node.node, method.type_name)
                )
        if self.metrics is not None:
            self.metrics.disruption_actions.inc(
                method=method.type_name, action=cmd.action()
            )

    def _cleanup_stale_taints(self) -> None:
        """Remove disruption taints from nodes no orchestration command owns
        — crash-safe restart behavior (controller.go:111-118)."""
        for node in self.kube_client.list("Node"):
            if any(t.key == wk.DISRUPTION_TAINT_KEY for t in node.spec.taints):
                pid = node.spec.provider_id
                if not self.queue.has_any(pid) and not self._marked(pid):
                    node.spec.taints = [
                        t for t in node.spec.taints if t.key != wk.DISRUPTION_TAINT_KEY
                    ]
                    self.kube_client.apply(node)

    def _marked(self, provider_id: str) -> bool:
        for n in self.cluster.deep_copy_nodes():
            if n.provider_id() == provider_id:
                return n.marked_for_deletion
        return False
