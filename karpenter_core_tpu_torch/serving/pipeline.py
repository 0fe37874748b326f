"""Staged async serving pipeline: the port's copy of
``karpenter_core_tpu/serving/pipeline.py``.

The provisioner was tick-shaped: batch pending pods, solve, emit —
serially, with a polling batcher in front. Production traffic is a
stream. This module overlaps the stages:

    watch events ──► ingest (observe_pod_event: stamp arrival, trigger window)
                          │
                 batch former thread: condition-variable window
                 (idle/max), runs WHILE the current solve is in flight
                          │  bounded solve queue (backpressure)
                 plan thread: the single AUTHORITATIVE stage —
                 pending-pod listing → solve (encode → device dispatch →
                 finalize) → NodeClaim emit, strictly in tick order
                          │  bounded telemetry queue
                 telemetry thread: latency histograms, queue gauges,
                 per-stage attribution off the solve trace
    prewarm thread: double buffer — while tick N's pack is in flight on
    device, tick N+1's accumulating batch runs `encode_prewarm` on the
    host (pod memos, signature grouping, compat kernel rows), so the
    authoritative solve is warm by construction.

Overlap-safety invariant: **overlap is scheduling, never reordering of
observable state.** Only the plan thread mutates observable state
(claims, nominations, events), in tick order — concurrent stages form
batches, warm content-addressed caches (sound by the cache-key analysis
family), and drain telemetry. Hence pipeline plans are byte-identical
to the equivalent sequential reconcile; `SequentialLoop` below IS that
reconcile (same decision step, no overlap), and bench config 8 + the
seeded-interleaving test assert the identity on every traffic scenario.

Every stage boundary is a `StageQueue` (lock-free sharing is banned in
this package by the pipeline-safety analysis rule). The reference reads
its knobs from ``KARPENTER_TPU_SERVING_*``; the port's `PipelineConfig`
defaults are the reference's defaults as constants (the queue caps are
``queues.SOLVE_CAP``/``TELEMETRY_CAP``, the snapshot directory is
``warmstore.WARMSTORE_DIR``), and callers pass another config.

On the card: the plan thread's solves and the prewarm thread's
speculative encodes both launch the compat kernel. Neither thread takes
a CUDA stream of its own, so every launch goes to the legacy default
stream and they serialize. Every solver the pipeline builds (prewarm,
warm store, boot prewarm) runs on the provisioner's ``device``, so the
device-keyed warm rows the prewarm fills are the ones the
authoritative solve reads.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..provisioning.batcher import Batcher
from ..tracing import flightrec, tracer
from ..utils import pod as podutils
from .latency import DecisionLatencyTracker
from . import queues
from .queues import Closed, StageQueue

log = logging.getLogger("karpenter.torch.serving")


def _warmstore_dir() -> Optional[str]:
    from ..solver import warmstore

    return warmstore.WARMSTORE_DIR


@dataclass
class PipelineConfig:
    """Serving knobs. Queue caps bound each stage's buffering — a full
    queue blocks the producer (backpressure), it never drops work."""

    idle_seconds: float = 1.0
    max_seconds: float = 10.0
    # batch tokens in flight: 1 = the window former may run exactly one
    # window ahead of the solve (the double buffer); raising it deepens
    # lookahead without changing plan identity (emits stay serialized)
    solve_queue_cap: int = field(default_factory=lambda: queues.SOLVE_CAP)
    telemetry_queue_cap: int = field(default_factory=lambda: queues.TELEMETRY_CAP)
    prewarm: bool = True
    # run the disruption pass as a pipeline stage every N plan ticks
    # (0 = off). It executes ON the plan thread, after the provisioning
    # step — disruption mutates claims/taints/cluster marks, and the
    # overlap-safety invariant says only the plan thread mutates
    # observable state. The batched engine's cross-pass memos
    # (disruption/engine.py) make the steady-state pass cheap, which is
    # what lets it ride the serving cadence instead of a 10 s timer.
    disrupt_every: int = 0
    # warm-state persistence (solver/warmstore.py): with a
    # directory configured, `quiesce()` snapshots the cache planes and
    # returns the snapshot path; `warmstore_restore` (a snapshot path)
    # is restored before the first tick so a restarted pipeline's first
    # solve is a warm solve
    warmstore_dir: Optional[str] = field(default_factory=_warmstore_dir)
    warmstore_restore: Optional[str] = None
    # stale-world guard: with a positive bound, the plan
    # thread refuses to run the authoritative step against an observed
    # world older than this many seconds (no watch event / explicit
    # staleness mark) — the tick HOLDS (counted, visible in /debug)
    # until freshness recovers. 0 disables the age check; the explicit
    # `set_world_stale` seam works regardless.
    max_staleness_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "idle_seconds": self.idle_seconds,
            "max_seconds": self.max_seconds,
            "solve_queue_cap": self.solve_queue_cap,
            "telemetry_queue_cap": self.telemetry_queue_cap,
            "prewarm": self.prewarm,
            "disrupt_every": self.disrupt_every,
            "warmstore_dir": self.warmstore_dir,
            "warmstore_restore": self.warmstore_restore,
            "max_staleness_s": self.max_staleness_s,
        }


class LostLeadership(RuntimeError):
    """Raised by the leader admission guard when a NodeClaim write is
    attempted by a process that no longer holds the leader lease — the
    deposed leader's in-flight tick must not emit."""


class _DecisionStep:
    """The shared authoritative decision step: one sequential reconcile
    (pending listing → solve → emit), plus decision-latency marking and
    the optional on_decision hook (the traffic simulator's kubelet
    binder). Both the pipeline's plan thread and `SequentialLoop` run
    EXACTLY this code, which is what makes 'byte-identical to the
    sequential reconcile' hold by construction.

    Telemetry plane: the whole step runs under one
    ``decision`` trace root — the provisioner's reconcile root and the
    solver's solve root JOIN it, so every span of the decision's
    lifetime (including spans worker threads adopt via the captured
    context) lands under one trace. At plan-emit time the step
    assembles the decision's flight record. ``on_root`` (pipeline only)
    receives the decision's TraceContext the moment the root opens —
    the prewarm thread adopts it so the double buffer's speculative
    work is attributed to the decision it overlaps."""

    def __init__(
        self,
        provisioner,
        latency: DecisionLatencyTracker,
        on_decision=None,
        kind: str = "sequential",
        recorder=None,
        on_root=None,
    ):
        self.provisioner = provisioner
        self.latency = latency
        self.on_decision = on_decision
        self.kind = kind
        self.recorder = recorder if recorder is not None else flightrec.RECORDER
        self.on_root = on_root
        # the decision context of the step in flight / just finished —
        # read only by the thread that called run() (the plan thread or
        # the sequential loop), for enqueueing downstream work under
        # this decision's trace
        self.last_ctx = None

    def run(self, tick: int, queue_wait_ms: Optional[float] = None) -> dict:
        t0 = time.perf_counter()
        with tracer.trace_root("decision", buffer_if="solve", tick=tick) as tr:
            self.last_ctx = tracer.capture()
            if self.on_root is not None:
                self.on_root(self.last_ctx)
            names, reason, results = self.provisioner.reconcile_with_results()
            decided: List[str] = []
            errored: List[str] = []
            plan_cost = 0.0
            if results is not None:
                for plan in getattr(results, "tpu_plans", []) or []:
                    if getattr(plan, "created_claim_name", None):
                        decided.extend(p.uid for p in plan.pods)
                        plan_cost += float(getattr(plan, "price", 0.0) or 0.0)
                for claim in results.new_node_claims:
                    if getattr(claim, "created_claim_name", None):
                        decided.extend(p.uid for p in claim.pods)
                for plan in getattr(results, "existing_plans", []) or []:
                    decided.extend(p.uid for p in getattr(plan, "pods", []) or [])
                for ex in results.existing_nodes:
                    decided.extend(p.uid for p in ex.pods)
                errored.extend(results.pod_errors.keys())
            trace_id = tr.trace_id if tr is not None else None
            # decision point: the plan (or terminal error) is emitted —
            # the settled latencies feed the flight record, the trace_id
            # rides the latency histogram as an exemplar
            settled = self.latency.pods_decided(decided, tick, trace_id=trace_id)
            settled += self.latency.pods_decided(
                errored, tick, error=True, trace_id=trace_id
            )
            if self.on_decision is not None and results is not None:
                # simulator hook (kubelet binder) — runs ON the authoritative
                # thread, before the next tick's listing, in both modes
                self.on_decision(tick, results)
        solver = None
        cached = getattr(self.provisioner, "_tpu_solver", None)
        if cached is not None:
            solver = cached[1]
        timings = getattr(solver, "last_timings", None) if solver is not None else None
        step_ms = round((time.perf_counter() - t0) * 1000.0, 3)
        self._flight_record(
            tick, tr, solver, settled, decided, errored, queue_wait_ms, plan_cost
        )
        return {
            "tick": tick,
            "step_ms": step_ms,
            "created": len(names),
            "decided": len(decided),
            "errors": len(errored),
            "reason": reason,
            "trace_id": getattr(solver, "last_trace_id", None),
            "decision_trace_id": tr.trace_id if tr is not None else None,
            "solve_host_ms": round((timings or {}).get("host_ms", 0.0), 3),
            "solve_device_ms": round((timings or {}).get("device_ms", 0.0), 3),
            # the device plane's compile events (library loads) of this
            # tick's solve; None with the plane off
            "solve_compiles": (
                (getattr(solver, "last_device_stats", None) or {}).get("compiles")
                if solver is not None
                else None
            ),
        }

    def _flight_record(
        self, tick, tr, solver, settled, decided, errored, queue_wait_ms, plan_cost
    ) -> None:
        """Assemble the decision's flight record once the root closed
        (so the root span's duration and every same-thread span are
        final). Must never fail the decision."""
        try:
            from ..solver import stats as solver_stats

            solve = solver_stats.solve_stats(solver) if solver is not None else {}
            cost: dict = {}
            if decided and plan_cost:
                from ..solver import plancost

                bound = (solve.get("pack_backend") or {}).get("lp_bound_sum")
                gap = plancost.optimality_gap(plan_cost, bound) if bound else None
                cost = {
                    "plan_cost_per_hr": round(plan_cost, 4),
                    "lp_bound_per_hr": round(bound, 4) if bound else None,
                    "opt_gap_pct": round(gap * 100.0, 2) if gap is not None else None,
                }
            if tr is not None and queue_wait_ms:
                # queue wait on the synthetic lane: visible in the trace
                # viewer just before the root, excluded from breakdowns
                tr.add_synthetic(
                    "queue_wait",
                    tr.start_ns - int(queue_wait_ms * 1e6),
                    int(queue_wait_ms * 1e6),
                )
            self.recorder.record(
                self.kind,
                tick,
                trace=tr,
                solve=solve,
                queue_wait_ms=queue_wait_ms,
                latency_ms=[s * 1000.0 for s in settled],
                pods_decided=len(decided),
                errors=len(errored),
                cost=cost,
            )
        except Exception:  # noqa: BLE001 — telemetry must never fail a decision
            log.debug("flight-record assembly failed", exc_info=True)


class ServingPipeline:
    """The staged pipeline. Wire `observe_pod_event` into the kube pod
    watch, then `start()`. `hold()`/`release()` gate batch formation
    (used by the lockstep identity harness and operational pause);
    `quiesce()` waits for the decision stream to drain."""

    def __init__(
        self,
        provisioner,
        metrics=None,
        config: Optional[PipelineConfig] = None,
        latency: Optional[DecisionLatencyTracker] = None,
        on_decision: Optional[Callable] = None,
        disruption=None,
    ):
        self.provisioner = provisioner
        self.kube_client = provisioner.kube_client
        self.cluster = provisioner.cluster
        self.metrics = metrics
        self.config = config or PipelineConfig()
        self.latency = latency or DecisionLatencyTracker(
            histogram=getattr(metrics, "serving_decision_latency", None)
        )
        self.batcher = Batcher(
            idle_seconds=self.config.idle_seconds, max_seconds=self.config.max_seconds
        )
        depth_gauge = getattr(metrics, "serving_queue_depth", None)
        self.solve_q = StageQueue("solve", self.config.solve_queue_cap, depth_gauge)
        self.telemetry_q = StageQueue(
            "telemetry", self.config.telemetry_queue_cap, depth_gauge
        )
        burn_gauge = getattr(metrics, "decision_slo_burn", None)
        if burn_gauge is not None:
            flightrec.RECORDER.attach_burn_gauge(burn_gauge)
        self._step = _DecisionStep(
            provisioner,
            self.latency,
            on_decision,
            kind="pipeline",
            on_root=self._set_plan_ctx,
        )
        # optional continuous-disruption stage (DisruptionController):
        # reconciled on the plan thread every `disrupt_every` ticks, so
        # the single-writer invariant holds for disruption's mutations
        # (taints, claims, deletion marks) exactly as for provisioning's
        self.disruption = disruption
        self._disrupt_log: deque = deque(maxlen=32)
        self._stop_evt = threading.Event()
        self._new_pods_evt = threading.Event()
        # the double-buffer handshake: set by the live solver the moment
        # its encode phase hands off to device pack (the host is idle
        # while the pack is in flight — exactly the prewarm slot);
        # cleared by the plan thread before each authoritative step
        self._encode_done_evt = threading.Event()
        self._encode_done_evt.set()
        provisioner.encode_done_listener = self._encode_done_evt.set
        self._gate_cv = threading.Condition()
        self._gate_held = False
        self._mu = threading.Lock()
        self._ticks = 0
        self._step_inflight = False
        # ticks whose telemetry record has landed in the tick log — the
        # quiesce barrier compares this against _ticks so a "quiesced"
        # pipeline's /debug payload is settled (no undrained tick)
        self._telemetry_drained = 0
        self._ingested = 0
        # the in-flight decision's TraceContext (the prewarm handshake's
        # trace half): stamped by the decision root's on_root hook on
        # the plan thread, adopted by the prewarm thread so the double
        # buffer's speculative encode lands on the decision it overlaps
        self._plan_ctx = None
        # ingest → prewarm handoff: pods seen pending since the last
        # prewarm pass. Only NEW pods can have cold memos/signature
        # rows, so the speculative encode walks the delta, never the
        # whole pending set — at steady state the buffer is empty and
        # prewarm costs nothing (GIL included). Dropping entries would
        # only skip speculation, but the cap is far above any burst.
        self._prewarm_buf: deque = deque(maxlen=100_000)
        # bounded memory of recently-pending pods: after a catalog
        # event the fresh catalog entry starts with empty compat rows
        # and a fresh vocab, so prewarm replays these to rebuild rows,
        # masks, and the kernels' compiled shapes off the hot path
        self._recent_pods: "OrderedDict[str, object]" = OrderedDict()
        self._catalog_dirty = False
        self._tick_log: deque = deque(maxlen=64)
        self._prewarm_stats: dict = {}
        self._prewarm_runs = 0
        self._catalog_prewarms = 0
        self._prewarm_solver = None  # (nodepool key, TorchScheduler, nodepools)
        # warm-state restore outcome: per-plane restored/
        # dropped counts of the pre-first-tick restore, for /debug
        self._warmstore_outcome: Optional[dict] = None
        # boot-order contract: restore → prewarm → tick 0. Cleared by
        # start() when a restore landed (a boot prewarm is pending on the
        # prewarm thread); the plan thread's first tick waits on it,
        # bounded, so a restored process's first solve finds the kernel
        # libraries loaded. Set everywhere else — tick 0 must never
        # deadlock on a prewarm that will not run.
        self._boot_prewarm_done = threading.Event()
        self._boot_prewarm_done.set()
        self._boot_prewarm_result: Optional[dict] = None
        # chaos-plane degradation state: the stale-world
        # guard's freshness stamp (monotonic; any watch delivery is
        # evidence of liveness) + explicit staleness seam, the leader
        # emit gate, and the held-tick counters the bench gates on
        # (held ticks are degradation, never silent)
        self._world_stamp = time.monotonic()
        self._world_stale_flag = False
        self._stale_holds = 0
        self._leader_holds = 0
        self._is_leader: Optional[Callable[[], bool]] = None
        self._leader_guard = None
        self._threads: List[threading.Thread] = []
        self._watch_unsub = None

    # -- ingest stage (watch-callback context) ------------------------------

    def attach_watch(self) -> None:
        """Subscribe the ingest stage to the kube pod watch."""
        self._watch_unsub = self.kube_client.watch("Pod", self.observe_pod_event)

    def observe_pod_event(self, event: str, pod) -> None:
        """Ingest: stamp first-pending arrival (the SLO clock starts
        here) and nudge the batch window. Runs on whatever thread wrote
        the pod — the cheap, nonblocking edge of the pipeline."""
        self.note_world_event()
        if event == "DELETED":
            self.latency.forget(pod.uid)
            return
        if podutils.is_provisionable(pod):
            self.latency.pod_pending(pod.uid)
            with self._mu:
                self._ingested += 1
                self._prewarm_buf.append(pod)
            self.batcher.trigger()
            self._new_pods_evt.set()

    def observe_catalog_event(self) -> None:
        """Ingest for provider-side catalog/price changes (spot price
        storms, offering updates). These arrive asynchronously to pod
        traffic, and re-tensorizing the catalog is the most expensive
        single encode step — the prewarm stage absorbs it into idle
        time, where the tick-shaped loop pays it on its first
        post-event solve."""
        with self._mu:
            self._catalog_dirty = True
        self.note_world_event()
        self._new_pods_evt.set()

    # -- chaos-plane degradation --------------------------------------------

    def note_world_event(self) -> None:
        """Any watch/catalog delivery is evidence the observed world is
        live — refresh the stale-world guard's freshness stamp. Called
        from the ingest edge; watch-liveness probes may call it too."""
        with self._mu:
            self._world_stamp = time.monotonic()

    def set_world_stale(self, stale: bool) -> None:
        """Explicit staleness seam: a watch-health monitor (or the chaos
        harness) marks the observed world unsafe to plan against —
        e.g. the watch channel is flapping/hung, or node heartbeats
        stopped. Independent of the age-bound check."""
        with self._mu:
            self._world_stale_flag = bool(stale)

    def world_is_stale(self) -> bool:
        bound = self.config.max_staleness_s
        with self._mu:
            if self._world_stale_flag:
                return True
            if bound > 0.0:
                return (time.monotonic() - self._world_stamp) > bound
        return False

    def attach_leader_gate(self, is_leader: Callable[[], bool], guard_writes: bool = True) -> None:
        """Single-writer enforcement under leader election: (a) the plan
        thread holds each tick while not leading, and (b) an admission
        guard on the kube client rejects NodeClaim writes the moment
        leadership is lost — so a failover MID-tick (leadership lost
        after the step started) still cannot emit: the deposed leader's
        in-flight emit raises LostLeadership at the write, the tick
        lands as an error, and the new leader is the sole writer.

        Attach/detach happen while the pipeline is held (or before
        start/after stop) — the admission-guard list itself is only
        ever mutated with no tick in flight. ``guard_writes=False``
        attaches (a) alone: the guard sits on the client, so it would
        refuse the leader's writes too where two operators share one
        client in a process."""

        def _guard(obj) -> None:
            if obj.kind == "NodeClaim" and not is_leader():
                raise LostLeadership("NodeClaim write without leadership")

        kc = self.kube_client
        with self._mu:
            self._is_leader = is_leader
            self._leader_guard = _guard if guard_writes else None
        if guard_writes:
            kc.admission.append(_guard)

    def detach_leader_gate(self) -> None:
        with self._mu:
            guard, self._leader_guard = self._leader_guard, None
            self._is_leader = None
        if guard is not None:
            kc = self.kube_client
            try:
                kc.admission.remove(guard)
            except ValueError:
                pass

    def held_ticks(self) -> dict:
        with self._mu:
            return {"stale": self._stale_holds, "leader": self._leader_holds}

    def _await_emit_preconditions(self) -> bool:
        """The degradation point: before the authoritative step runs,
        prove (a) the observed world is within the freshness bound and
        (b) this process holds leadership. Failing either HOLDS the
        tick — counted once per hold, never emitted — and waits for
        recovery. A held tick keeps its batch token, so the pending work
        is decided the moment the world recovers (degrade to hold +
        counter, never a stale plan). Returns False when stopping."""
        counted_stale = counted_leader = False
        while not self._stop_evt.is_set():
            stale = self.world_is_stale()
            with self._mu:
                is_leader = self._is_leader
            deposed = is_leader is not None and not is_leader()
            if not stale and not deposed:
                return True
            with self._mu:
                if stale and not counted_stale:
                    self._stale_holds += 1
                    counted_stale = True
                if deposed and not counted_leader:
                    self._leader_holds += 1
                    counted_leader = True
            time.sleep(0.005)
        return False

    # -- batch former stage --------------------------------------------------

    def _batch_loop(self) -> None:
        while not self._stop_evt.is_set():
            if not self.batcher.wait():
                continue  # max window elapsed with no trigger — re-check stop
            token = {"formed_at": time.perf_counter()}
            try:
                # blocks while a solve is in flight and one batch is
                # already queued: backpressure, the next window keeps
                # absorbing triggers meanwhile
                self.solve_q.put(token)
            except Closed:
                return

    # -- plan stage (the authoritative thread) -------------------------------

    def _plan_loop(self) -> None:
        # tick-0 gate: wait for the boot prewarm so the first
        # authoritative solve finds the kernel libraries loaded. Bounded —
        # a wedged prewarm costs a cold first solve, not a dead pipeline.
        self._boot_prewarm_done.wait(timeout=60.0)
        while True:
            try:
                token = self.solve_q.get(timeout=0.2)
            except Closed:
                return
            if token is None:
                if self._stop_evt.is_set():
                    return
                continue
            # the hold gate sits HERE, not in the window former: a batch's
            # content is determined by the pending listing at solve time,
            # so gating the authoritative step is what makes a lockstep
            # driver's injections atomic w.r.t. decisions (tokens formed
            # early just wait; an extra token solves an empty batch)
            with self._gate_cv:
                while self._gate_held and not self._stop_evt.is_set():
                    self._gate_cv.wait(timeout=0.2)
            if self._stop_evt.is_set():
                return
            # stale-world guard + leader gate: the tick holds
            # here — token kept, nothing emitted — until the world is
            # fresh and this process leads. Sits AFTER the hold gate so
            # lockstep drivers stay atomic, BEFORE tick accounting so a
            # held tick never appears as an undrained tick to quiesce().
            if not self._await_emit_preconditions():
                return
            queue_wait_ms = round(
                (time.perf_counter() - token["formed_at"]) * 1000.0, 3
            )
            with self._mu:
                self._ticks += 1
                tick = self._ticks
                self._step_inflight = True
            self._encode_done_evt.clear()
            try:
                rec = self._step.run(tick, queue_wait_ms=queue_wait_ms)
            except Exception:  # noqa: BLE001 — one failed tick must not kill serving
                log.exception("serving tick %d failed", tick)
                rec = {"tick": tick, "error": True}
            finally:
                self._set_plan_ctx(None)
                with self._mu:
                    self._step_inflight = False
                self._encode_done_evt.set()
            self._maybe_disrupt(tick, rec)
            rec["queue_wait_ms"] = queue_wait_ms
            try:
                # the decision's context rides the entry: the telemetry
                # stage adopts it, so its drain work lands on the
                # decision's trace (its own lane, after the root)
                self.telemetry_q.put(rec, timeout=1.0, ctx=self._step.last_ctx)
            except Closed:
                return

    def _set_plan_ctx(self, ctx) -> None:
        with self._mu:
            self._plan_ctx = ctx

    def _maybe_disrupt(self, tick: int, rec: dict) -> None:
        """Continuous-disruption stage: one DisruptionController pass on
        the plan thread every `disrupt_every` ticks (0 = off). Runs
        after the provisioning step so the pass sees this tick's
        nominations; the engine's cross-pass memos make a no-change pass
        nearly free, which is what makes per-tick cadence viable."""
        if self.disruption is None or self.config.disrupt_every <= 0:
            return
        if tick % self.config.disrupt_every != 0:
            return
        t0 = time.perf_counter()
        try:
            executed = self.disruption.reconcile()
        except Exception:  # noqa: BLE001 — a failed pass must not kill serving
            log.exception("serving disruption pass at tick %d failed", tick)
            return
        rec["disrupt_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        if executed:
            rec["disrupt_method"] = executed
        stats = getattr(self.disruption, "last_decision_stats", None)
        try:
            self._step.recorder.record(
                "disrupt",
                tick,
                trace=getattr(self.disruption, "last_trace", None),
                solve={"disruption": dict(stats) if stats else None},
                pods_decided=0,
                executed=executed,
            )
        except Exception:  # noqa: BLE001 — telemetry must never fail the pass
            log.debug("disrupt flight-record failed", exc_info=True)
        with self._mu:
            self._disrupt_log.append(
                {
                    "tick": tick,
                    "ms": rec["disrupt_ms"],
                    "executed": executed,
                    "stats": stats,
                }
            )
        if self.metrics is not None:
            self.metrics.serving_stage_duration.observe(
                rec["disrupt_ms"] / 1000.0, stage="disrupt"
            )

    # -- telemetry stage -----------------------------------------------------

    def _telemetry_loop(self) -> None:
        while True:
            try:
                entry = self.telemetry_q.get_entry(timeout=0.2)
            except Closed:
                return
            if entry is None:
                if self._stop_evt.is_set() and self.telemetry_q.depth() == 0:
                    return
                continue
            rec, ctx = entry
            with tracer.adopt(ctx, "telemetry.drain", tick=rec.get("tick")):
                self._record_telemetry(rec)

    def _record_telemetry(self, rec: dict) -> None:
        trace_id = rec.get("trace_id")
        if trace_id:
            trace = tracer.RING.get(trace_id)
            if trace is not None:
                rec["phase_breakdown_ms"] = {
                    k: round(v, 2) for k, v in sorted(trace.phase_breakdown_ms().items())
                }
        if self.metrics is not None and "step_ms" in rec:
            self.metrics.serving_stage_duration.observe(
                rec["step_ms"] / 1000.0, stage="plan"
            )
            self.metrics.serving_stage_duration.observe(
                rec.get("queue_wait_ms", 0.0) / 1000.0, stage="batch_wait"
            )
        with self._mu:
            self._tick_log.append(rec)
            self._telemetry_drained += 1

    # -- prewarm stage (the double buffer) -----------------------------------

    def _prewarm_loop(self) -> None:
        self._boot_prewarm_replay()
        while not self._stop_evt.is_set():
            if not self._new_pods_evt.wait(timeout=0.25):
                continue
            # debounce: let a create burst accumulate (and give the
            # ingesting thread the GIL back) before walking the delta
            time.sleep(0.01)
            self._new_pods_evt.clear()
            if not self.config.prewarm or self._stop_evt.is_set():
                continue
            # the speculative encode shares the catalog lock (and the
            # GIL) with the authoritative encode — running during THAT
            # phase would make the step wait on speculation. The prewarm
            # slot is everything else: the gap between ticks, and — the
            # double buffer — the in-flight step's pack/finalize, which
            # the solver signals via encode_done_listener the moment its
            # encode hands off to device (tick N's pack runs on device
            # while tick N+1's delta encodes on the host).
            if not self._encode_done_evt.wait(timeout=0.05):
                self._new_pods_evt.set()
                continue
            try:
                # adopt the overlapped decision's context (None → the
                # prewarm's own never-buffered roots, as before): the
                # speculative encode shows up on its own lane of the
                # decision it double-buffers
                with self._mu:
                    ctx = self._plan_ctx
                with tracer.adopt(ctx, "prewarm"):
                    self._prewarm_once()
            except Exception:  # noqa: BLE001 — speculation must never break serving
                log.debug("serving prewarm failed", exc_info=True)

    def _boot_prewarm_replay(self) -> None:
        """The prewarm half of the boot-order contract (restore →
        prewarm → tick 0): load the kernel libraries and calibrate on the
        provisioner's device (``solver/prewarm.py``) before the plan
        thread's first authoritative tick. Runs once, on this thread,
        gated by the event ``start()`` armed; a failed prewarm is logged
        as an error and degrades to a cold first solve, never a dead
        pipeline."""
        if self._boot_prewarm_done.is_set():
            return
        try:
            from ..solver import prewarm as boot_prewarm

            solver = self._warmstore_solver()
            result = boot_prewarm.warmup_compile_only(solver)
            with self._mu:
                self._boot_prewarm_result = result
        except Exception:  # noqa: BLE001 — a prewarm must never break serving boot
            log.exception("boot prewarm failed; first solve runs cold")
        finally:
            self._boot_prewarm_done.set()

    def _prewarm_once(self) -> None:
        """Speculatively encode the newly arrived pods on a dedicated
        solver instance. Warms only content-addressed caches shared by
        construction (see TorchScheduler.encode_prewarm) — safe to race
        the authoritative solve, even on a stale batch guess. Walks the
        ingest delta only: pods already prewarmed (or already decided)
        have warm memos and signature rows, and re-walking the whole
        pending set would steal the GIL from the authoritative stages
        for no cache effect."""
        with self._mu:
            if not self._prewarm_buf and not self._catalog_dirty:
                return
            delta = list(self._prewarm_buf)
            self._prewarm_buf.clear()
            catalog_dirty = self._catalog_dirty
            self._catalog_dirty = False
        if catalog_dirty:
            solver = self._prewarm_scheduler()
            if solver is not None:
                stats = solver.prewarm_catalog()
                with self._mu:
                    self._catalog_prewarms += 1
                    self._prewarm_stats = stats
                # the fresh entry has no compat rows and a fresh vocab:
                # replay the recent workload through the encode so row
                # rebuilds and kernel recompiles happen HERE, not on the
                # first post-event authoritative solve
                with self._mu:
                    recent = list(self._recent_pods.values())
                if recent:
                    stats = solver.encode_prewarm(
                        recent, daemonset_pods=self.cluster.get_daemonset_pods()
                    )
                    with self._mu:
                        self._prewarm_stats = stats
        seen = set()
        pods = []
        for pod in delta:
            if pod.uid not in seen and podutils.is_provisionable(pod):
                seen.add(pod.uid)
                pods.append(pod)
        with self._mu:
            for pod in pods:
                self._recent_pods[pod.uid] = pod
                self._recent_pods.move_to_end(pod.uid)
            while len(self._recent_pods) > 4096:
                self._recent_pods.popitem(last=False)
        if not pods:
            return
        solver = self._prewarm_scheduler()
        if solver is None:
            return
        stats = solver.encode_prewarm(
            pods, daemonset_pods=self.cluster.get_daemonset_pods()
        )
        with self._mu:
            self._prewarm_runs += 1
            self._prewarm_stats = stats

    def _prewarm_scheduler(self):
        """A prewarm-only TorchScheduler on the provisioner's device (no
        kube/cluster: it must read no authoritative state), rebuilt when
        the nodepool set changes — same reuse discipline as the
        provisioner's live solver."""
        nodepools = [
            np_
            for np_ in self.kube_client.list("NodePool")
            if np_.metadata.deletion_timestamp is None
        ]
        if not nodepools:
            return None
        key = tuple((id(np_), np_.metadata.resource_version) for np_ in nodepools)
        with self._mu:
            cached = self._prewarm_solver
        if cached is not None and cached[0] == key:
            return cached[1]
        from ..solver import TorchScheduler

        solver = TorchScheduler(
            nodepools, self.provisioner.cloud_provider, device=self.provisioner.device
        )
        with self._mu:
            self._prewarm_solver = (key, solver, list(nodepools))
        return solver

    # -- warm-state persistence (solver/warmstore.py) ------------------------

    def _warmstore_solver(self):
        """The solver whose warm planes snapshot/restore operate on:
        the provisioner's live solver when it exists, else a fresh one
        over the SAME provider object and device — the warm state and the
        catalog cache are provider- and device-keyed module state, so a
        restore through it warms exactly what the provisioner's next
        solver will read."""
        cached = self.provisioner._tpu_solver
        if cached is not None:
            return cached[1]
        nodepools = [
            np_
            for np_ in self.kube_client.list("NodePool")
            if np_.metadata.deletion_timestamp is None
        ]
        if not nodepools:
            return None
        from ..solver import TorchScheduler

        return TorchScheduler(
            nodepools,
            self.provisioner.cloud_provider,
            device=self.provisioner.device,
            kube_client=self.kube_client,
            cluster=self.cluster,
        )

    def restore_warm_state(self, path: str) -> Optional[dict]:
        """Restore a warm-state snapshot into this pipeline's solver
        world (call before ``start()``; ``start()`` invokes it itself
        when ``config.warmstore_restore`` is set). → outcome dict with
        per-plane restored/dropped counts, or None when no solver can
        be built yet."""
        solver = self._warmstore_solver()
        if solver is None:
            return None
        outcome = solver.restore(path)
        with self._mu:
            self._warmstore_outcome = outcome
        return outcome

    def snapshot_warm_state(self, directory: Optional[str] = None) -> Optional[str]:
        """Snapshot the live solver's warm planes → path (or None when
        persistence is disabled or nothing can be snapshotted)."""
        solver = self._warmstore_solver()
        if solver is None:
            return None
        return solver.snapshot(directory=directory or self.config.warmstore_dir)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        # restore BEFORE the first tick: the plan thread's first solve
        # must already see the restored planes (zero-cold-start restart)
        if self.config.warmstore_restore:
            try:
                self.restore_warm_state(self.config.warmstore_restore)
            except Exception:  # noqa: BLE001 — a bad snapshot degrades to a cold start
                log.exception("warm-state restore failed; starting cold")
        # arm the tick-0 prewarm gate only when a restore actually
        # landed and the boot prewarm is enabled: the prewarm thread
        # will run it and release the gate
        from ..solver import prewarm as boot_prewarm

        with self._mu:
            restored = self._warmstore_outcome is not None
        if restored and boot_prewarm.enabled():
            self._boot_prewarm_done.clear()
        else:
            self._boot_prewarm_done.set()
        self._stop_evt.clear()
        self.solve_q.reopen()
        self.telemetry_q.reopen()
        self._threads = [
            threading.Thread(target=self._batch_loop, name="serve-batch", daemon=True),
            threading.Thread(target=self._plan_loop, name="serve-plan", daemon=True),
            threading.Thread(
                target=self._telemetry_loop, name="serve-telemetry", daemon=True
            ),
            threading.Thread(target=self._prewarm_loop, name="serve-prewarm", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        with self._gate_cv:
            self._gate_cv.notify_all()
        self.batcher.trigger()  # wake a waiting window former
        # closing the queues unblocks any stage parked on put/get; an
        # in-flight authoritative tick still completes first (the plan
        # thread only sees Closed at its next queue operation)
        self.solve_q.close()
        self.telemetry_q.close()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads = []
        if self._watch_unsub is not None:
            self._watch_unsub()
            self._watch_unsub = None
        self.detach_leader_gate()

    # -- gating / quiescence (lockstep harness + operational pause) ----------

    def hold(self) -> None:
        """Pause batch formation (in-flight ticks finish; triggers keep
        accumulating in the window)."""
        with self._gate_cv:
            self._gate_held = True

    def release(self) -> None:
        with self._gate_cv:
            self._gate_held = False
            self._gate_cv.notify_all()

    def ticks(self) -> int:
        with self._mu:
            return self._ticks

    def quiesce(self, timeout: float = 30.0, require_empty: bool = True):
        """Wait until the decision stream drains: no queued batches, no
        in-flight step, no undrained telemetry (a quiesced pipeline's
        /debug payload is settled — the tick log must already hold every
        completed tick), and (require_empty) no undecided pending pods.

        Returns False on timeout. On success, with a warmstore directory
        configured (``config.warmstore_dir``), the quiesced cache planes
        are snapshotted and the SNAPSHOT PATH is returned (truthy) so
        operators/trafficgen can hand it to a restarted process without
        a side channel; otherwise True."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                busy = self._step_inflight
                drained = self._telemetry_drained >= self._ticks
            if (
                not busy
                and drained
                and self.solve_q.depth() == 0
                and (not require_empty or self.latency.pending_count() == 0)
            ):
                if self.config.warmstore_dir:
                    path = self.snapshot_warm_state()
                    if path is not None:
                        return path
                return True
            time.sleep(0.002)
        return False

    # -- observability -------------------------------------------------------

    def debug_state(self) -> dict:
        """The /debug/serving payload: config, queue stats, tick log
        tail, prewarm traffic, SLO percentiles."""
        with self._mu:
            ticks = self._ticks
            ingested = self._ingested
            tick_log = list(self._tick_log)[-8:]
            prewarm = {
                "runs": self._prewarm_runs,
                "catalog_prewarms": self._catalog_prewarms,
                "boot_replay": self._boot_prewarm_result,
                **self._prewarm_stats,
            }
            disrupt_log = list(self._disrupt_log)[-4:]
            warmstore_outcome = self._warmstore_outcome
            stale_holds = self._stale_holds
            leader_holds = self._leader_holds
            leader_gate = self._is_leader is not None
        return {
            "config": self.config.to_dict(),
            "ticks": ticks,
            "pods_ingested": ingested,
            "pods_decided": self.latency.decided_count(),
            "pods_pending": self.latency.pending_count(),
            "decision_latency_ms": self.latency.percentiles(),
            "queues": {
                "solve": self.solve_q.stats(),
                "telemetry": self.telemetry_q.stats(),
            },
            "prewarm": prewarm,
            "last_ticks": tick_log,
            "disrupt": {
                "every": self.config.disrupt_every,
                "attached": self.disruption is not None,
                "last_passes": disrupt_log,
            },
            "flightrec": {
                "coverage": self._step.recorder.coverage(kind="pipeline"),
                "burn_rate": self._step.recorder.burn_rates(),
                "retained": len(self._step.recorder),
            },
            "warmstore": warmstore_outcome,
            "chaos": {
                "max_staleness_s": self.config.max_staleness_s,
                "world_stale": self.world_is_stale(),
                "held_ticks": {"stale": stale_holds, "leader": leader_holds},
                "leader_gate": leader_gate,
                "fault_window": flightrec.active_fault_window(),
            },
        }


class SequentialLoop:
    """The tick-shaped baseline: the same authoritative decision step,
    no overlap — window, then solve, then emit, serially on one thread.
    This is the 'equivalent sequential reconcile' the pipeline's plans
    must be byte-identical to, and the latency baseline config 8's SLO
    gate compares against."""

    def __init__(
        self,
        provisioner,
        metrics=None,
        config: Optional[PipelineConfig] = None,
        latency: Optional[DecisionLatencyTracker] = None,
        on_decision: Optional[Callable] = None,
    ):
        self.provisioner = provisioner
        self.kube_client = provisioner.kube_client
        self.metrics = metrics
        self.config = config or PipelineConfig()
        self.latency = latency or DecisionLatencyTracker(
            histogram=getattr(metrics, "serving_decision_latency", None)
        )
        self.batcher = Batcher(
            idle_seconds=self.config.idle_seconds, max_seconds=self.config.max_seconds
        )
        self._step = _DecisionStep(provisioner, self.latency, on_decision)
        self._stop_evt = threading.Event()
        self._mu = threading.Lock()
        self._ticks = 0
        self._thread: Optional[threading.Thread] = None
        self._watch_unsub = None

    def attach_watch(self) -> None:
        self._watch_unsub = self.kube_client.watch("Pod", self.observe_pod_event)

    def observe_pod_event(self, event: str, pod) -> None:
        if event == "DELETED":
            self.latency.forget(pod.uid)
            return
        if podutils.is_provisionable(pod):
            self.latency.pod_pending(pod.uid)
            self.batcher.trigger()

    def step_once(self) -> dict:
        """One synchronous decision tick (the lockstep driver's entry)."""
        with self._mu:
            self._ticks += 1
            tick = self._ticks
        return self._step.run(tick)

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            if not self.batcher.wait():
                continue
            if self._stop_evt.is_set():
                return
            self.step_once()

    def start(self) -> None:
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, name="seq-loop", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        self.batcher.trigger()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._watch_unsub is not None:
            self._watch_unsub()
            self._watch_unsub = None

    def ticks(self) -> int:
        with self._mu:
            return self._ticks
