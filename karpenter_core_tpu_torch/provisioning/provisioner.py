"""Provisioner: batch → sync gate → schedule → create NodeClaims (ref
pkg/controllers/provisioning/provisioner.go): the port's copy of
``karpenter_core_tpu/provisioning/provisioner.py``.

``use_tpu_solver`` (the reference's name, kept so callers read the same
attribute) switches Schedule's backend between the greedy scheduler and
the batched solve, here ``TorchScheduler`` on ``device`` (None: the
card); the plans become the same NodeClaim CRs the greedy path stamps,
keeping everything downstream backend-agnostic.

The reference reads ``KARPENTER_TPU_PARITY_SAMPLE`` for the parity
shadow's period; the port keeps its default as the class constant
``PARITY_SAMPLE_EVERY`` (16 solves; 0 turns the shadow off).
``encode_done_listener`` is the serving pipeline's double-buffer hook,
forwarded to the live ``TorchScheduler`` on every solve.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..apis import labels as wk
from ..apis.nodeclaim import NodeClaim
from ..kube.objects import Pod
from ..scheduler.builder import NodePoolsNotFoundError, build_scheduler
from ..scheduler.nodeclaim import SchedulingNodeClaim
from ..scheduler.scheduler import Results, SchedulerOptions
from ..scheduler.volumetopology import VolumeTopology
from ..state.cluster import Cluster
from ..tracing import tracer
from ..utils import pod as podutils
from ..utils.pretty import ChangeMonitor
from .batcher import Batcher


@dataclass
class LaunchOptions:
    """provisioner.go:40-73."""

    record_pod_nomination: bool = False
    reason: str = "provisioning"


class LimitsExceededError(Exception):
    pass


class Provisioner:
    def __init__(
        self,
        kube_client,
        cloud_provider,
        cluster: Cluster,
        recorder=None,
        batcher: Optional[Batcher] = None,
        use_tpu_solver: bool = False,
        metrics=None,
        device=None,
    ):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.recorder = recorder
        self.batcher = batcher or Batcher()
        self.use_tpu_solver = use_tpu_solver
        self.metrics = metrics
        # the batched solve's device, passed to every TorchScheduler this
        # provisioner builds (None: the card)
        self.device = device
        self._change_monitor = ChangeMonitor()
        self._parity_solve_count = 0
        self._parity_inflight = False
        # steady-state ticks reuse one TorchScheduler while the nodepool
        # set is unchanged (identity + resource_version): reuse keeps
        # pool ordering/filtering and the catalog encodings off the tick
        # path and `last_timings`/`last_cache_stats` continuous
        self._tpu_solver = None  # (nodepool key, TorchScheduler, nodepools)
        # serving double-buffer hook, forwarded to the live TorchScheduler:
        # fires when the authoritative encode hands off to pack
        # (serving/pipeline.py overlaps the next batch's prewarm with it)
        self.encode_done_listener = None

    def trigger(self) -> None:
        self.batcher.trigger()

    # -- reconcile (provisioner.go:114) ------------------------------------

    def reconcile(self, wait_for_batch: bool = False) -> Tuple[List[str], Optional[str]]:
        """One pass: returns (created nodeclaim names, requeue reason).
        The pass runs under one trace root (batch → schedule → solve →
        claim creation); the trace is buffered only when a solve ran, so
        idle reconciles can't evict real solve traces."""
        names, reason, _results = self.reconcile_with_results(wait_for_batch)
        return names, reason

    def reconcile_with_results(
        self, wait_for_batch: bool = False
    ) -> Tuple[List[str], Optional[str], Optional[Results]]:
        """``reconcile`` with the scheduling Results exposed (per-plan
        pod membership). Each successfully created claim's name is
        stamped on its plan/claim object as ``created_claim_name``."""
        import time as _time

        batch_t0 = _time.perf_counter()
        if wait_for_batch:
            if not self.batcher.wait():
                return [], None, None
        batch_wait_ms = round((_time.perf_counter() - batch_t0) * 1000.0, 3)
        if not self.cluster.synced():
            return [], "waiting on cluster sync", None
        with tracer.trace_root(
            "provisioner.reconcile", buffer_if="solve", batch_wait_ms=batch_wait_ms
        ):
            results = self.schedule()
            if results is None:
                return [], None, None
            names: List[str] = []
            create_errors: List[str] = []
            opts = LaunchOptions(record_pod_nomination=True, reason="provisioning")
            with tracer.span("create_node_claims"):
                if results.new_node_claims:
                    created, errs = self.create_node_claims(results.new_node_claims, opts)
                    names.extend(created)
                    create_errors.extend(errs)
                for plan in getattr(results, "tpu_plans", []):
                    try:
                        name = self.create_from_plan(plan, opts)
                        plan.created_claim_name = name
                        names.append(name)
                    except Exception as e:  # noqa: BLE001 — one failed plan must not skip the rest
                        create_errors.append(f"creating node claim from plan, {e}")
        # surface failures instead of looking like "nothing to do"
        reason = "; ".join(create_errors[:5]) if create_errors else None
        return names, reason, results

    # -- pod discovery (provisioner.go:155-178) ----------------------------

    def get_pending_pods(self) -> List[Pod]:
        pods = []
        vt = VolumeTopology(self.kube_client)
        for pod in self.kube_client.list("Pod", filter_fn=lambda p: not p.spec.node_name):
            if not podutils.is_provisionable(pod):
                continue
            err = vt.validate_persistent_volume_claims(pod)
            if err is not None:
                continue
            pods.append(pod)
        return pods

    # -- schedule (provisioner.go:298) -------------------------------------

    def schedule(self) -> Optional[Results]:
        # scheduling_duration is observed by the reference operator's
        # reconcile wrapper — observing here too would double-count
        # snapshot nodes BEFORE listing pods to avoid over-provisioning
        # (provisioner.go:301-312)
        with tracer.span("snapshot_nodes"):
            nodes = self.cluster.deep_copy_nodes()
        active = [n for n in nodes if not n.marked_for_deletion]
        deleting = [n for n in nodes if n.marked_for_deletion]
        with tracer.span("pending_pods"):
            pending = self.get_pending_pods()
        # pods on deleting nodes need replacement capacity
        # (provisioner.go:317-323)
        deleting_pods: List[Pod] = []
        for n in deleting:
            for ns, name in n.pod_requests:
                pod = self.kube_client.get("Pod", name, namespace=ns)
                if pod is not None and podutils.is_reschedulable(pod):
                    deleting_pods.append(pod)
        pods = pending + deleting_pods
        if not pods:
            return Results()

        nodepools = [
            np_
            for np_ in self.kube_client.list("NodePool")
            if np_.metadata.deletion_timestamp is None
        ]
        if not nodepools:
            # once-per-hour dedup'd warning (provisioner.go:182-199 via
            # pretty.ChangeMonitor)
            if self._change_monitor.has_changed("no-nodepools", True):
                logging.getLogger("karpenter").warning(
                    "no nodepools found; provisioning is disabled until one is created"
                )
            return Results()
        # the batched path handles existing capacity itself (packs onto free
        # space before opening nodes) and falls back to the oracle only
        # for the constraint classes it can't tensorize
        if self.use_tpu_solver:
            return self._schedule_tpu(pods, nodepools, active)
        try:
            scheduler = build_scheduler(
                self.kube_client,
                self.cluster,
                nodepools,
                self.cloud_provider,
                pods,
                state_nodes=active,
                daemonset_pods=self.cluster.get_daemonset_pods(),
                recorder=self.recorder,
                opts=SchedulerOptions(),
            )
        except NodePoolsNotFoundError:
            return Results()
        with tracer.trace_root("oracle_solve", is_solve=True, pods=len(pods)):
            return scheduler.solve(pods)

    def _schedule_tpu(self, pods: List[Pod], nodepools, state_nodes=None) -> Results:
        """Batched path: solve plans, then re-express them as scheduler
        results so CreateNodeClaims is uniform."""
        from ..solver import TorchScheduler

        key = tuple(
            (id(np_), np_.metadata.resource_version) for np_ in nodepools
        )
        cached = self._tpu_solver
        if cached is not None and cached[0] == key:
            solver = cached[1]
        else:
            solver = TorchScheduler(
                nodepools,
                self.cloud_provider,
                device=self.device,
                kube_client=self.kube_client,
                cluster=self.cluster,
                recorder=self.recorder,
                metrics=self.metrics,
            )
            # the held nodepool list keeps the key's id()s stable
            self._tpu_solver = (key, solver, list(nodepools))
        solver.encode_done_listener = self.encode_done_listener
        sr = solver.solve(
            pods,
            state_nodes=state_nodes,
            daemonset_pods=self.cluster.get_daemonset_pods(),
        )
        results = sr.oracle_results or Results()
        results.pod_errors.update(sr.pod_errors)
        by_uid = {p.uid: p for p in pods}
        # the oracle fallback publishes its own failure events inside
        # solve(); mirror only the tensor-path errors here so the event
        # stream is backend-agnostic without duplicates
        if self.recorder is not None and sr.pod_errors:
            from ..events import events as ev

            oracle_errs = (
                sr.oracle_results.pod_errors if sr.oracle_results is not None else {}
            )
            for uid, err in sr.pod_errors.items():
                pod = by_uid.get(uid)
                if pod is not None and uid not in oracle_errs:
                    self.recorder.publish(ev.pod_failed_to_schedule(pod, err))
        results._pods_by_uid.update(by_uid)
        if sr.node_plans:
            for plan in sr.node_plans:
                plan.pods = [pods[i] for i in plan.pod_indices]
            results.tpu_plans = sr.node_plans  # consumed by reconcile
        # tensor-path placements onto existing nodes are nominations —
        # mirror the oracle's _record_results (nominate + event, no claim).
        # They ride the results as ``existing_plans`` so the serving
        # decision step settles their pods and a binder binds them (the
        # reference's decision step reads the attribute but its
        # provisioner never sets it, so a pod it places on an existing
        # node is never decided nor bound and is placed again each tick)
        results.existing_plans = sr.existing_plans
        for plan in sr.existing_plans:
            plan.pods = [pods[i] for i in plan.pod_indices]
            if self.cluster is not None:
                self.cluster.nominate_node_for_pod(plan.state_node.provider_id())
            if self.recorder is not None:
                from ..events import events as ev

                for pod in plan.pods:
                    self.recorder.publish(ev.nominate_pod(pod, plan.state_node.name()))
        self._maybe_observe_parity(pods, nodepools)
        return results

    # every Nth tensor solve shadows a pod subsample through the greedy
    # scheduler and records node-count parity; 0 disables (the
    # reference's KARPENTER_TPU_PARITY_SAMPLE)
    PARITY_SAMPLE_EVERY = 16
    PARITY_SUBSAMPLE = 500

    def _maybe_observe_parity(self, pods: List[Pod], nodepools) -> None:
        if self.metrics is None or self.PARITY_SAMPLE_EVERY <= 0 or len(pods) < 8:
            return
        self._parity_solve_count += 1
        if self._parity_solve_count % self.PARITY_SAMPLE_EVERY:
            return
        # the shadow only sets a gauge — run it off the provisioning
        # path so the O(P·N) oracle solve never delays NodeClaim
        # creation. Single-flight: a slow oracle must not pile threads
        # up behind the GIL.
        if getattr(self, "_parity_inflight", False):
            return
        self._parity_inflight = True
        import copy as _copy

        # deep-copy the subsample: the oracle's preference relaxation
        # mutates pods in place (scheduler.py relax), and these are the
        # provisioner's LIVE objects, read concurrently by the main loop
        sub = _copy.deepcopy(pods[: self.PARITY_SUBSAMPLE])
        threading.Thread(
            target=self._observe_parity, args=(sub, list(nodepools)), daemon=True
        ).start()

    def _observe_parity(self, sub: List[Pod], nodepools) -> None:
        try:
            from ..scheduler.builder import build_scheduler
            from ..solver import TorchScheduler

            # the shadow's traces must not displace live solve traces in
            # the ring (it runs the same instrumented pipeline)
            with tracer.trace_root("parity_shadow", buffer_if="never"):
                o = build_scheduler(
                    self.kube_client, None, nodepools, self.cloud_provider, sub
                ).solve(sub)
                t = TorchScheduler(
                    nodepools, self.cloud_provider, device=self.device, kube_client=self.kube_client
                ).solve(sub)
            o_scheduled = sum(len(c.pods) for c in o.new_node_claims)
            o_nodes = len(o.new_node_claims)
            if t.pods_scheduled < o_scheduled:
                # scheduling fewer pods must read as a parity failure,
                # not as "fewer nodes = perfect"
                parity = 0.0
            elif t.node_count <= o_nodes:
                # one-sided: as few or fewer nodes than the oracle (incl.
                # both opening none) is full parity
                parity = 1.0
            else:
                parity = o_nodes / t.node_count
            self.metrics.solver_parity.set(parity)
        except Exception:
            # the shadow must never break provisioning, but a broken
            # shadow should not fail silently forever either
            logging.getLogger("karpenter").debug(
                "parity shadow solve failed", exc_info=True
            )
        finally:
            self._parity_inflight = False

    # -- create (provisioner.go:141-153, 341-367) --------------------------

    def create_node_claims(
        self, claims: List[SchedulingNodeClaim], options: Optional[LaunchOptions] = None
    ) -> Tuple[List[str], List[str]]:
        options = options or LaunchOptions()
        names: List[str] = []
        errors: List[str] = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, min(len(claims), 16))) as ex:
            futures = {ex.submit(self.create, c, options): c for c in claims}
            for fut in concurrent.futures.as_completed(futures):
                try:
                    names.append(fut.result())
                except Exception as e:  # noqa: BLE001 — collected like multierr
                    errors.append(f"creating node claim, {e}")
        return names, errors

    def create(self, claim: SchedulingNodeClaim, options: Optional[LaunchOptions] = None) -> str:
        options = options or LaunchOptions()
        latest = self.kube_client.get("NodePool", claim.nodepool_name)
        if latest is None:
            raise LimitsExceededError(f"nodepool {claim.nodepool_name} not found")
        err = self._limits_exceeded(latest)
        if err:
            raise LimitsExceededError(err)
        node_claim = claim.to_node_claim(latest)
        self.kube_client.create(node_claim)
        # correlation: which stored claim came from this scheduling claim
        # (greedy claims lose the association otherwise)
        claim.created_claim_name = node_claim.name
        if self.metrics is not None:
            self.metrics.nodeclaims_created.inc(
                reason=options.reason, nodepool=claim.nodepool_name
            )
        if options.record_pod_nomination and self.recorder is not None:
            from ..events import events as ev

            for pod in claim.pods:
                self.recorder.publish(ev.nominate_pod(pod, node_claim.name))
        return node_claim.name

    def create_from_plan(self, plan, options: Optional[LaunchOptions] = None) -> str:
        """Stamp a NodeClaim CR from a batched-solve NodePlan: instance type,
        zone and capacity type are already decided, so the claim pins them."""
        from ..apis.nodeclaim import NodeClaimResources, NodeClaimSpec
        from ..kube.objects import NodeSelectorRequirement, OwnerReference, next_name

        options = options or LaunchOptions()
        nodepool = self.kube_client.get("NodePool", plan.nodepool_name)
        if nodepool is None:
            raise LimitsExceededError(f"nodepool {plan.nodepool_name} not found")
        err = self._limits_exceeded(nodepool)
        if err:
            raise LimitsExceededError(err)
        template = nodepool.spec.template
        nc = NodeClaim()
        nc.metadata.name = next_name(plan.nodepool_name)
        nc.metadata.labels = {
            **template.metadata.labels,
            wk.NODEPOOL_LABEL_KEY: plan.nodepool_name,
        }
        nc.metadata.annotations = {
            **template.metadata.annotations,
            wk.NODEPOOL_HASH_ANNOTATION_KEY: nodepool.static_hash(),
        }
        nc.spec = NodeClaimSpec(
            taints=list(template.taints),
            startup_taints=list(template.startup_taints),
            requirements=(
                [
                    NodeSelectorRequirement(wk.LABEL_INSTANCE_TYPE, "In", [plan.instance_type.name]),
                    NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, "In", [plan.zone]),
                    NodeSelectorRequirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [plan.capacity_type]),
                ]
                # the solver's merged (template ∩ pods) requirements —
                # the launched node must carry every label the member
                # pods select on (nodeclaimtemplate.go:55 stamping)
                + [
                    r.to_node_selector_requirement()
                    for r in (plan.requirements.values() if plan.requirements else [])
                    if r.key
                    not in (
                        wk.LABEL_INSTANCE_TYPE,
                        wk.LABEL_TOPOLOGY_ZONE,
                        wk.CAPACITY_TYPE_LABEL_KEY,
                    )
                ]
            ),
            kubelet=template.kubelet,
            node_class_ref=template.node_class_ref,
        )
        nc.spec.resources = NodeClaimResources(requests=dict(plan.requests or {}))
        nc.metadata.owner_references = [
            OwnerReference(
                api_version="karpenter.sh/v1beta1",
                kind="NodePool",
                name=nodepool.name,
                uid=nodepool.uid,
                block_owner_deletion=True,
            )
        ]
        self.kube_client.create(nc)
        if self.metrics is not None:
            self.metrics.nodeclaims_created.inc(
                reason=options.reason, nodepool=plan.nodepool_name
            )
        if options.record_pod_nomination and self.recorder is not None:
            from ..events import events as ev

            for pod in getattr(plan, "pods", None) or []:
                self.recorder.publish(ev.nominate_pod(pod, nc.metadata.name))
        return nc.metadata.name

    @staticmethod
    def _limits_exceeded(nodepool) -> Optional[str]:
        """Limits.ExceededBy(status.resources) (nodepool.go:127 Limits)."""
        for name, limit in nodepool.spec.limits.items():
            usage = nodepool.status.resources.get(name, 0)
            if usage > limit:
                return f"limit exceeded for resource {name}"
        return None
