"""Operator: the composition root (ref pkg/operator/operator.go +
pkg/controllers/controllers.go:47-82 — the single place listing every
controller).

The port's copy of ``karpenter_core_tpu/operator/operator.py``. The
operator runs on one ``device`` (None: the card; a machine without one
raises): the provisioner's batched solves, the disruption controller's
screens and simulations and the serving pipeline's schedulers all run
there, every controller thread on the default stream."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..apis.validation import install_admission
from ..cloudprovider.metrics import MetricsDecorator
from ..disruption import DisruptionController, NodeClaimDisruptionController, OrchestrationQueue
from ..events import Recorder
from ..kube.client import KubeClient
from ..lifecycle import (
    ConsistencyController,
    EvictionQueue,
    LeaseGarbageCollectionController,
    NodeClaimGarbageCollectionController,
    NodeClaimLifecycleController,
    NodeClaimTerminationController,
    NodePoolCounterController,
    NodePoolHashController,
    NodeTerminationController,
    Terminator,
)
from ..metrics import Metrics, MetricsStore, Registry
from ..provisioning import Batcher, Provisioner
from ..solver.backend import resolve_device
from ..state.cluster import Cluster
from ..state.informers import Informers
from .controller import SingletonController
from .logging import new_logger, watch_config_logging
from .options import Options


class Operator:
    """operator.go:80 NewOperator / WithControllers / Start, collapsed into
    one object (we have no provider-binary split)."""

    def __init__(
        self,
        cloud_provider,
        kube_client: Optional[KubeClient] = None,
        options: Optional[Options] = None,
        # analysis: allow-clock(fans to lease/stamping controllers that compare persisted wall-clock stamps)
        clock: Callable[[], float] = time.time,
        device=None,
        validation_sleep: Optional[Callable[[float], None]] = None,
    ):
        # the card unless the caller names the CPU; resolved first, so a
        # machine without a card raises before anything is built
        self.device = resolve_device(device)
        self.options = options or Options.from_env()
        self.logger = new_logger(self.options.log_level)
        self.kube_client = kube_client or KubeClient(clock=clock)
        # live log-level from the config-logging ConfigMap (logging.go:47-167)
        self._log_config_unsub = watch_config_logging(
            self.kube_client, self.logger, namespace=self.options.system_namespace
        )
        if not self.options.disable_webhook:
            install_admission(self.kube_client)
        self.registry = Registry()
        self.metrics = Metrics(self.registry)
        self.cloud_provider = MetricsDecorator(cloud_provider, self.metrics)
        self.recorder = Recorder(self.kube_client, clock=clock)
        self.clock = clock

        self.cluster = Cluster(self.kube_client, self.cloud_provider, clock=clock)
        self.informers = Informers(self.kube_client, self.cluster)
        self.batcher = Batcher(
            idle_seconds=self.options.batch_idle_duration,
            max_seconds=self.options.batch_max_duration,
            clock=clock,
        )
        self.provisioner = Provisioner(
            self.kube_client,
            self.cloud_provider,
            self.cluster,
            recorder=self.recorder,
            batcher=self.batcher,
            use_tpu_solver=self.options.use_tpu_solver,
            metrics=self.metrics,
            device=self.device,
        )
        self.eviction_queue = EvictionQueue(self.kube_client, self.recorder)
        self.terminator = Terminator(self.kube_client, self.eviction_queue, clock=clock)
        self.orchestration_queue = OrchestrationQueue(
            self.kube_client, self.cluster, self.recorder, clock, self.metrics
        )
        self.nodeclaim_lifecycle = NodeClaimLifecycleController(
            self.kube_client, self.cloud_provider, self.recorder, clock, self.metrics
        )
        self.nodeclaim_termination = NodeClaimTerminationController(
            self.kube_client, self.cloud_provider, self.metrics
        )
        self.node_termination = NodeTerminationController(
            self.kube_client, self.cloud_provider, self.terminator, self.recorder, self.metrics
        )
        self.nodeclaim_gc = NodeClaimGarbageCollectionController(
            self.kube_client, self.cloud_provider, clock
        )
        self.nodeclaim_disruption = NodeClaimDisruptionController(
            self.kube_client,
            self.cloud_provider,
            self.cluster,
            clock,
            drift_enabled=self.options.feature_gates.drift,
        )
        self.disruption = DisruptionController(
            self.kube_client,
            self.cluster,
            self.provisioner,
            self.cloud_provider,
            recorder=self.recorder,
            clock=clock,
            queue=self.orchestration_queue,
            # consolidation's validation wait (None: none); a caller on a
            # stepped clock passes one that advances it
            validation_sleep=validation_sleep,
            use_tpu_screen=self.options.tpu_consolidation_screen,
            metrics=self.metrics,
        )
        self.consistency = ConsistencyController(self.kube_client, self.recorder, metrics=self.metrics)
        self.nodepool_counter = NodePoolCounterController(self.kube_client, self.cluster)
        self.nodepool_hash = NodePoolHashController(self.kube_client)
        self.lease_gc = LeaseGarbageCollectionController(self.kube_client)
        self.metrics_store = MetricsStore(self.metrics)
        self.elector = None
        self.http = None
        # staged async serving pipeline (serving/pipeline.py): when
        # enabled it owns provisioning — the tick-shaped provisioner
        # controller below degrades to a no-op safety net
        self.serving = None
        if self.options.use_serving_pipeline:
            from ..serving import PipelineConfig, ServingPipeline

            self.serving = ServingPipeline(
                self.provisioner,
                metrics=self.metrics,
                config=PipelineConfig(
                    idle_seconds=self.options.batch_idle_duration,
                    max_seconds=self.options.batch_max_duration,
                ),
                # continuous disruption (PipelineConfig.disrupt_every > 0):
                # the pass runs as a plan-thread stage; the 10 s singleton
                # below stays as the safety net either way
                disruption=self.disruption,
            )

        # the reconcile surface, mirroring controllers.go:47-82
        self.controllers: List[SingletonController] = [
            SingletonController("provisioner", self._reconcile_provisioner, self.metrics, self.logger, gate=self._leading, period=10.0),
            SingletonController("disruption", self._reconcile_disruption, self.metrics, self.logger, gate=self._leading, period=10.0),
            SingletonController("disruption.queue", self._reconcile_queue, self.metrics, self.logger, gate=self._leading, period=1.0),
            SingletonController("nodeclaim.lifecycle", self._reconcile_lifecycle, self.metrics, self.logger, gate=self._leading, period=2.0),
            SingletonController("nodeclaim.termination", self._reconcile_nc_termination, self.metrics, self.logger, gate=self._leading, period=2.0),
            SingletonController("node.termination", self._reconcile_node_termination, self.metrics, self.logger, gate=self._leading, period=2.0),
            SingletonController("nodeclaim.garbagecollection", lambda: self._none(self.nodeclaim_gc.reconcile), self.metrics, self.logger, gate=self._leading, period=120.0),
            SingletonController("nodeclaim.disruption", lambda: self._none(self.nodeclaim_disruption.reconcile_all), self.metrics, self.logger, gate=self._leading, period=10.0),
            SingletonController("nodeclaim.consistency", lambda: self._none(self.consistency.reconcile_all), self.metrics, self.logger, gate=self._leading, period=600.0),
            SingletonController("nodepool.counter", lambda: self._none(self.nodepool_counter.reconcile_all), self.metrics, self.logger, gate=self._leading, period=10.0),
            SingletonController("nodepool.hash", lambda: self._none(self.nodepool_hash.reconcile_all), self.metrics, self.logger, gate=self._leading, period=10.0),
            SingletonController("lease.garbagecollection", lambda: self._none(self.lease_gc.reconcile), self.metrics, self.logger, gate=self._leading, period=120.0),
            SingletonController("metrics.scraper", self._reconcile_metrics, self.metrics, self.logger, gate=self._leading, period=10.0),
            SingletonController("eviction.queue", lambda: self._none(self.eviction_queue.reconcile), self.metrics, self.logger, gate=self._leading, period=1.0),
        ]
        self._started = False
        self._batching = False

    def _leading(self) -> bool:
        """Leader gate for every controller: standalone (no election) or
        the current Lease holder. Followers keep their loops ticking but
        skip reconciles — the reference gets this from controller-
        runtime's manager (operator.go:121-124)."""
        return self.elector is None or self.elector.is_leader()

    # -- reconcile wrappers -------------------------------------------------

    @staticmethod
    def _none(fn: Callable) -> None:
        fn()
        return None

    def _reconcile_provisioner(self) -> None:
        if self.serving is not None:
            return None  # the serving pipeline owns provisioning ticks
        with self.metrics.scheduling_duration.time():
            _, reason = self.provisioner.reconcile(wait_for_batch=self._batching)
        if reason:
            self.logger.with_(controller="provisioner").info("%s", reason)
        return None

    def _reconcile_disruption(self) -> None:
        if self.serving is not None and self.serving.config.disrupt_every > 0:
            # the serving pipeline owns disruption passes (plan-thread
            # stage): running them here too would race its mutations
            return None
        self.disruption.reconcile()
        return None

    def _reconcile_queue(self) -> None:
        self.orchestration_queue.reconcile()
        return None

    def _reconcile_lifecycle(self) -> None:
        self.nodeclaim_lifecycle.reconcile_all()
        return None

    def _reconcile_nc_termination(self) -> None:
        self.nodeclaim_termination.reconcile_all()
        return None

    def _reconcile_node_termination(self) -> None:
        self.node_termination.reconcile_all()
        return None

    def _reconcile_metrics(self) -> None:
        self.metrics_store.scrape_nodes(self.cluster)
        self.metrics_store.scrape_nodepools(self.kube_client)
        self.metrics_store.scrape_pods(self.kube_client)
        return None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """operator.go:203 Start: informers first (cache sync), then the
        operational surface and election, then all controllers."""
        self.informers.start()
        if self.options.enable_leader_election and self.elector is None:
            from .leaderelection import LeaderElector

            self.elector = LeaderElector(
                self.kube_client,
                namespace=self.options.system_namespace,
                clock=self.clock,
                on_started_leading=lambda: self.logger.info("became leader"),
                on_stopped_leading=lambda: self.logger.info("lost leadership"),
            )
            self.elector.start()
        if self.http is None:
            from .server import OperationalServer

            from ..solver import stats as solver_stats

            def _live_solver():
                cached = getattr(self.provisioner, "_tpu_solver", None)
                return cached[1] if cached is not None else None

            self.http = OperationalServer(
                self.registry,
                ready_check=self.healthy,
                metrics_port=self.options.metrics_port,
                probe_port=self.options.health_probe_port,
                enable_profiling=self.options.enable_profiling,
                logger=self.logger,
                serving_state=(
                    self.serving.debug_state if self.serving is not None else None
                ),
                solve_stats=lambda: solver_stats.route_payload(
                    _live_solver, lambda: getattr(self, "disruption", None)
                ),
            )
            self.http.start()
        # start/stop symmetry: re-register the config-logging watch a
        # previous stop() tore down
        if self._log_config_unsub is None:
            self._log_config_unsub = watch_config_logging(
                self.kube_client, self.logger, namespace=self.options.system_namespace
            )
        # pod-watch → batcher trigger, the provisioning trigger controller
        # (provisioning/controller.go:58)
        from ..utils import pod as podutils

        if self.serving is not None:
            if self.elector is not None:
                # a follower's pipeline holds its ticks (the reference's
                # runs ungated: ROADMAP C14); no write guard, which would
                # sit on a client other operators may share in-process
                self.serving.attach_leader_gate(self._leading, guard_writes=False)
            # the pipeline's ingest stage replaces the trigger controller
            self.serving.attach_watch()
            self.serving.start()
            self._pod_watch_unsub = None
        else:

            def on_pod(event, pod):
                if event != "DELETED" and podutils.is_provisionable(pod):
                    self.provisioner.trigger()

            self._pod_watch_unsub = self.kube_client.watch("Pod", on_pod)
        self._batching = True
        for c in self.controllers:
            c.start()
        self._started = True

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()
        if self.serving is not None:
            self.serving.stop()
            self.serving.detach_leader_gate()
        unsub = getattr(self, "_pod_watch_unsub", None)
        if unsub is not None:
            unsub()
        if self._log_config_unsub is not None:
            self._log_config_unsub()
            self._log_config_unsub = None
        if self.elector is not None:
            self.elector.stop()
            self.elector = None
        if self.http is not None:
            self.http.stop()
            self.http = None
        self.informers.stop()
        self._started = False
        self._batching = False

    def reconcile_all_once(self) -> None:
        """Synchronous single pass over every controller (test/simulation
        driver)."""
        if not self._started:
            self.informers.start()
            self._started = True
        for c in self.controllers:
            c.reconcile_once()

    def healthy(self) -> bool:
        return self.cluster.synced()

    def metrics_text(self) -> str:
        return self.registry.expose()
