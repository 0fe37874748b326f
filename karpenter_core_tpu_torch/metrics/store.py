"""Dedup-publishing metrics store + scrapers (ref pkg/metrics/store.go,
pkg/controllers/metrics/{node,nodepool,pod}): the port's copy of
``karpenter_core_tpu/metrics/store.py``."""

from __future__ import annotations

from typing import Dict, Set

from ..kube.quantity import NANO
from ..scheduling import resources
from .registry import Metrics


class MetricsStore:
    """store.go:32: tracks which label sets were published so stale series
    are deleted when objects disappear."""

    def __init__(self, metrics: Metrics):
        self.metrics = metrics
        self._published_nodes: Set[str] = set()
        self._published_pools: Set[str] = set()
        self._published_pods: Set[tuple] = set()
        self._startup_observed: Set[tuple] = set()

    # -- node scraper (metrics/node/controller.go:48-96) -------------------

    def scrape_nodes(self, cluster) -> None:
        seen = set()

        def visit(sn) -> bool:
            name = sn.name()
            seen.add(name)
            for res, qty in sn.allocatable().items():
                self.metrics.node_allocatable.set(qty / NANO, node=name, resource=res)
            for res, qty in sn.pod_request_total().items():
                self.metrics.node_pod_requests.set(qty / NANO, node=name, resource=res)
            for res, qty in sn.pod_limit_total().items():
                self.metrics.node_pod_limits.set(qty / NANO, node=name, resource=res)
            for res, qty in sn.daemonset_request_total().items():
                self.metrics.node_daemon_requests.set(qty / NANO, node=name, resource=res)
            for res, qty in sn.daemonset_limit_total().items():
                self.metrics.node_daemon_limits.set(qty / NANO, node=name, resource=res)
            overhead = resources.subtract(sn.capacity(), sn.allocatable())
            for res, qty in overhead.items():
                self.metrics.node_system_overhead.set(qty / NANO, node=name, resource=res)
            return True

        cluster.for_each_node(visit)
        for stale in self._published_nodes - seen:
            for gauge in (
                self.metrics.node_allocatable,
                self.metrics.node_pod_requests,
                self.metrics.node_pod_limits,
                self.metrics.node_daemon_requests,
                self.metrics.node_daemon_limits,
                self.metrics.node_system_overhead,
            ):
                for key in [k for k in gauge.values if ("node", stale) in k]:
                    gauge.values.pop(key, None)
        self._published_nodes = seen

    # -- nodepool scraper (metrics/nodepool/controller.go:49-64) -----------

    def scrape_nodepools(self, kube_client) -> None:
        seen = set()
        for np_ in kube_client.list("NodePool"):
            seen.add(np_.name)
            for res, qty in np_.spec.limits.items():
                self.metrics.nodepool_limit.set(qty / NANO, nodepool=np_.name, resource=res)
            for res, qty in np_.status.resources.items():
                self.metrics.nodepool_usage.set(qty / NANO, nodepool=np_.name, resource=res)
        for stale in self._published_pools - seen:
            for gauge in (self.metrics.nodepool_limit, self.metrics.nodepool_usage):
                for key in [k for k in gauge.values if ("nodepool", stale) in k]:
                    gauge.values.pop(key, None)
        self._published_pools = seen

    # -- pod scraper (metrics/pod/controller.go:59-71) ---------------------

    def scrape_pods(self, kube_client) -> None:
        seen = set()
        values = self.metrics.pod_state.values
        # each pod's series, by (namespace, name), from one pass over the
        # gauge: the reference scans the whole gauge once per pod, which is
        # quadratic in the pods (minutes a scrape at tens of thousands)
        series: Dict[tuple, list] = {}
        for k in list(values):
            labels = dict(k)
            series.setdefault((labels.get("namespace"), labels.get("name")), []).append(k)
        for pod in kube_client.list("Pod"):
            key = (pod.namespace, pod.name)
            seen.add(key)
            # a pod is in exactly one phase: drop the series for any phase
            # it moved out of, or a Pending→Running pod reports both
            for k in series.get(key, ()):
                if ("phase", pod.status.phase) not in k:
                    values.pop(k, None)
            self.metrics.pod_state.set(
                1.0, name=pod.name, namespace=pod.namespace, phase=pod.status.phase
            )
            # startup = creation → Running, observed once per pod
            # (metrics/pod/controller.go:63-71 pod_startup_time_seconds)
            if (
                pod.status.phase == "Running"
                and pod.status.start_time is not None
                and key not in self._startup_observed
            ):
                self._startup_observed.add(key)
                self.metrics.pod_startup_time.observe(
                    max(0.0, pod.status.start_time - pod.metadata.creation_timestamp)
                )
        for stale in self._published_pods - seen:
            for k in series.get(stale, ()):
                values.pop(k, None)
        self._published_pods = seen
        # prune so deleted pods don't leak, and a recreated same-name pod
        # gets its startup observed again
        self._startup_observed &= seen
