"""Prometheus-compatible metrics (ref pkg/metrics/metrics.go,
constants.go): counters/gauges/histograms with label sets, exposable in
text format. The port's copy of ``karpenter_core_tpu/metrics/registry.py``:
the same families, help texts, labels and buckets, so the ``/metrics``
text of the same observations is byte-equal to the reference's.

The port's solve feeds ``solver_duration``, ``solver_device_duration``,
``solver_phase_duration``, the cache counters, ``solver_route_pods``,
``solver_lp_jobs`` and ``solver_lp_branches``; the provisioner feeds
``nodeclaims_created`` and ``solver_parity``; the device plane
(tracing/deviceplane.py) feeds ``xla_compiles`` (kernel library loads,
by kernel and cause), ``transfer_bytes`` and ``hbm_high_water`` (the
card's allocator peak; absent off the card). ``shard_padding_waste``
belongs to the sharded solve (the reference's ``solver/sharding.py``),
which the port does not have yet: it stays unobserved, and its
exposition carries no sample."""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

NAMESPACE = "karpenter"

# duration buckets (constants.go:24-60 DurationBuckets)
DURATION_BUCKETS = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600,
]


# decision-latency buckets in ms, comma separated (the reference's
# KARPENTER_TPU_LATENCY_BUCKETS_MS, unset by default)
LATENCY_BUCKETS_MS = ""


def latency_buckets() -> List[float]:
    """Decision-latency histogram buckets: ``LATENCY_BUCKETS_MS`` is a
    comma-separated millisecond list (e.g. "1,5,10,50,100,500,1000").
    Buckets are fixed at Histogram construction — the constant is read
    when ``Metrics`` is built, not per observe. Empty/invalid → the
    reference's DurationBuckets."""
    raw = LATENCY_BUCKETS_MS
    if not raw.strip():
        return DURATION_BUCKETS
    try:
        ms = sorted({float(part) for part in raw.split(",") if part.strip()})
    except ValueError:
        return DURATION_BUCKETS
    if not ms or any(b <= 0 for b in ms):
        return DURATION_BUCKETS
    return [b / 1000.0 for b in ms]


def _labels_key(labels: Dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    def __init__(self, name: str, help_: str = "", label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.values: Dict[tuple, float] = {}
        self._mu = threading.Lock()

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._mu:
            self.values[key] = self.values.get(key, 0.0) + value

    def get(self, **labels) -> float:
        with self._mu:
            return self.values.get(_labels_key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}", f"# TYPE {self.name} counter"]
        with self._mu:
            items = sorted(self.values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str = "", label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.values: Dict[tuple, float] = {}
        self._mu = threading.Lock()

    def set(self, value: float, **labels) -> None:
        with self._mu:
            self.values[_labels_key(labels)] = value

    def get(self, **labels) -> Optional[float]:
        with self._mu:
            return self.values.get(_labels_key(labels))

    def delete(self, **labels) -> None:
        with self._mu:
            self.values.pop(_labels_key(labels), None)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}", f"# TYPE {self.name} gauge"]
        with self._mu:
            items = sorted(self.values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets: Optional[List[float]] = None, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.buckets = buckets or DURATION_BUCKETS
        self.label_names = tuple(label_names)
        self.counts: Dict[tuple, List[int]] = {}
        self.sums: Dict[tuple, float] = {}
        self.totals: Dict[tuple, int] = {}
        # last exemplar per (labelset, bucket): OpenMetrics-style trace
        # anchors ("which trace_id filled this latency bucket last") —
        # served via /debug/decisions, NOT the text exposition (classic
        # Prometheus text format has no exemplar syntax; emitting it
        # would fail the textcheck gate and ordinary scrapers)
        self._exemplars: Dict[tuple, Dict[str, Tuple[str, float, float]]] = {}
        self._mu = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None, **labels) -> None:
        key = _labels_key(labels)
        with self._mu:
            if key not in self.counts:
                self.counts[key] = [0] * len(self.buckets)
                self.sums[key] = 0.0
                self.totals[key] = 0
            bucket = "+Inf"
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[key][i] += 1
                    if bucket == "+Inf":
                        bucket = str(b)
            self.sums[key] += value
            self.totals[key] += 1
            if exemplar is not None:
                self._exemplars.setdefault(key, {})[bucket] = (
                    str(exemplar),
                    value,
                    time.time(),
                )

    def exemplars(self, **labels) -> Dict[str, Tuple[str, float, float]]:
        """{bucket le → (exemplar, value, wall ts)} for one label set."""
        with self._mu:
            return dict(self._exemplars.get(_labels_key(labels), {}))

    def time(self, **labels):
        """Context manager: `with h.time(): ...` (metrics.Measure helper)."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.start = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.start, **labels)
                return False

        return _Timer()

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}", f"# TYPE {self.name} histogram"]
        with self._mu:
            snapshot = sorted(self.counts)
            counts = {k: list(v) for k, v in self.counts.items()}
            sums = dict(self.sums)
            totals = dict(self.totals)
        for key in snapshot:
            for i, b in enumerate(self.buckets):
                out.append(f'{self.name}_bucket{_fmt_labels(key, le=str(b))} {counts[key][i]}')
            out.append(f'{self.name}_bucket{_fmt_labels(key, le="+Inf")} {totals[key]}')
            out.append(f"{self.name}_sum{_fmt_labels(key)} {sums[key]}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {totals[key]}")
        return out


def _escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline) — label values carry user-controlled strings (node names,
    error reasons)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format (backslash, newline)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(key: tuple, **extra) -> str:
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class _TracerOrphanCollector:
    """Registry bridge for the tracer's process-global orphan-span
    counter (tracing/tracer.py): spans born on a thread with no active
    root vanish from every trace — with cross-thread context
    propagation in place the count should be zero, and the serving/
    fleet identity tests assert it. Read-only: the value lives in the
    tracer so instrumented code never needs a Metrics handle."""

    name = f"{NAMESPACE}_tpu_tracer_orphan_spans_total"
    help = (
        "Spans dropped because no trace was active on their thread "
        "(attribution bug once TraceContext propagation covers every lane)"
    )

    def collect(self) -> List[str]:
        from ..tracing.tracer import orphan_spans

        return [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} counter",
            f"{self.name} {float(orphan_spans())}",
        ]


class Registry:
    def __init__(self) -> None:
        self.metrics: List[object] = []
        self._mu = threading.Lock()

    def register(self, metric):
        with self._mu:
            self.metrics.append(metric)
        return metric

    def counter(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Counter:
        return self.register(Counter(name, help_, labels))

    def gauge(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self.register(Gauge(name, help_, labels))

    def histogram(self, name: str, help_: str = "", buckets=None, labels: Iterable[str] = ()) -> Histogram:
        return self.register(Histogram(name, help_, buckets, labels))

    def expose(self) -> str:
        """Prometheus text exposition format (the /metrics payload)."""
        with self._mu:
            metrics = list(self.metrics)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


class Metrics:
    """The reference's metric set (pkg/metrics/metrics.go:29-135 +
    per-package metrics), bound to one registry."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        ns = NAMESPACE
        self.nodeclaims_created = r.counter(f"{ns}_nodeclaims_created", "NodeClaims created", ["reason", "nodepool"])
        self.nodeclaims_terminated = r.counter(f"{ns}_nodeclaims_terminated", "NodeClaims terminated", ["reason", "nodepool"])
        self.nodeclaims_launched = r.counter(f"{ns}_nodeclaims_launched", "NodeClaims launched", ["nodepool"])
        self.nodeclaims_registered = r.counter(f"{ns}_nodeclaims_registered", "NodeClaims registered", ["nodepool"])
        self.nodeclaims_initialized = r.counter(f"{ns}_nodeclaims_initialized", "NodeClaims initialized", ["nodepool"])
        self.nodeclaims_disrupted = r.counter(f"{ns}_nodeclaims_disrupted", "NodeClaims disrupted", ["method"])
        self.nodeclaims_drifted = r.counter(f"{ns}_nodeclaims_drifted", "NodeClaims drifted", ["type"])
        self.nodes_created = r.counter(f"{ns}_nodes_created", "Nodes created", ["nodepool"])
        self.nodes_terminated = r.counter(f"{ns}_nodes_terminated", "Nodes terminated", ["nodepool"])
        self.scheduling_duration = r.histogram(
            f"{ns}_provisioner_scheduling_duration_seconds", "Scheduling duration"
        )
        self.simulation_duration = r.histogram(
            f"{ns}_provisioner_scheduling_simulation_duration_seconds", "Simulation duration"
        )
        self.disruption_evaluation_duration = r.histogram(
            f"{ns}_disruption_evaluation_duration_seconds", "Disruption evaluation duration", labels=["method"]
        )
        self.disruption_actions = r.counter(
            f"{ns}_disruption_actions_performed_total", "Disruption actions", ["method", "action"]
        )
        self.eligible_nodes = r.gauge(
            f"{ns}_disruption_eligible_nodes", "Disruption-eligible nodes", ["method"]
        )
        self.disruption_subsets = r.counter(
            f"{ns}_disruption_subsets_total",
            "Candidate node subsets processed by the disruption engine, by stage (screened | verified)",
            ["stage"],
        )
        self.consistency_errors = r.counter(f"{ns}_nodeclaims_consistency_errors", "Consistency errors")
        self.cloudprovider_duration = r.histogram(
            f"{ns}_cloudprovider_duration_seconds", "Cloud provider method duration", labels=["method", "provider"]
        )
        self.cloudprovider_errors = r.counter(
            f"{ns}_cloudprovider_errors_total", "Cloud provider errors", ["method", "provider"]
        )
        self.solver_duration = r.histogram(
            f"{ns}_tpu_solver_duration_seconds", "TPU solve wall time"
        )
        self.solver_parity = r.gauge(
            f"{ns}_tpu_solver_packing_parity", "TPU/oracle packing parity ratio"
        )
        self.solver_phase_duration = r.histogram(
            f"{ns}_tpu_solver_phase_duration_seconds",
            "TPU solve phase wall time, per tracing span (coarse: existing_pack/encode/pack/affinity_postpass; fine: encode.*/pack.*/device_wait/... — see tracing/)",
            labels=["phase"],
        )
        self.solver_device_duration = r.histogram(
            f"{ns}_tpu_solver_device_duration_seconds",
            "Device-attributable time per solve (dispatch + transfer + blocked-on-device)",
        )
        # steady-state incremental solve (solver/incremental.py): cross-
        # solve cache traffic, labeled by cache layer (catalog | compat |
        # route | job | merge | seeds | warmstart)
        self.solver_cache_hits = r.counter(
            f"{ns}_tpu_solver_cache_hits", "Cross-solve solver cache hits", ["cache"]
        )
        self.solver_cache_misses = r.counter(
            f"{ns}_tpu_solver_cache_misses", "Cross-solve solver cache misses", ["cache"]
        )
        self.solver_cache_evictions = r.counter(
            f"{ns}_tpu_solver_cache_evictions",
            "Cross-solve solver cache evictions (LRU caps, env-tunable)",
            ["cache"],
        )
        # plan-quality pack backends (solver/backends/): per pack job,
        # whether the LP-relaxation candidate beat FFD on plan cost
        # (lp_won) or the guard kept the FFD partition — split by
        # whether the optimality tier ran before the rejection:
        # ffd_kept_cold = no refinement/branching attempted,
        # ffd_kept_refined = FFD still won after the tier spent its
        # budget (legacy rounds without the split report ffd_kept)
        self.solver_lp_jobs = r.counter(
            f"{ns}_tpu_solver_lp_jobs",
            "Pack jobs through the LP-relaxation backend, by guard outcome "
            "(lp_won | ffd_kept_cold | ffd_kept_refined)",
            ["outcome"],
        )
        # restricted branch-and-bound: every considered
        # branch is accounted — pruned by its dual bound without
        # packing, explored (packed, did not beat the incumbent), or
        # won (became the incumbent). Pruning is never silent.
        self.solver_lp_branches = r.counter(
            f"{ns}_tpu_solver_lp_branches",
            "LP branch-and-bound branches, by outcome (pruned | explored | won)",
            ["outcome"],
        )
        # constraint tensorization: per-solve pod routing
        # split — how many pods ran on the tensor path vs parked
        # (post-pack affinity) vs the greedy-oracle fallback; the
        # oracle-routed share is the gated residue
        self.solver_route_pods = r.counter(
            f"{ns}_tpu_solver_route_pods",
            "Pods per solve by constraint route (tensor | parked | oracle)",
            ["route"],
        )
        # pod-axis sharded mega-solves (solver/sharding.py): mesh
        # padding is never silent — wasted slot fraction of the last
        # solve's pod-chunk padding and type-shard padding
        self.shard_padding_waste = r.gauge(
            f"{ns}_tpu_shard_padding_waste",
            "Padded-slot fraction wasted by the last sharded solve's mesh tiling (axis = pods | types)",
            ["axis"],
        )
        # warm-state persistence (solver/warmstore.py): per-plane
        # restore outcomes — every restored entry re-anchored against
        # the live world, every witness-failed entry dropped and
        # counted (restores are never silent)
        self.warmstore_restored = r.counter(
            f"{ns}_tpu_warmstore_restored_entries",
            "Warm-state snapshot entries restored per cache plane (re-anchored against the live catalog/cluster world)",
            ["plane"],
        )
        self.warmstore_dropped = r.counter(
            f"{ns}_tpu_warmstore_dropped_entries",
            "Warm-state snapshot entries dropped per cache plane (version/contract/fingerprint witness mismatch — never trusted)",
            ["plane"],
        )
        # device plane (tracing/deviceplane.py; in the port a "compile" is
        # a kernel library's load, built first where _build/ lacks it):
        # XLA compile events attributed per jit entry point and cause
        # (first | new_shape | new_config — trace_id exemplars ride
        # /debug/device and the stats device block, never the classic
        # text exposition), H2D/D2H transfer bytes per solve phase, and
        # the device-memory high-water mark of the last polled solve
        self.xla_compiles = r.counter(
            f"{ns}_tpu_xla_compiles_total",
            "XLA compiles observed at registered jit entry points, by function and cause (first | new_shape | new_config | prewarm_replay); trace_id exemplars via /debug/device",
            ["fn", "cause"],
        )
        self.transfer_bytes = r.counter(
            f"{ns}_tpu_solver_transfer_bytes_total",
            "Host<->device bytes moved by solver dispatches, by direction (h2d | d2h) and solve phase",
            ["direction", "phase"],
        )
        self.hbm_high_water = r.gauge(
            f"{ns}_tpu_hbm_high_water_bytes",
            "Device-memory high-water mark polled at the end of the last solve (peak_bytes_in_use; absent off-accelerator)",
        )
        # serving pipeline (serving/pipeline.py): the decision-latency
        # SLO (pod-pending → plan emitted), per-stage durations, and
        # stage-queue depths (backpressure visibility)
        self.serving_decision_latency = r.histogram(
            f"{ns}_serving_decision_latency_seconds",
            "Pod-pending to plan-emitted decision latency (serving SLO); buckets env-tunable via KARPENTER_TPU_LATENCY_BUCKETS_MS; exemplar trace_ids per bucket via /debug/decisions",
            buckets=latency_buckets(),
        )
        # decision telemetry plane (tracing/flightrec.py): SLO burn rate
        # (fraction of decisions over KARPENTER_TPU_SLO_TARGET_MS per
        # trailing window) and the tracer's orphan-span counter
        self.decision_slo_burn = r.gauge(
            f"{ns}_tpu_decision_slo_burn_rate",
            "Fraction of decisions over the latency SLO target in the trailing window (1m | 10m)",
            ["window"],
        )
        # real-apiserver watch loop (kube/restclient.py): relist and
        # retry traffic under 410 storms / stream drops — attached via
        # RestKubeClient.attach_watch_metrics (kube/ stays registry-
        # agnostic); retries are never silent
        self.watch_relists = r.counter(
            f"{ns}_tpu_watch_relists_total",
            "Watch relists (initial list + 410/ERROR recovery), by kind",
            ["kind"],
        )
        self.watch_errors = r.counter(
            f"{ns}_tpu_watch_errors_total",
            "Watch stream errors, by kind and reason (410 | http | stream | error_event)",
            ["kind", "reason"],
        )
        self.watch_backoff_seconds = r.counter(
            f"{ns}_tpu_watch_backoff_seconds_total",
            "Seconds of capped+jittered watch-retry backoff slept, by kind (KARPENTER_TPU_WATCH_BACKOFF_{BASE,MAX}_MS)",
            ["kind"],
        )
        r.register(_TracerOrphanCollector())
        self.serving_stage_duration = r.histogram(
            f"{ns}_serving_stage_duration_seconds",
            "Serving pipeline stage wall time (batch_wait | plan)",
            labels=["stage"],
        )
        self.serving_queue_depth = r.gauge(
            f"{ns}_serving_queue_depth",
            "Serving pipeline stage-queue depth (caps are env-tunable, KARPENTER_TPU_SERVING_*_CAP)",
            ["stage"],
        )
        # fleet solver (fleet/): per-tenant solve traffic (tenant label
        # cardinality-capped, KARPENTER_TPU_FLEET_TENANT_LABELS — excess
        # tenants collapse to "_other"), mega-dispatch shape, and the
        # deficit-round-robin fairness pressure
        self.fleet_solves = r.counter(
            f"{ns}_tpu_fleet_solves_total",
            "Per-tenant fleet solves, by engine (batched | solo); tenant label capped",
            ["tenant", "engine"],
        )
        self.fleet_pods = r.counter(
            f"{ns}_tpu_fleet_pods_total",
            "Pods decided per tenant by the fleet engine; tenant label capped",
            ["tenant"],
        )
        self.fleet_batch_occupancy = r.gauge(
            f"{ns}_tpu_fleet_batch_occupancy",
            "Tenant pack calls coalesced into the last mega-dispatch flush",
        )
        self.fleet_padding_waste = r.gauge(
            f"{ns}_tpu_fleet_padding_waste",
            "Padded pod-slot fraction wasted by the last round's mega-dispatch size classes",
        )
        self.fleet_fairness_deficit = r.gauge(
            f"{ns}_tpu_fleet_fairness_deficit",
            "Largest per-tenant deficit-round-robin backlog credit after the last round",
        )
        self.fleet_decision_latency = r.histogram(
            f"{ns}_tpu_fleet_decision_latency_seconds",
            "Fleet pod-pending to plan-emitted decision latency, all tenants; buckets env-tunable via KARPENTER_TPU_LATENCY_BUCKETS_MS",
            buckets=latency_buckets(),
        )
        self.fleet_round_duration = r.histogram(
            f"{ns}_tpu_fleet_round_duration_seconds",
            "Fleet round wall time, by engine",
            labels=["engine"],
        )
        # node/nodepool/pod scrapers (metrics/{node,nodepool,pod})
        self.node_allocatable = r.gauge(f"{ns}_nodes_allocatable", "Node allocatable", ["node", "resource"])
        self.node_pod_requests = r.gauge(f"{ns}_nodes_total_pod_requests", "Node pod requests", ["node", "resource"])
        self.node_pod_limits = r.gauge(f"{ns}_nodes_total_pod_limits", "Node pod limits", ["node", "resource"])
        self.node_daemon_requests = r.gauge(f"{ns}_nodes_total_daemon_requests", "Node daemon requests", ["node", "resource"])
        self.node_daemon_limits = r.gauge(f"{ns}_nodes_total_daemon_limits", "Node daemon limits", ["node", "resource"])
        self.node_system_overhead = r.gauge(f"{ns}_nodes_system_overhead", "Node system overhead", ["node", "resource"])
        self.nodepool_limit = r.gauge(f"{ns}_nodepool_limit", "NodePool limit", ["nodepool", "resource"])
        self.nodepool_usage = r.gauge(f"{ns}_nodepool_usage", "NodePool usage", ["nodepool", "resource"])
        self.pod_state = r.gauge(f"{ns}_pods_state", "Pod state", ["name", "namespace", "phase"])
        self.pod_startup_time = r.histogram(f"{ns}_pods_startup_time_seconds", "Pod startup time")
        self.reconcile_duration = r.histogram(
            f"{ns}_controller_reconcile_duration_seconds", "Controller reconcile duration", labels=["controller"]
        )
        self.reconcile_errors = r.counter(
            f"{ns}_controller_reconcile_errors_total", "Controller reconcile errors", ["controller"]
        )
