"""Operator configuration: CLI flags with env fallbacks + feature gates
(ref pkg/operator/options/options.go).

The port's copy of ``karpenter_core_tpu/operator/options.py``. The
environment variables are the upstream operator's deployment flags, read
with the reference's names and defaults; ``Options.from_env`` reads each
one by its literal name (no other module of the port reads them).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional


def _parsed(raw: Optional[str], default):
    """``raw`` (an environment value, or None when unset) in ``default``'s
    type; None gives ``default``."""
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclass
class FeatureGates:
    """options.go:123-137: parsed from "Drift=true,..." strings."""

    drift: bool = True

    @classmethod
    def parse(cls, s: str) -> "FeatureGates":
        gates = cls()
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            enabled = value.strip().lower() in ("true", "1", "")
            if key.strip().lower() == "drift":
                gates.drift = enabled
        return gates


@dataclass
class Options:
    """options.go:47-99 — same knobs, same defaults."""

    service_name: str = ""
    # the namespace the operator runs in (SYSTEM_NAMESPACE downward-API
    # convention); the only namespace whose config-logging is honored
    system_namespace: str = "default"
    metrics_port: int = 8000
    health_probe_port: int = 8081
    kube_client_qps: int = 200
    kube_client_burst: int = 300
    enable_profiling: bool = False
    enable_leader_election: bool = True
    memory_limit: int = -1
    log_level: str = "info"
    batch_max_duration: float = 10.0  # options.go:96
    batch_idle_duration: float = 1.0  # options.go:97
    feature_gates: FeatureGates = field(default_factory=FeatureGates)
    # options.go:84 DISABLE_WEBHOOK — our admission chain (defaults +
    # validation) replaces the knative webhook; enabled by default since
    # there is no CEL layer in-process to fall back on.
    disable_webhook: bool = False
    # the batched solver and the consolidation screens (the reference's
    # names, kept so deployments set the same flags): on the port, the
    # TorchScheduler and the B8 screens on the operator's device
    use_tpu_solver: bool = True
    tpu_consolidation_screen: bool = True
    # serving pipeline (serving/pipeline.py): replace the tick-shaped
    # provisioner reconcile loop with the staged async pipeline
    # (overlapped batching/encode/dispatch/emit + /debug/serving)
    use_serving_pipeline: bool = False

    @classmethod
    def from_env(cls) -> "Options":
        opts = cls()
        opts.service_name = _parsed(os.environ.get("SYSTEM_NAME"), opts.service_name)
        opts.system_namespace = _parsed(os.environ.get("SYSTEM_NAMESPACE"), opts.system_namespace)
        opts.metrics_port = _parsed(os.environ.get("METRICS_PORT"), opts.metrics_port)
        opts.health_probe_port = _parsed(os.environ.get("HEALTH_PROBE_PORT"), opts.health_probe_port)
        opts.kube_client_qps = _parsed(os.environ.get("KUBE_CLIENT_QPS"), opts.kube_client_qps)
        opts.kube_client_burst = _parsed(os.environ.get("KUBE_CLIENT_BURST"), opts.kube_client_burst)
        opts.enable_profiling = _parsed(os.environ.get("ENABLE_PROFILING"), opts.enable_profiling)
        opts.enable_leader_election = _parsed(os.environ.get("LEADER_ELECT"), opts.enable_leader_election)
        opts.log_level = _parsed(os.environ.get("LOG_LEVEL"), opts.log_level)
        opts.batch_max_duration = _parsed(os.environ.get("BATCH_MAX_DURATION"), opts.batch_max_duration)
        opts.batch_idle_duration = _parsed(os.environ.get("BATCH_IDLE_DURATION"), opts.batch_idle_duration)
        opts.feature_gates = FeatureGates.parse(_parsed(os.environ.get("FEATURE_GATES"), ""))
        opts.disable_webhook = _parsed(os.environ.get("DISABLE_WEBHOOK"), opts.disable_webhook)
        opts.use_tpu_solver = _parsed(os.environ.get("USE_TPU_SOLVER"), opts.use_tpu_solver)
        opts.tpu_consolidation_screen = _parsed(os.environ.get("TPU_CONSOLIDATION_SCREEN"), opts.tpu_consolidation_screen)
        opts.use_serving_pipeline = _parsed(os.environ.get("USE_SERVING_PIPELINE"), opts.use_serving_pipeline)
        return opts

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "Options":
        opts = cls.from_env()
        parser = argparse.ArgumentParser("karpenter-tpu")
        parser.add_argument("--metrics-port", type=int, default=opts.metrics_port)
        parser.add_argument("--health-probe-port", type=int, default=opts.health_probe_port)
        parser.add_argument("--enable-profiling", action="store_true", default=opts.enable_profiling)
        parser.add_argument("--leader-elect", action="store_true", default=opts.enable_leader_election)
        parser.add_argument("--log-level", default=opts.log_level)
        parser.add_argument("--batch-max-duration", type=float, default=opts.batch_max_duration)
        parser.add_argument("--batch-idle-duration", type=float, default=opts.batch_idle_duration)
        parser.add_argument("--feature-gates", default="")
        parser.add_argument("--use-tpu-solver", action="store_true", default=opts.use_tpu_solver)
        args = parser.parse_args(argv)
        opts.metrics_port = args.metrics_port
        opts.health_probe_port = args.health_probe_port
        opts.enable_profiling = args.enable_profiling
        opts.enable_leader_election = args.leader_elect
        opts.log_level = args.log_level
        opts.batch_max_duration = args.batch_max_duration
        opts.batch_idle_duration = args.batch_idle_duration
        if args.feature_gates:
            opts.feature_gates = FeatureGates.parse(args.feature_gates)
        opts.use_tpu_solver = args.use_tpu_solver
        return opts
