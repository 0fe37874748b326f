"""Async serving pipeline: the port's copy of ``karpenter_core_tpu/serving``.
Staged overlap of watch-event ingestion → batching/encode → device
dispatch → finalize/emit, plus the production traffic simulator that
measures it (``trafficgen``: the scenarios, the harness, the lockstep,
free and restart drivers and the CLI).

Overlap-safety invariant: **overlap is scheduling, never reordering of
observable state.** Every observable state transition — NodeClaim
creation, nominations, events — happens on the single authoritative plan
thread in tick order; concurrent stages only form batches, warm
content-addressed caches, and drain telemetry. The pipeline's plans are
therefore byte-identical to the equivalent sequential reconcile by
construction, which ``tests/test_torch_serving.py`` and ``chip_smoke.py``
verify against the sequential loop on every scenario.
"""

from .latency import DecisionLatencyTracker, percentiles_ms
from .pipeline import LostLeadership, PipelineConfig, SequentialLoop, ServingPipeline
from .queues import Closed, StageQueue

__all__ = [
    "Closed",
    "DecisionLatencyTracker",
    "LostLeadership",
    "PipelineConfig",
    "SequentialLoop",
    "ServingPipeline",
    "StageQueue",
    "percentiles_ms",
]
