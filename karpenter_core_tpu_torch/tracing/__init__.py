"""Solve-trace subsystem: the port's copy of ``karpenter_core_tpu/tracing``.

  tracer.py — thread-local span stack, monotonic clocks, ring buffer,
              cross-thread TraceContext capture/adopt + orphan counter

The reference's flight recorder (``flightrec.py``), Chrome trace-event
export (``export.py``), slow-solve capture (``capture.py``) and device
plane (``deviceplane.py``) are not ported yet.
"""

from .tracer import (  # noqa: F401
    RING,
    Span,
    Trace,
    TraceContext,
    TraceRing,
    adopt,
    capture,
    current_trace,
    current_trace_id,
    enabled,
    orphan_recent,
    orphan_spans,
    reset_orphans,
    span,
    trace_root,
)
