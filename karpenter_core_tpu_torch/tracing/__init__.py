"""Solve-trace subsystem: the port's copy of ``karpenter_core_tpu/tracing``.

  tracer.py    — thread-local span stack, monotonic clocks, ring buffer,
                 cross-thread TraceContext capture/adopt + orphan counter
  flightrec.py — per-decision flight recorder: bounded ring of decision
                 records, SLO burn-rate windows
  export.py    — Chrome trace-event JSON (catapult TraceEvent format)
  capture.py   — slow-solve persistence behind module constants
  deviceplane.py — library loads, launches, transfers and device memory
                 attributed per solve (``/debug/device``)
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
from .export import to_chrome_events, to_chrome_json  # noqa: F401,E402
from .flightrec import RECORDER, DecisionRecord, FlightRecorder  # noqa: F401,E402
from .capture import maybe_capture  # noqa: F401,E402
