"""Chrome trace-event JSON export (the catapult TraceEvent format that
Perfetto and ``chrome://tracing`` load directly): the port's copy of
``karpenter_core_tpu/tracing/export.py``.

Every span becomes one complete event (``ph: "X"``) with microsecond
``ts``/``dur``; metadata events (``ph: "M"``) name the process and the
per-thread tracks. All spans share one monotonic clock
(perf_counter_ns), so events from several traces in one export sequence
correctly on the shared timeline.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

from .tracer import SYNTHETIC_TID, Trace

# stable small track number for the synthetic device lane; real thread
# idents are remapped to small ints per export for readable track names
_DEVICE_TRACK = 0


def to_chrome_events(trace: Trace) -> List[dict]:
    """One trace → a list of TraceEvent dicts."""
    events: List[dict] = []
    tid_map: Dict[int, int] = {}

    def track(tid: int) -> int:
        if tid == SYNTHETIC_TID:
            return _DEVICE_TRACK
        if tid not in tid_map:
            tid_map[tid] = len(tid_map) + 1
        return tid_map[tid]

    for s in trace.spans:
        ev = {
            "name": s.name,
            "ph": "X",
            "ts": s.ts_ns / 1e3,  # microseconds (may be fractional)
            "dur": s.dur_ns / 1e3,
            "pid": trace.pid,
            "tid": track(s.tid),
            "cat": "solve" if s.tid != SYNTHETIC_TID else "device",
        }
        args = dict(s.args) if s.args else {}
        if s.parent is None:
            args.setdefault("trace_id", trace.trace_id)
        if args:
            ev["args"] = args
        events.append(ev)

    # metadata: name the process once and each thread track
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": trace.pid,
            "tid": 0,
            "args": {"name": f"karpenter-tpu solve {trace.trace_id}"},
        },
        {
            "name": "thread_name",
            "ph": "M",
            "pid": trace.pid,
            "tid": _DEVICE_TRACK,
            "args": {"name": "device (attributed)"},
        },
    ]
    for ident, num in tid_map.items():
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": trace.pid,
                "tid": num,
                "args": {"name": f"host thread {ident}"},
            }
        )
    return meta + events


def to_chrome_json(traces: Iterable[Trace]) -> str:
    """One or more traces → a Chrome trace-event JSON document
    (object form, so top-level metadata is representable)."""
    traces = list(traces)
    events: List[dict] = []
    for t in traces:
        events.extend(to_chrome_events(t))
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "traces": [
                {
                    "trace_id": t.trace_id,
                    "name": t.name,
                    "wall_start": t.wall_start,
                    "total_ms": round(t.total_ms, 3),
                    **({"args": t.args} if t.args else {}),
                }
                for t in traces
            ]
        },
    }
    return json.dumps(doc)
