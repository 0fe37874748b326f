"""Per-decision flight recorder: one bounded ring
of decision records, each assembled at plan-emit time from the spans the
cross-thread TraceContext propagation collected under the decision's
root.

A record answers "where did this pod's 90 ms go?" without loading a
Chrome trace: the pod-pending → plan-emitted latency of every pod the
decision settled, queue-wait vs compute split, per-stage self times on
the authoritative lane (they sum to the decision's wall clock — the
root-lane partition invariant the tracer maintains), concurrent-lane
time (prewarm / adopted work overlapping the decision), the
consolidated per-solve stats (cache-hit digest, merge/pack engine and
backend choices, cost/bound/gap when the LP backend priced the plan),
and the trace links (e.g. the N tenant solves coalesced into one
fleet mega-dispatch).

Operational surface:

- ``/debug/decisions[/last]`` (operator/server.py) serves the ring;
- SLO burn-rate gauges: the fraction of decisions over
  ``KARPENTER_TPU_SLO_TARGET_MS`` (default 500 — the paper's headline
  budget) in the trailing 1 m / 10 m windows, pushed to the metrics
  gauge the pipeline attaches;
- breach dumps: when a decision exceeds
  ``KARPENTER_TPU_SLO_BREACH_DUMP_MS``, the record (with its full
  Chrome trace) is persisted under the slow-solve capture's directory
  (capture.py ``DIR``) exactly like the slow-solve capture, newest
  ``KEEP`` kept.

The ring is process-global (``RECORDER``) like the trace ring; tests
construct private instances.

The port's copy of ``karpenter_core_tpu/tracing/flightrec.py``. The
reference's environment knobs are module constants named for their
twin, which tests monkeypatch: ``SLO_TARGET_MS``
(``KARPENTER_TPU_SLO_TARGET_MS``), ``FLIGHTREC_KEEP``
(``KARPENTER_TPU_FLIGHTREC_KEEP``) and ``SLO_BREACH_DUMP_MS``
(``KARPENTER_TPU_SLO_BREACH_DUMP_MS``, None: off).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .tracer import Trace

log = logging.getLogger("karpenter.flightrec")

DEFAULT_KEEP = 256
DEFAULT_TARGET_MS = 500.0
# the burn windows (seconds → gauge label); trailing-window fractions of
# decisions over target, the SRE-shaped "are we eating the error budget"
# signal for the decision-latency SLO
BURN_WINDOWS = ((60.0, "1m"), (600.0, "10m"))
# a decision's timeline counts as fully reconstructed when the root
# lane's per-stage self times sum to its wall clock within this fraction
RECONSTRUCT_TOL = 0.01


# the reference's environment knobs, as constants with its defaults
SLO_TARGET_MS = DEFAULT_TARGET_MS
FLIGHTREC_KEEP = DEFAULT_KEEP
SLO_BREACH_DUMP_MS: Optional[float] = None


def slo_target_ms() -> float:
    return float(SLO_TARGET_MS)


# -- chaos fault-window annotation -------------------------------
# The chaos harness registers the active fault window here so a breach
# dump (or a /debug/decisions record) produced while a fault is injected
# is distinguishable from an organic regression. Process-global like
# RECORDER; the window rides every record assembled while it is set.

_FAULT_WINDOW_MU = threading.Lock()
_FAULT_WINDOW: Optional[dict] = None


def set_fault_window(scenario: str, fault: str, phase: str = "active") -> None:
    """Mark records assembled from now on as taken under injected
    chaos: ``scenario`` (e.g. chaos_relist_storm), ``fault`` (the
    kube/faults.py kind), ``phase`` (inject | active | recovery)."""
    global _FAULT_WINDOW
    with _FAULT_WINDOW_MU:
        _FAULT_WINDOW = {"scenario": scenario, "fault": fault, "phase": phase}


def clear_fault_window() -> None:
    global _FAULT_WINDOW
    with _FAULT_WINDOW_MU:
        _FAULT_WINDOW = None


def active_fault_window() -> Optional[dict]:
    with _FAULT_WINDOW_MU:
        return dict(_FAULT_WINDOW) if _FAULT_WINDOW is not None else None


class DecisionRecord(dict):
    """One decision's flight record. A plain dict (JSON-ready for the
    debug routes and breach dumps) with typed access helpers."""

    @property
    def decision_id(self) -> str:
        return self.get("decision_id", "")

    @property
    def reconstructed(self) -> bool:
        return bool(self.get("timeline", {}).get("reconstructed"))


class FlightRecorder:
    """Bounded newest-wins ring of DecisionRecords + SLO burn windows."""

    def __init__(self, capacity: Optional[int] = None, clock=time.monotonic):
        if capacity is None:
            capacity = int(FLIGHTREC_KEEP)
        self._mu = threading.Lock()
        self._records: deque = deque(maxlen=max(1, capacity))
        # (monotonic ts, over-target) per decision, pruned past the
        # largest burn window
        self._burn: deque = deque()
        self._seq = 0
        self.clock = clock
        # optional metrics Gauge with a `window` label (the registry's
        # karpenter_tpu_decision_slo_burn_rate); attached by the serving
        # pipeline / fleet scheduler so the recorder stays import-light
        self._burn_gauge = None

    def attach_burn_gauge(self, gauge) -> None:
        with self._mu:
            self._burn_gauge = gauge

    # -- recording -----------------------------------------------------------

    def record(
        self,
        kind: str,
        tick: int,
        trace: Optional[Trace] = None,
        solve: Optional[dict] = None,
        queue_wait_ms: Optional[float] = None,
        latency_ms: Optional[List[float]] = None,
        pods_decided: int = 0,
        errors: int = 0,
        **extra,
    ) -> DecisionRecord:
        """Assemble and retain one decision's record at plan-emit time.

        ``trace`` is the decision's finished root trace (None when
        recording was disabled — the record still lands, flagged
        unreconstructed); ``solve`` is the consolidated
        ``solver.stats.solve_stats`` dict; ``latency_ms`` the
        pod-pending → plan-emitted latencies of the pods this decision
        settled."""
        with self._mu:
            self._seq += 1
            seq = self._seq
        lat = sorted(latency_ms) if latency_ms else []
        rec = DecisionRecord(
            seq=seq,
            kind=kind,
            tick=tick,
            wall_clock=time.time(),
            decision_id=trace.trace_id if trace is not None else f"untraced-{seq}",
            pods_decided=int(pods_decided),
            errors=int(errors),
            latency_ms={
                "max": round(lat[-1], 3) if lat else None,
                "mean": round(sum(lat) / len(lat), 3) if lat else None,
                "count": len(lat),
            },
            timeline=self._timeline(trace, queue_wait_ms),
            solve=solve or {},
            links=list(trace.links) if trace is not None else [],
        )
        if extra:
            rec.update(extra)
        window = active_fault_window()
        if window is not None:
            rec["fault_window"] = window
        # the SLO clock is decision latency when pods were settled,
        # the step's own wall otherwise (an empty tick still burns time)
        slo_ms = rec["latency_ms"]["max"]
        if slo_ms is None:
            slo_ms = rec["timeline"]["wall_ms"]
        rec["slo_ms"] = round(slo_ms, 3) if slo_ms is not None else None
        target = slo_target_ms()
        rec["slo_over"] = bool(slo_ms is not None and slo_ms > target)
        now = self.clock()
        with self._mu:
            self._records.append(rec)
            self._burn.append((now, rec["slo_over"]))
            horizon = now - max(w for w, _ in BURN_WINDOWS)
            while self._burn and self._burn[0][0] < horizon:
                self._burn.popleft()
            gauge = self._burn_gauge
            burn = self._burn_rates_locked(now)
        if gauge is not None:
            for _, label in BURN_WINDOWS:
                gauge.set(burn[label], window=label)
        self._maybe_dump(rec, trace)
        return rec

    @staticmethod
    def _maybe_dump(rec: DecisionRecord, trace: Optional[Trace]) -> None:
        """Persist ``rec`` with its Chrome trace events when its SLO clock
        passed ``SLO_BREACH_DUMP_MS``. Never fails the decision."""
        threshold = SLO_BREACH_DUMP_MS
        if threshold is None or rec["slo_ms"] is None or rec["slo_ms"] <= float(threshold):
            return
        from . import capture

        out_dir = capture.DIR
        try:
            payload = {"record": rec}
            if trace is not None:
                from .export import to_chrome_events

                payload["trace_events"] = to_chrome_events(trace)
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"decision-{rec['wall_clock']:.3f}-{rec.decision_id}.breach.json")
            with open(path, "w") as f:
                json.dump(payload, f, default=str)
            capture._prune(out_dir)
        except (OSError, TypeError, ValueError):
            log.debug("SLO breach dump failed", exc_info=True)

    @staticmethod
    def _timeline(trace: Optional[Trace], queue_wait_ms: Optional[float]) -> dict:
        if trace is None:
            return {
                "wall_ms": None,
                "queue_wait_ms": queue_wait_ms,
                "stages_ms": {},
                "stages_sum_ms": None,
                "concurrent_ms": {},
                "lanes": 0,
                "reconstructed": False,
            }
        wall = trace.total_ms
        stages = {k: round(v, 3) for k, v in sorted(trace.phase_breakdown_ms().items())}
        stages_sum = sum(stages.values())
        lanes = trace.lane_breakdown_ms()
        concurrent: Dict[str, float] = {}
        for tid, lane in lanes.items():
            if trace.root_tid is not None and tid == trace.root_tid:
                continue
            for name, ms in lane.items():
                concurrent[name] = round(concurrent.get(name, 0.0) + ms, 3)
        return {
            "wall_ms": round(wall, 3),
            "queue_wait_ms": queue_wait_ms,
            "stages_ms": stages,
            "stages_sum_ms": round(stages_sum, 3),
            "concurrent_ms": concurrent,
            "lanes": len(lanes),
            # the acceptance invariant: root-lane self times partition
            # the decision's wall clock (within tolerance + a scheduling
            # jitter floor for sub-ms decisions)
            "reconstructed": bool(
                trace.spans
                and abs(stages_sum - wall) <= max(RECONSTRUCT_TOL * wall, 0.05)
            ),
        }

    # -- burn accounting -----------------------------------------------------

    def _burn_rates_locked(self, now: float) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for window, label in BURN_WINDOWS:
            total = over = 0
            for ts, was_over in self._burn:
                if ts >= now - window:
                    total += 1
                    over += was_over
            out[label] = round(over / total, 4) if total else 0.0
        return out

    def burn_rates(self) -> Dict[str, float]:
        with self._mu:
            return self._burn_rates_locked(self.clock())

    # -- consumers -----------------------------------------------------------

    def last(self) -> Optional[DecisionRecord]:
        with self._mu:
            return self._records[-1] if self._records else None

    def all(self) -> List[DecisionRecord]:
        with self._mu:
            return list(self._records)

    def coverage(self, kind: Optional[str] = None) -> Optional[float]:
        """Fraction of retained decisions with a fully reconstructed
        timeline (the ≥99% acceptance metric). None when empty."""
        with self._mu:
            recs = [r for r in self._records if kind is None or r["kind"] == kind]
        if not recs:
            return None
        return sum(1 for r in recs if r.reconstructed) / len(recs)

    def clear(self) -> None:
        with self._mu:
            self._records.clear()
            self._burn.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._records)

    def debug_state(self, tail: int = 32) -> dict:
        """The /debug/decisions payload."""
        with self._mu:
            records = list(self._records)
            capacity = self._records.maxlen
            burn = self._burn_rates_locked(self.clock())
        coverage = (
            round(sum(1 for r in records if r.reconstructed) / len(records), 4)
            if records
            else None
        )
        return {
            "retained": len(records),
            "capacity": capacity,
            "slo_target_ms": slo_target_ms(),
            "burn_rate": burn,
            "coverage": coverage,
            "fault_window": active_fault_window(),
            "decisions": records[-max(1, tail):],
        }


RECORDER = FlightRecorder()
