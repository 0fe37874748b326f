"""Decision-latency accounting: pod-pending → plan-emitted, the serving
pipeline's headline SLO (pods/sec says how fast the
solver chews batches; decision latency says how long a *pod* waited for
its capacity decision, which is what a user-facing deployment feels).

The tracker is shared by the pipeline and the sequential baseline so the
two measure the identical interval: arrival is stamped in the pod-watch
callback (the moment the control plane could first have known about the
pod), decision when the authoritative step has emitted the pod's plan
(NodeClaim created / existing-node nomination / terminal error).

The port's copy of ``karpenter_core_tpu/serving/latency.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def percentiles_ms(samples_ms: Sequence[float], qs: Sequence[int] = (50, 95, 99)) -> dict:
    """{p50: .., p95: .., p99: ..} over latency samples, in ms (linear
    interpolation, numpy-free so bench helpers can share it)."""
    if not samples_ms:
        return {f"p{q}": 0.0 for q in qs}
    s = sorted(samples_ms)
    out = {}
    for q in qs:
        k = (len(s) - 1) * (q / 100.0)
        lo, hi = int(k), min(int(k) + 1, len(s) - 1)
        out[f"p{q}"] = round(s[lo] + (s[hi] - s[lo]) * (k - lo), 3)
    return out


class DecisionLatencyTracker:
    def __init__(self, clock=time.perf_counter, histogram=None):
        self._mu = threading.Lock()
        self.clock = clock
        self._histogram = histogram  # optional seconds Histogram
        # uid -> (arrival time, arrival step) for undecided pods
        self._pending: Dict[str, Tuple[float, Optional[int]]] = {}
        # (uid, latency_s, arrival_step, decided_tick, error?)
        self._samples: List[Tuple[str, float, Optional[int], int, bool]] = []
        # emit-order decision log: (tick, uid) — the monotonicity witness
        self._decision_log: List[Tuple[int, str]] = []

    # -- producers ----------------------------------------------------------

    def pod_pending(self, uid: str, step: Optional[int] = None) -> None:
        """First-seen-pending wins: re-listing an already-pending pod
        must not move its arrival time."""
        t = self.clock()
        with self._mu:
            self._pending.setdefault(uid, (t, step))

    def forget(self, uid: str) -> None:
        """Pod deleted before any decision (churn) — not a sample."""
        with self._mu:
            self._pending.pop(uid, None)

    def pods_decided(
        self,
        uids: Iterable[str],
        tick: int,
        error: bool = False,
        trace_id: Optional[str] = None,
    ) -> List[float]:
        """First decision wins (a later re-plan of a still-pending pod
        does not extend its measured latency). ``trace_id`` (the
        deciding solve's trace) rides the latency histogram as an
        exemplar, so a slow bucket names a loadable trace. Returns the
        latencies (seconds) settled by THIS call — the flight
        recorder's per-decision timeline input."""
        t = self.clock()
        hist = self._histogram
        settled: List[float] = []
        with self._mu:
            for uid in uids:
                arrived = self._pending.pop(uid, None)
                if arrived is None:
                    continue
                lat = t - arrived[0]
                self._samples.append((uid, lat, arrived[1], tick, error))
                self._decision_log.append((tick, uid))
                settled.append(lat)
                if hist is not None:
                    hist.observe(lat, exemplar=trace_id)
        return settled

    # -- consumers ----------------------------------------------------------

    def samples_ms(self, include_errors: bool = True) -> List[float]:
        with self._mu:
            return [
                s[1] * 1000.0 for s in self._samples if include_errors or not s[4]
            ]

    def percentiles(self, qs: Sequence[int] = (50, 95, 99)) -> dict:
        return percentiles_ms(self.samples_ms(), qs)

    def decisions(self) -> List[Tuple[str, float, Optional[int], int, bool]]:
        with self._mu:
            return list(self._samples)

    def decision_log(self) -> List[Tuple[int, str]]:
        with self._mu:
            return list(self._decision_log)

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    def decided_count(self) -> int:
        with self._mu:
            return len(self._samples)

    def reset(self) -> None:
        with self._mu:
            self._pending.clear()
            self._samples.clear()
            self._decision_log.clear()
