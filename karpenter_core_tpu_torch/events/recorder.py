"""Dedup'd, rate-limited event recorder (ref pkg/events/recorder.go): the
port's copy of ``karpenter_core_tpu/events/recorder.py``."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

NORMAL = "Normal"
WARNING = "Warning"

DEFAULT_DEDUPE_TIMEOUT = 120.0  # 2 min (recorder.go:35)


@dataclass
class Event:
    involved_object: object = None  # KubeObject
    type: str = NORMAL
    reason: str = ""
    message: str = ""
    dedupe_values: Tuple[str, ...] = ()
    dedupe_timeout: float = DEFAULT_DEDUPE_TIMEOUT
    rate_limit_per_minute: Optional[int] = None
    # solve-trace correlation: stamped at publish time from the active
    # trace (tracing/), so an event stream can be joined back to the
    # exact trace that produced it
    trace_id: str = ""

    def dedupe_key(self) -> tuple:
        if self.dedupe_values:
            return (self.reason,) + tuple(self.dedupe_values)
        obj = self.involved_object
        return (
            self.reason,
            self.message,
            getattr(obj, "kind", ""),
            getattr(obj, "namespace", ""),
            getattr(obj, "name", ""),
        )


class Recorder:
    """Publishes events with per-key dedupe (recorder.go:47-100). Events
    land in a ring buffer (and optionally the kube store) instead of a real
    apiserver."""

    def __init__(self, kube_client=None, clock: Callable[[], float] = time.time, capacity: int = 10000):
        self.kube_client = kube_client
        self.clock = clock
        self.capacity = capacity
        self.events: List[Event] = []
        self._seen: Dict[tuple, float] = {}
        self._rate: Dict[str, List[float]] = {}
        self._mu = threading.Lock()

    def publish(self, *events: Event) -> None:
        for e in events:
            self._publish_one(e)

    def _publish_one(self, e: Event) -> None:
        if e is None:
            return
        if not e.trace_id:
            from ..tracing.tracer import current_trace_id

            e.trace_id = current_trace_id() or ""
        now = self.clock()
        with self._mu:
            key = e.dedupe_key()
            last = self._seen.get(key)
            if last is not None and now - last < e.dedupe_timeout:
                return
            if e.rate_limit_per_minute is not None:
                window = [t for t in self._rate.get(e.reason, []) if now - t < 60.0]
                if len(window) >= e.rate_limit_per_minute:
                    self._rate[e.reason] = window
                    return
                window.append(now)
                self._rate[e.reason] = window
            self._seen[key] = now
            self.events.append(e)
            if len(self.events) > self.capacity:
                self.events = self.events[-self.capacity :]

    # test helpers (mirrors pkg/test/expectations event assertions)
    def reasons(self) -> List[str]:
        with self._mu:
            return [e.reason for e in self.events]

    def find(self, reason: str) -> List[Event]:
        with self._mu:
            return [e for e in self.events if e.reason == reason]

    def reset(self) -> None:
        with self._mu:
            self.events.clear()
            self._seen.clear()
            self._rate.clear()
