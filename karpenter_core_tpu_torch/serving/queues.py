"""Bounded stage queues — the only legal way mutable work items cross a
pipeline stage boundary (enforced by the pipeline-safety analysis rule:
shared state is either lock-guarded or handed off through one of these).

``put`` blocks when the queue is full: backpressure propagates upstream
instead of buffering unboundedly (a slow solve stage slows batch
formation, which slows ingest, which blocks the watch callback — the
producer feels the pipeline's true capacity). The reference reads each
cap from ``KARPENTER_TPU_SERVING_<NAME>_CAP``; the port keeps the
defaults as module constants named for their twin (``SOLVE_CAP``,
``TELEMETRY_CAP``), which tests monkeypatch.

The port's copy of ``karpenter_core_tpu/serving/queues.py``.

Trace propagation: every ``put`` captures the producer's
``TraceContext`` (or takes an explicit one) into the queue entry, so a
consumer that calls ``get_entry`` can re-adopt the producing decision's
trace on its own thread — the queue is the stage boundary, so it is
also where the trace crosses. Plain ``get`` unwraps the item and drops
the context (existing consumers unchanged).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Tuple

from ..tracing import tracer


class Closed(Exception):
    """Raised by put()/get() once the queue is closed (and drained, for
    get)."""


# the stage caps (the reference's KARPENTER_TPU_SERVING_SOLVE_CAP and
# KARPENTER_TPU_SERVING_TELEMETRY_CAP defaults): batch tokens in flight
# between the window former and the plan thread, and tick records
# between the plan thread and the telemetry drain
SOLVE_CAP = 1
TELEMETRY_CAP = 1024


class StageQueue:
    """Bounded FIFO handoff between two pipeline stages.

    Ownership discipline: an item belongs to the producer until ``put``
    returns, to the consumer after ``get`` returns — neither side
    touches it in between, so items need no locks of their own.
    """

    def __init__(self, name: str, maxsize: int, depth_gauge=None):
        self.name = name
        self.maxsize = max(1, int(maxsize))
        self._cv = threading.Condition()
        self._items: deque = deque()
        self._closed = False
        self._high_water = 0
        self._blocked_puts = 0  # backpressure events (puts that had to wait)
        self._total_puts = 0
        # optional metrics Gauge, labeled by stage name
        self._depth_gauge = depth_gauge

    def _set_gauge(self, depth: int) -> None:
        # callers hold self._cv
        if self._depth_gauge is not None:
            self._depth_gauge.set(float(depth), stage=self.name)

    def put(self, item, timeout: Optional[float] = None, ctx=None) -> bool:
        """Enqueue, blocking while full (backpressure). Returns False on
        timeout, True otherwise. Raises Closed after close().

        The producer's active ``TraceContext`` is captured into the
        entry (``ctx`` overrides it — e.g. a context snapshotted before
        the producer's trace root closed); ``get_entry`` hands it to the
        consumer for re-adoption."""
        if ctx is None:
            ctx = tracer.capture()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            blocked = False
            while len(self._items) >= self.maxsize and not self._closed:
                if not blocked:
                    blocked = True
                    self._blocked_puts += 1
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            if self._closed:
                raise Closed(self.name)
            self._items.append((item, ctx))
            self._total_puts += 1
            depth = len(self._items)
            if depth > self._high_water:
                self._high_water = depth
            self._set_gauge(depth)
            self._cv.notify_all()
            return True

    def get_entry(self, timeout: Optional[float] = None) -> Optional[Tuple[object, object]]:
        """Dequeue one (item, trace context) entry, blocking while
        empty. Returns None on timeout; raises Closed once the queue is
        closed AND drained. The context is the producer's capture (None
        when the producer was untraced) — adopt it to land this stage's
        spans under the producing decision's root."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._items:
                if self._closed:
                    raise Closed(self.name)
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(timeout=remaining)
            entry = self._items.popleft()
            self._set_gauge(len(self._items))
            self._cv.notify_all()
            return entry

    def get(self, timeout: Optional[float] = None):
        """Dequeue, blocking while empty. Returns the item, or None on
        timeout (stages enqueue only non-None work items). Raises
        Closed once the queue is closed AND drained."""
        entry = self.get_entry(timeout=timeout)
        return entry[0] if entry is not None else None

    def close(self) -> None:
        """Wake every waiter; subsequent puts raise, gets drain then
        raise."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def reopen(self) -> None:
        """Reset after close() (pipeline restart); drops undrained
        items."""
        with self._cv:
            self._closed = False
            self._items.clear()
            self._set_gauge(0)

    def depth(self) -> int:
        with self._cv:
            return len(self._items)

    def stats(self) -> dict:
        with self._cv:
            return {
                "depth": len(self._items),
                "cap": self.maxsize,
                "high_water": self._high_water,
                "blocked_puts": self._blocked_puts,
                "total_puts": self._total_puts,
            }
