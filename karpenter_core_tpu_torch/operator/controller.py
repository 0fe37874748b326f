"""Controller abstractions (ref pkg/operator/controller/controller.go,
singleton.go): singleton poll-loop controllers with reconcile metrics and
the 10 ms → 10 s backoff rate limiter.

The port's copy of ``karpenter_core_tpu/operator/controller.py``. A
controller's thread launches on the default CUDA stream, like every other
thread of the port: no controller takes a stream of its own."""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

BASE_DELAY = 0.01  # singleton.go:133 rate-limiter base
MAX_DELAY = 10.0  # singleton.go:141 max
GATED_POLL = 2.0  # follower re-check cadence (matches elector retry period)


class SingletonController:
    """singleton.go:39: a controller that reconciles in its own loop."""

    def __init__(
        self,
        name: str,
        reconcile: Callable[[], Optional[float]],
        metrics=None,
        logger=None,
        period: float = 10.0,
        gate: Optional[Callable[[], bool]] = None,
    ):
        self.name = name
        self._reconcile = reconcile
        self.metrics = metrics
        self.logger = logger
        self.period = period
        # leader-election gate: while it returns False (we are a
        # follower), reconciles are skipped but the loop keeps ticking
        self.gate = gate
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error_streak = 0

    def reconcile_once(self) -> Optional[float]:
        """One reconcile; returns the requeue delay. Errors back off
        exponentially (singleton.go:81-123)."""
        if self.gate is not None and not self.gate():
            # short follower poll — a newly promoted leader must start
            # reconciling promptly, not after e.g. a 600 s consistency period
            return min(self.period, GATED_POLL)
        start = time.perf_counter()
        try:
            requeue_after = self._reconcile()
            self._error_streak = 0
        except Exception as e:  # noqa: BLE001 — controller loops never die
            self._error_streak += 1
            if self.metrics is not None:
                self.metrics.reconcile_errors.inc(controller=self.name)
            if self.logger is not None:
                self.logger.with_(controller=self.name).error("reconcile error, %s", e)
            requeue_after = min(BASE_DELAY * (2 ** self._error_streak), MAX_DELAY)
        finally:
            if self.metrics is not None:
                self.metrics.reconcile_duration.observe(
                    time.perf_counter() - start, controller=self.name
                )
        return requeue_after if requeue_after is not None else self.period

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive() and not self._stop.is_set():
            return  # already running
        # fresh stop event per start: a previous loop still draining a
        # long reconcile keeps its own (set) event and exits at its next
        # check, so stop() → start() restart can never leak a second loop
        stop = self._stop = threading.Event()

        def loop():
            while not stop.is_set():
                delay = self.reconcile_once()
                stop.wait(delay)

        self._thread = threading.Thread(target=loop, name=self.name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
