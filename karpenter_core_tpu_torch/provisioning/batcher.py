"""Pod batching window (ref pkg/controllers/provisioning/batcher.go):
1 s idle / 10 s max (options.go:96-97). The port's copy of
``karpenter_core_tpu/provisioning/batcher.py``.

Wakeups are condition-variable driven: ``trigger()`` notifies the
waiter directly, so the idle-path decision latency has no polling
floor.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Batcher:
    def __init__(
        self,
        idle_seconds: float = 1.0,
        max_seconds: float = 10.0,
        # pure in-process window durations — monotonic, immune to skew
        clock: Callable[[], float] = time.monotonic,
    ):
        self.idle_seconds = idle_seconds
        self.max_seconds = max_seconds
        self.clock = clock
        self._cv = threading.Condition()
        self._pending = False

    def trigger(self) -> None:
        with self._cv:
            self._pending = True
            self._cv.notify_all()

    def wait(self, poll: Optional[float] = None, blocking: bool = True) -> bool:
        """Block until a batch has formed: first trigger starts the window,
        it closes after `idle` seconds without new triggers or `max`
        overall (batcher.go:52 Wait). Returns False if never triggered.

        ``poll`` is accepted for backward compatibility and ignored —
        the wait is event-driven; the only timed sleeps are the window
        deadlines themselves.
        """
        with self._cv:
            if not self._pending:
                if not blocking:
                    return False
                deadline = time.monotonic() + self.max_seconds
                while not self._pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cv.wait(timeout=remaining)
            start = self.clock()
            last = start
            self._pending = False
            while True:
                now = self.clock()
                if now - last >= self.idle_seconds or now - start >= self.max_seconds:
                    return True
                # sleep exactly until the earlier of the two deadlines; a
                # trigger wakes us immediately and restarts the idle window
                remaining = min(
                    self.idle_seconds - (now - last), self.max_seconds - (now - start)
                )
                self._cv.wait(timeout=remaining)
                if self._pending:
                    self._pending = False
                    last = self.clock()
