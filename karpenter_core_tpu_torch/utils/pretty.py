"""Log-dedup utilities (ref pkg/utils/pretty).

ChangeMonitor rate-limits repeated log lines: a message under a key is
worth emitting only when its value changed or the key has been quiet
for the window (pretty/changemonitor.go:28, used for the provisioner's
once-per-hour "no nodepools found" warnings, provisioner.go:182-199). The port's copy of
``karpenter_core_tpu/utils/pretty.py``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple


class ChangeMonitor:
    def __init__(self, window_seconds: float = 3600.0, clock: Optional[Callable[[], float]] = None):
        self.window = window_seconds
        self.clock = clock or time.monotonic
        self._seen: Dict[str, Tuple[object, float]] = {}

    def has_changed(self, key: str, value: object) -> bool:
        """True when the value under key changed or the window expired —
        i.e., the caller should log."""
        now = self.clock()
        prev = self._seen.get(key)
        if prev is not None and prev[0] == value and now - prev[1] < self.window:
            return False
        self._seen[key] = (value, now)
        return True
