"""NillableDuration (ref pkg/apis/v1beta1/duration.go): the port's copy of
``karpenter_core_tpu/apis/duration.py``.

A duration that can be explicitly ``Never`` (nil in the Go API). We
represent durations as float seconds; ``None`` means "never".
"""

from __future__ import annotations

import re
from typing import Optional

_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}
_TOKEN = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")


def parse_duration(value) -> Optional[float]:
    """Parse a Go duration string ("15m", "1h30m", "Never") to seconds."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    s = value.strip()
    if s in ("Never", "never", ""):
        return None
    total, pos = 0.0, 0
    for m in _TOKEN.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {value!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {value!r}")
    return total


def format_duration(seconds: Optional[float]) -> str:
    if seconds is None:
        return "Never"
    if seconds == int(seconds):
        sec = int(seconds)
        if sec % 3600 == 0:
            return f"{sec // 3600}h"
        if sec % 60 == 0:
            return f"{sec // 60}m"
        return f"{sec}s"
    return f"{seconds}s"
