"""Per-solve device time, transfers and device memory.

The port's copy of ``karpenter_core_tpu/solver/devicetime.py``. The
reference sums the host wall time of its tracked device boundaries. The
port's device time is the card's own: every ``track``ed region on a
thread whose clock runs on a CUDA device records a pair of CUDA events
on the current stream, and ``seconds()`` is the sum of the pairs'
elapsed times (which synchronises on their end events). On the CPU the
time is 0.

Each solve runs in its own :func:`scope` (``reset`` opens a fresh clock
the reference's way); a scope opened inside another, a disruption
simulation's solve inside a decision the caller times, adds its pairs to
the outer scope's as it closes. ``track(phase=...)`` is also a
``device_wait`` span of the active trace, labelled with its boundary:
``compat``, ``pack``, ``existing``, ``lp`` or ``screen``.
``transfer()`` accounts a boundary's host↔device bytes into the device
plane (tracing/deviceplane.py), and ``device_memory_stats()`` reads the
card's allocator.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from ..tracing import deviceplane
from ..tracing.tracer import span as _span

_tls = threading.local()
# the card's memory by device index: mem_get_info's total, read once (a
# poll of the allocator costs about 0.1 ms, mem_get_info more)
_TOTAL: Dict[int, int] = {}


class Clock:
    """The event pairs of one scope, by boundary."""

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.pairs: List[tuple] = []  # (phase, start event, end event)

    def ms(self) -> float:
        return sum(self.phase_ms().values())

    def phase_ms(self) -> Dict[str, float]:
        """Milliseconds of the scope's event pairs per boundary."""
        out: Dict[str, float] = {}
        for phase, start, end in self.pairs:
            end.synchronize()
            out[phase] = out.get(phase, 0.0) + start.elapsed_time(end)
        return out


def _clock() -> Optional[Clock]:
    return getattr(_tls, "clock", None)


def reset(device=None) -> Clock:
    """A fresh clock for this thread (``device``: where its work runs;
    None or the CPU: no event pairs)."""
    _tls.clock = Clock(device)
    return _tls.clock


def seconds() -> float:
    clock = _clock()
    return clock.ms() / 1000.0 if clock is not None else 0.0


@contextmanager
def scope(device=None):
    """This thread's clock for the block, the outer one restored after,
    with the block's pairs added to it."""
    outer = _clock()
    clock = Clock(device)
    _tls.clock = clock
    try:
        yield clock
    finally:
        _tls.clock = outer
        if outer is not None:
            outer.pairs.extend(clock.pairs)


@contextmanager
def track(phase: str = "solve"):
    """One device boundary: a ``device_wait`` span labelled ``phase`` and,
    on a CUDA clock, a pair of CUDA events around the block."""
    clock = _clock()
    with _span("device_wait", phase=phase):
        if clock is None or not clock.cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            clock.pairs.append((phase, start, end))


def transfer(direction: str, *arrays, phase: str = "solve", nbytes: Optional[int] = None) -> None:
    """Account one host/device transfer at a boundary: ``direction`` is
    ``h2d`` or ``d2h``; pass the tensors or arrays moved, or ``nbytes``."""
    n = nbytes if nbytes is not None else deviceplane.nbytes_of(*arrays)
    deviceplane.record_transfer(direction, n, phase=phase)


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator of ``device``: bytes in use and their peak
    since the process started (or the last ``reset_peak_memory_stats``),
    one ``torch.cuda.memory_stats`` read, and the card's memory
    (``mem_get_info``'s total, read once a device). None with the plane
    off and off the card, where ``torch.cuda`` is never touched."""
    if not deviceplane.enabled() or device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    total = _TOTAL.get(index)
    if total is None:
        total = _TOTAL[index] = int(torch.cuda.mem_get_info(index)[1])
    stats = torch.cuda.memory_stats(index)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": total,
    }
