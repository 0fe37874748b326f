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
from typing import Dict, List, Optional, Sequence

import torch

from ..tracing import deviceplane
from ..tracing.tracer import span as _span

_tls = threading.local()
# the card's memory by device index: mem_get_info's total, read once (a
# poll of the allocator costs about 0.1 ms, mem_get_info more)
_TOTAL: Dict[int, int] = {}


class Clock:
    """The event pairs of one scope, by boundary: ``(phase, [(card,
    start, end), ...])``, a pair on each card the boundary ran on."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.pairs: List[tuple] = []

    def ms(self) -> float:
        return sum(self.phase_ms().values())

    def phase_ms(self) -> Dict[str, float]:
        """Milliseconds of the scope's event pairs per boundary; a
        boundary across cards counts its longest card's."""
        out: Dict[str, float] = {}
        for phase, cards in self.pairs:
            out[phase] = out.get(phase, 0.0) + max(_elapsed(s, e) for _, s, e in cards)
        return out

    def card_ms(self) -> Dict[str, float]:
        """Milliseconds of each card in the scope's boundaries across
        cards, by card (empty without such a boundary)."""
        out: Dict[str, float] = {}
        for _, cards in self.pairs:
            if len(cards) > 1:
                for card, s, e in cards:
                    out[str(card)] = out.get(str(card), 0.0) + _elapsed(s, e)
        return out


def _elapsed(start, end) -> float:
    end.synchronize()
    return start.elapsed_time(end)


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
def track(phase: str = "solve", devices: Optional[Sequence] = None):
    """One device boundary: a ``device_wait`` span labelled ``phase`` and,
    on a CUDA clock, a pair of CUDA events around the block on the
    current stream of the clock's card, or of each of ``devices`` (the
    cards a mesh's block launches on) where they are more than one."""
    clock = _clock()
    with _span("device_wait", phase=phase):
        if clock is None or not clock.cuda:
            yield
            return
        cards = [torch.device(d) for d in devices or ()]
        cards = cards if len(cards) > 1 else [clock.device]
        pairs = [(card, torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for card in cards]
        for card, start, _ in pairs:
            start.record(torch.cuda.current_stream(card))
        try:
            yield
        finally:
            for card, _, end in pairs:
                end.record(torch.cuda.current_stream(card))
            clock.pairs.append((phase, pairs))


def transfer(direction: str, *arrays, phase: str = "solve", nbytes: Optional[int] = None) -> None:
    """Account one transfer at a boundary: ``direction`` is ``h2d``,
    ``d2h`` or ``peer`` (card to card); pass the tensors or arrays moved,
    or ``nbytes``."""
    n = nbytes if nbytes is not None else deviceplane.nbytes_of(*arrays)
    deviceplane.record_transfer(direction, n, phase=phase)


def device_memory_stats(device=None, cards: Optional[Sequence] = None) -> Optional[dict]:
    """The card's allocator of ``device``: bytes in use and their peak
    since the process started (or the last ``reset_peak_memory_stats``),
    one ``torch.cuda.memory_stats`` read, and the card's memory
    (``mem_get_info``'s total, read once a device). ``cards``: the cards
    of the solve's mesh; where they are more than one, ``cards`` maps
    each to its own read. None with the plane off and off the card,
    where ``torch.cuda`` is never touched."""
    if not deviceplane.enabled() or device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    out = _card_memory(dev)
    if cards is not None and len(cards) > 1:
        out["cards"] = {str(card): _card_memory(torch.device(card)) for card in cards}
    return out


def _card_memory(dev: torch.device) -> dict:
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
