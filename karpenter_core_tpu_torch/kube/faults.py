"""Deterministic seeded fault schedules: the chaos plane's single
source of truth for "what goes wrong, when".

The port's copy of ``karpenter_core_tpu/kube/faults.py``. The same
``FaultSchedule`` drives every consumer, so a faulted run is
reproducible bit for bit from ``(scenario, seed)`` and the paired clean
run differs ONLY by the injected faults:

- ``RestKubeClient.fault_injector`` (kube/restclient.py) takes a
  ``RestFaultInjector`` that consults the schedule at the adapter's
  single HTTP choke point: 410 storms, stream drops, latency spikes
  against a real apiserver watch loop;
- the trafficgen chaos run (serving/trafficgen.py ``run_chaos``)
  applies the schedule at step boundaries over the in-memory apiserver:
  watch flap/hang, latency spikes, leader failover, clock skew;
- the flight recorder (tracing/flightrec.py) annotates records emitted
  inside a fault window so an SLO breach under injected chaos is
  distinguishable from an organic regression.

Host-only module: the standard library and the REST adapter's
``ApiError``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .restclient import ApiError

# the full disruption-method coverage the tentpole names; a schedule
# may carry any subset
FAULT_KINDS: Tuple[str, ...] = (
    "relist_storm",  # apiserver 410 Gone on watch re-establishment
    "watch_flap",  # watch channel drops (connection reset) repeatedly
    "watch_hang",  # watch channel goes quiet (no events, no error)
    "error_burst",  # in-stream ERROR events (expired resourceVersion)
    "latency_spike",  # apiserver request latency, magnitude = ms
    "heartbeat_loss",  # node Ready heartbeats stop arriving
    "failover",  # leader-election failover mid-tick
    "clock_skew",  # wall clock jumps, magnitude = seconds
)


@dataclass(frozen=True)
class FaultEvent:
    """One fault window: ``kind`` active for ``duration`` consecutive
    steps starting at ``step``. ``magnitude`` is kind-specific (latency
    ms, skew seconds, burst length); 0 means the kind's default."""

    kind: str
    step: int
    duration: int = 1
    magnitude: float = 0.0

    def active_at(self, step: int) -> bool:
        return self.step <= step < self.step + max(1, self.duration)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "step": self.step,
            "duration": self.duration,
            "magnitude": self.magnitude,
        }


class FaultSchedule:
    """An immutable, seeded list of FaultEvents addressed by step index
    (harness scenario step, or request ordinal for the REST injector)."""

    def __init__(self, name: str, seed: int, events: Sequence[FaultEvent]):
        self.name = name
        self.seed = int(seed)
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.kind))
        )
        for ev in self.events:
            if ev.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}")

    def active(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.active_at(step)]

    def kinds_at(self, step: int) -> Tuple[str, ...]:
        return tuple(e.kind for e in self.active(step))

    def first(self, kind: str) -> Optional[FaultEvent]:
        for e in self.events:
            if e.kind == kind:
                return e
        return None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "events": [e.to_dict() for e in self.events],
        }

    @staticmethod
    def build(
        name: str,
        seed: int,
        kinds: Sequence[str],
        n_steps: int,
        magnitudes: Optional[Dict[str, float]] = None,
    ) -> "FaultSchedule":
        """Deterministic schedule: one window per kind, placed by an
        rng seeded from ``(name, seed)`` alone — str-seeded Random is
        stable across processes, so the bench's subprocess runs and a
        local repro agree on every fault placement."""
        rng = random.Random(f"faultsched:{name}:{seed}")
        magnitudes = magnitudes or {}
        events: List[FaultEvent] = []
        for kind in kinds:
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            # windows land in the middle half of the run: the first
            # steps establish the world, the last steps must observe
            # recovery (the bounded-divergence gate needs both)
            lo = max(1, n_steps // 4)
            hi = max(lo + 1, (3 * n_steps) // 4)
            step = rng.randrange(lo, hi)
            duration = 1 + rng.randrange(0, max(1, n_steps // 8))
            events.append(
                FaultEvent(kind, step, duration, magnitudes.get(kind, 0.0))
            )
        return FaultSchedule(name, seed, events)


class SkewClock:
    """A clock whose reading can be skewed mid-run — the clock_skew
    fault. Wraps a monotonic base so controllers injected with it keep
    their duration math monotonic between skew injections; ``skew()``
    models the wall-clock jump a bad NTP step would cause."""

    def __init__(self, base=time.monotonic, offset: float = 0.0):
        self._base = base
        self.offset = float(offset)

    def __call__(self) -> float:
        return self._base() + self.offset

    def skew(self, delta_s: float) -> None:
        self.offset += float(delta_s)


class RestFaultInjector:
    """Client-side fault injection for RestKubeClient: consulted at the
    adapter's single HTTP choke point (``_request``), addressed by
    request ordinal. Deterministic given the schedule; thread-safe
    (watch threads share one injector)."""

    def __init__(self, schedule: FaultSchedule, sleep=time.sleep):
        self.schedule = schedule
        self._sleep = sleep
        self._mu = threading.Lock()
        self._ordinal = 0
        self.injected: List[Tuple[int, str]] = []  # (ordinal, kind) log

    def __call__(self, method: str, path: str, stream: bool) -> None:
        with self._mu:
            self._ordinal += 1
            ordinal = self._ordinal
        for ev in self.schedule.active(ordinal):
            if ev.kind == "latency_spike":
                with self._mu:
                    self.injected.append((ordinal, ev.kind))
                self._sleep(max(0.0, ev.magnitude) / 1000.0)
            elif ev.kind == "relist_storm" and stream:
                # expired rv on watch re-establishment → client relists
                with self._mu:
                    self.injected.append((ordinal, ev.kind))
                raise ApiError(410, f"injected: {self.schedule.name}")
            elif ev.kind == "watch_flap" and stream:
                with self._mu:
                    self.injected.append((ordinal, ev.kind))
                raise ConnectionResetError(f"injected: {self.schedule.name}")
            elif ev.kind == "error_burst" and stream:
                # the adapter-level face of an expired-rv burst: the
                # stream request itself fails with a server error; the
                # watch loop counts it (reason="http"), backs off
                # without relisting, and resumes from the last rv. The
                # in-stream ERROR-event face is driven by the harness
                # (it owns the event channel; the injector owns the
                # request choke point).
                with self._mu:
                    self.injected.append((ordinal, ev.kind))
                raise ApiError(500, f"injected: {self.schedule.name}")
