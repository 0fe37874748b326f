"""Fleet scheduler: bounded admission, deficit-round-robin fairness,
batch-window coalescing, per-tenant decision latency.

Counterpart of ``karpenter_core_tpu/fleet/scheduler.py``.

- Admission is backpressure, never loss: ``submit`` blocks while a
  tenant's queue holds ``FLEET_ADMIT_CAP`` pods.
- Fairness is deficit round robin over pods: each round every tenant
  with queued work earns ``FLEET_QUANTUM`` pods on top of its carried
  deficit and is admitted up to that budget, in a fixed rotation. A
  hog's backlog drains a quantum a round while every small tenant's
  whole backlog (at most a quantum) goes in its next round.
- Latency: a pod's arrival is stamped at ``submit`` and its decision
  when the round that admitted it returns, per tenant
  (``serving/latency.py``) and in the fleet histogram; each admitted
  tenant's round is one flight-recorder record of kind ``fleet``.

The JAX package's ``KARPENTER_TPU_FLEET_QUANTUM``, ``_WINDOW_MS`` and
``_ADMIT_CAP`` are module constants here with its defaults.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..tracing import flightrec, tracer
from .megasolve import FleetEngine, TenantOutcome

# pods a tenant earns a round
FLEET_QUANTUM = 1000
# the background loop's batch window before each round
FLEET_WINDOW_MS = 2.0
# pods a tenant may hold queued before submit blocks
FLEET_ADMIT_CAP = 10_000
# submitter trace links kept per tenant between rounds (newest win)
_LINKS_KEEP = 64

log = logging.getLogger("karpenter.torch.fleet")


class FleetScheduler:
    def __init__(
        self,
        engine: FleetEngine,
        metrics=None,
        quantum: Optional[int] = None,
        window_s: Optional[float] = None,
        on_round: Optional[Callable[[int, Dict[str, TenantOutcome]], None]] = None,
    ):
        self.engine = engine
        self.registry = engine.registry
        self.metrics = metrics
        self.quantum = quantum or max(1, int(FLEET_QUANTUM))
        self.window_s = max(0.0, FLEET_WINDOW_MS / 1000.0 if window_s is None else window_s)
        self.admit_cap = max(1, int(FLEET_ADMIT_CAP))
        self.on_round = on_round
        burn_gauge = getattr(metrics, "decision_slo_burn", None)
        if burn_gauge is not None:
            flightrec.RECORDER.attach_burn_gauge(burn_gauge)
        # re-entrant: _admit_locked runs under run_round's hold
        self._cv = threading.Condition(threading.RLock())
        self._queues: Dict[str, deque] = {}
        # per tenant, the submitters' trace ids since its last admission
        self._pending_links: Dict[str, deque] = {}
        self._deficit: Dict[str, float] = {}
        self._rotation: List[str] = []  # arrival order, stable across rounds
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.tick = 0
        self.rounds_run = 0
        self._blocked_submits = 0
        self._submitted = 0
        self._decided = 0
        # per-round admissions, bounded (fairness witnesses)
        self.round_log: deque = deque(maxlen=64)

    # -- admission ---------------------------------------------------------------

    def submit(self, tenant_id: str, pods: list, timeout: Optional[float] = None) -> bool:
        """Queue pods for one tenant, blocking while its queue is full
        (never dropping). False only on timeout; an unknown tenant raises."""
        tenant_id = str(tenant_id)
        handle = self.registry.get(tenant_id)
        if handle is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            q = self._queues.get(tenant_id)
            if q is None:
                q = self._queues[tenant_id] = deque()
                self._rotation.append(tenant_id)
            blocked = False
            for pod in pods:
                while len(q) >= self.admit_cap and not self._stop:
                    if not blocked:
                        blocked = True
                        self._blocked_submits += 1
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return False
                    self._cv.wait(timeout=remaining)
                if self._stop:
                    return False
                q.append(pod)
                self._submitted += 1
                handle.latency.pod_pending(pod.uid, step=self.tick)
            ctx = tracer.capture()
            if ctx is not None:
                self._pending_links.setdefault(tenant_id, deque(maxlen=_LINKS_KEEP)).append(ctx.trace_id)
            self._cv.notify_all()
        return True

    def queued(self, tenant_id: Optional[str] = None) -> int:
        with self._cv:
            if tenant_id is not None:
                return len(self._queues.get(str(tenant_id), ()))
            return sum(len(q) for q in self._queues.values())

    def forget_tenant(self, tenant_id: str) -> int:
        """Drop a removed tenant's queue (its pods forgotten, not decided)."""
        tenant_id = str(tenant_id)
        handle = self.registry.get(tenant_id)
        with self._cv:
            q = self._queues.pop(tenant_id, None)
            if tenant_id in self._rotation:
                self._rotation.remove(tenant_id)
            self._deficit.pop(tenant_id, None)
            self._pending_links.pop(tenant_id, None)
            dropped = len(q) if q else 0
            if handle is not None and q:
                for pod in q:
                    handle.latency.forget(pod.uid)
            self._cv.notify_all()
        return dropped

    # -- rounds ------------------------------------------------------------------

    def _admit_locked(self) -> Dict[str, list]:
        """Deficit-round-robin admission."""
        admitted: Dict[str, list] = {}
        with self._cv:
            for tid in list(self._rotation):
                q = self._queues.get(tid)
                if not q:
                    self._deficit[tid] = 0.0  # an emptied queue carries no credit
                    continue
                budget = self._deficit.get(tid, 0.0) + self.quantum
                take = min(len(q), int(budget))
                if take > 0:
                    admitted[tid] = [q.popleft() for _ in range(take)]
                self._deficit[tid] = 0.0 if not q else budget - take
        return admitted

    def run_round(self) -> Dict[str, TenantOutcome]:
        """One synchronous round: admit, mega-solve, decide."""
        with self._cv:
            admitted = self._admit_locked()
            self.tick += 1
            tick = self.tick
            links = {tid: list(self._pending_links.pop(tid, ())) for tid in admitted if self._pending_links.get(tid)}
            if admitted:
                self.round_log.append({
                    "tick": tick,
                    "admitted": {t: len(p) for t, p in admitted.items()},
                    "deficits": {t: d for t, d in self._deficit.items() if d},
                })
            self._cv.notify_all()  # admission freed queue space
        if not admitted:
            return {}
        outcomes = self.engine.solve_round(admitted, links=links)
        max_deficit = 0.0
        with self._cv:
            self.rounds_run += 1
            if self._deficit:
                max_deficit = max(self._deficit.values())
            self._decided += sum(len(p) for p in admitted.values())
        for tid, pods in admitted.items():
            handle = self.registry.get(tid)
            out = outcomes.get(tid)
            if handle is None:
                continue
            solve_tid = handle.solver.last_trace_id
            settled = handle.latency.pods_decided(
                [p.uid for p in pods], tick, error=out is None or out.error is not None, trace_id=solve_tid
            )
            self._flight_record(tid, tick, handle, out, pods, settled, solve_tid)
        if self.metrics is not None:
            self.metrics.fleet_fairness_deficit.set(float(max_deficit))
            for tid, pods in admitted.items():
                handle = self.registry.get(tid)
                if handle is None:
                    continue
                solve_tid = handle.solver.last_trace_id
                for s in handle.latency.decisions()[-len(pods):]:
                    self.metrics.fleet_decision_latency.observe(s[1], exemplar=solve_tid)
        if self.on_round is not None:
            self.on_round(tick, outcomes)
        return outcomes

    def _flight_record(self, tid, tick, handle, out, pods, settled, solve_tid) -> None:
        """One record of kind ``fleet`` per admitted tenant a round: its
        pods went pending at submit and were decided when this round
        returned."""
        try:
            from ..solver import stats as solver_stats

            flightrec.RECORDER.record(
                "fleet",
                tick,
                trace=tracer.RING.get(solve_tid) if solve_tid else None,
                solve=solver_stats.solve_stats(handle.solver),
                latency_ms=[s * 1000.0 for s in settled],
                pods_decided=len(pods),
                errors=1 if (out is None or out.error is not None) else 0,
                tenant=tid,
            )
        except Exception:  # noqa: BLE001 — telemetry must never fail the round
            log.debug("fleet flight record failed", exc_info=True)

    def run_until_idle(self, max_rounds: int = 1_000_000) -> int:
        """Rounds until every queue drains → the rounds run."""
        n = 0
        while self.queued() and n < max_rounds:
            self.run_round()
            n += 1
        return n

    # -- background loop ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        with self._cv:
            self._stop = False
        self._thread = threading.Thread(target=self._loop, name="fleet-scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not any(self._queues.values()):
                    self._cv.wait(timeout=0.25)
                if self._stop:
                    return
            if self.window_s:
                time.sleep(self.window_s)  # let concurrent streams join the round
            self.run_round()

    # -- introspection -----------------------------------------------------------

    def debug_state(self) -> dict:
        with self._cv:
            return {
                "tick": self.tick,
                "rounds": self.rounds_run,
                "submitted": self._submitted,
                "decided": self._decided,
                "blocked_submits": self._blocked_submits,
                "queued": {t: len(q) for t, q in self._queues.items() if q},
                "deficits": {t: d for t, d in self._deficit.items() if d},
                "quantum": self.quantum,
                "admit_cap": self.admit_cap,
                "round_log": list(self.round_log)[-8:],
            }
