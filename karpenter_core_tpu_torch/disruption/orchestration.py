"""Disruption orchestration queue.

Counterpart of ``karpenter_core_tpu/disruption/orchestration.py`` (ref
pkg/controllers/disruption/orchestration/queue.go): per command, wait
for replacements to come up, then delete the candidates; un-do on
failure."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..apis import labels as wk
from ..apis.nodeclaim import COND_INITIALIZED, COND_REGISTERED

QUEUE_TIMEOUT = 10 * 60.0  # queue.go:51 maxRetryDuration


@dataclass
class QueuedCommand:
    """queue.go:139 NewCommand."""

    candidate_provider_ids: List[str]
    candidate_node_names: List[str]
    replacement_names: List[str]
    method: str
    consolidation_type: str
    created: float
    last_error: Optional[str] = None


class OrchestrationQueue:
    # queue timestamps are in-memory timeout anchors, never persisted —
    # monotonic, immune to skew
    def __init__(self, kube_client, cluster, recorder=None, clock: Callable[[], float] = time.monotonic, metrics=None):
        self.kube_client = kube_client
        self.cluster = cluster
        self.recorder = recorder
        self.clock = clock
        self.metrics = metrics
        self.commands: List[QueuedCommand] = []
        self._by_provider: Dict[str, QueuedCommand] = {}

    def add(self, command, replacement_names: List[str], method: str, consolidation_type: str = "") -> None:
        qc = QueuedCommand(
            candidate_provider_ids=[c.provider_id() for c in command.candidates],
            candidate_node_names=[c.name() for c in command.candidates],
            replacement_names=list(replacement_names),
            method=method,
            consolidation_type=consolidation_type,
            created=self.clock(),
        )
        self.commands.append(qc)
        for pid in qc.candidate_provider_ids:
            self._by_provider[pid] = qc

    def has_any(self, provider_id: str) -> bool:
        """queue.go HasAny: a candidate already being disrupted isn't
        eligible again."""
        return provider_id in self._by_provider

    def reconcile(self) -> None:
        """queue.go:158: drive each command forward; requeue on not-ready,
        unwind on timeout."""
        remaining = []
        for qc in self.commands:
            done = self._reconcile_command(qc)
            if not done:
                remaining.append(qc)
            else:
                for pid in qc.candidate_provider_ids:
                    self._by_provider.pop(pid, None)
        self.commands = remaining

    def _reconcile_command(self, qc: QueuedCommand) -> bool:
        if self.clock() - qc.created > QUEUE_TIMEOUT:
            self._unwind(qc, "timed out waiting for replacements")
            return True
        # all replacements must be Registered + Initialized (queue.go:214)
        for name in qc.replacement_names:
            nc = self.kube_client.get("NodeClaim", name)
            if nc is None:
                self._unwind(qc, f"replacement nodeclaim {name} no longer exists")
                return True
            if not (
                nc.status_condition_is_true(COND_REGISTERED)
                and nc.status_condition_is_true(COND_INITIALIZED)
            ):
                qc.last_error = f"waiting on replacement {name}"
                return False
        # replacements ready: delete candidate claims (termination cascades)
        for pid in qc.candidate_provider_ids:
            for nc in self.kube_client.list("NodeClaim"):
                if nc.status.provider_id == pid:
                    self.kube_client.delete(nc)
        if self.metrics is not None:
            self.metrics.nodeclaims_disrupted.inc(
                method=qc.method, count=len(qc.candidate_provider_ids)
            )
        return True

    def _unwind(self, qc: QueuedCommand, reason: str) -> None:
        """Failure path: un-taint, un-mark, surface the error
        (queue.go:214-277)."""
        qc.last_error = reason
        self.cluster.unmark_for_deletion(*qc.candidate_provider_ids)
        for name in qc.candidate_node_names:
            node = self.kube_client.get("Node", name)
            if node is not None:
                node.spec.taints = [
                    t for t in node.spec.taints if t.key != wk.DISRUPTION_TAINT_KEY
                ]
                self.kube_client.apply(node)
