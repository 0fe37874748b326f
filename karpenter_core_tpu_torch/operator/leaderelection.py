"""Lease-based leader election (ref pkg/operator/operator.go:121-124:
LeaderElection over the Leases resource lock, id
"karpenter-leader-election", in the operator's namespace).

The port's copy of ``karpenter_core_tpu/operator/leaderelection.py``,
over the port's ``KubeClient`` (or ``RestKubeClient``) and ``Lease``.

The algorithm is client-go's leaderelection.LeaderElector, expressed
over this build's kube store and its optimistic-concurrency update:
every ``retry_period`` each candidate runs one try_acquire_or_renew
step: create the Lease if absent, take it over if expired, renew it
if held. A Conflict from the store means another candidate's write
landed first, so the step simply loses this round. Correctness rides
on the store's resourceVersion check, exactly as the real thing rides
on the apiserver's.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import uuid
from typing import Callable, Optional

from ..kube.client import Conflict, NotFound
from ..kube.objects import Lease

LEASE_NAME = "karpenter-leader-election"


def default_holder_id() -> str:
    # client-go convention: hostname + a unique suffix, so two operators
    # on one host still get distinct identities
    return f"{os.uname().nodename}_{uuid.uuid4().hex[:8]}"


class LeaderElector:
    def __init__(
        self,
        kube_client,
        holder_id: Optional[str] = None,
        namespace: str = "default",
        lease_name: str = LEASE_NAME,
        lease_duration: float = 15.0,
        retry_period: float = 2.0,
        # analysis: allow-clock(lease renew_time crosses processes — wall clock by leader-election protocol)
        clock: Callable[[], float] = time.time,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.kube_client = kube_client
        self.holder_id = holder_id or default_holder_id()
        self.namespace = namespace
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self.clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def is_leader(self) -> bool:
        return self._leader

    # -- one election step --------------------------------------------------

    def _expired(self, lease: Lease, now: float) -> bool:
        if not lease.holder:
            return True
        duration = lease.lease_duration_seconds or self.lease_duration
        renewed = lease.renew_time if lease.renew_time is not None else 0.0
        return now > renewed + duration

    def try_acquire_or_renew(self) -> bool:
        """One leaderelection.go tryAcquireOrRenew step; returns whether
        this candidate holds the lease afterwards."""
        now = self.clock()
        lease = self.kube_client.get("Lease", self.lease_name, namespace=self.namespace)
        if lease is None:
            fresh = Lease(
                holder=self.holder_id,
                lease_duration_seconds=int(self.lease_duration),
                acquire_time=now,
                renew_time=now,
            )
            fresh.metadata.name = self.lease_name
            fresh.metadata.namespace = self.namespace
            try:
                self.kube_client.create(fresh)
            except Conflict:
                return self._observe(False)
            return self._observe(True)

        if lease.holder != self.holder_id and not self._expired(lease, now):
            return self._observe(False)

        # ours to renew, or expired and up for grabs — write through a
        # copy so losing the race leaves the stored lease untouched
        target = copy.deepcopy(lease)
        if target.holder != self.holder_id:
            target.lease_transitions += 1
            target.acquire_time = now
        target.holder = self.holder_id
        target.lease_duration_seconds = int(self.lease_duration)
        target.renew_time = now
        try:
            self.kube_client.update(target)
        except (Conflict, NotFound):
            return self._observe(False)
        return self._observe(True)

    def release(self) -> None:
        """client-go ReleaseOnCancel: clear the holder so a successor
        acquires immediately instead of waiting out the lease."""
        lease = self.kube_client.get("Lease", self.lease_name, namespace=self.namespace)
        if lease is None or lease.holder != self.holder_id:
            # someone else already took (or removed) the lease — we are
            # certainly not leading; make the local state and callbacks agree
            self._observe(False)
            return
        target = copy.deepcopy(lease)
        target.holder = ""
        target.renew_time = None
        try:
            self.kube_client.update(target)
        except (Conflict, NotFound):
            pass
        self._observe(False)

    def _observe(self, leading: bool) -> bool:
        if leading and not self._leader:
            self._leader = True
            if self.on_started_leading is not None:
                self.on_started_leading()
        elif not leading and self._leader:
            self._leader = False
            if self.on_stopped_leading is not None:
                self.on_stopped_leading()
        return leading

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        self.try_acquire_or_renew()  # synchronous first step

        def loop():
            while not self._stop.wait(self.retry_period):
                try:
                    self.try_acquire_or_renew()
                except Exception:  # noqa: BLE001 — election never kills the operator
                    self._observe(False)

        self._thread = threading.Thread(target=loop, name="leader-election", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.release()
