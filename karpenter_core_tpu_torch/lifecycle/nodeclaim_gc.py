"""NodeClaim garbage collection (ref
pkg/controllers/nodeclaim/garbagecollection/controller.go:57-99): every
2 min, diff the cloud provider's machines against cluster NodeClaims and
delete claims whose instance vanished (launched >10 s ago).

The port's copy of ``karpenter_core_tpu/lifecycle/nodeclaim_gc.py``."""

from __future__ import annotations

import time
from typing import Callable

from ..apis.nodeclaim import COND_LAUNCHED
from ..cloudprovider.types import CloudProvider

LAUNCH_GRACE = 10.0  # seconds a claim must have been launched before GC


class NodeClaimGarbageCollectionController:
    # analysis: allow-clock(GC grace vs persisted creation_timestamp wall-clock stamps)
    def __init__(self, kube_client, cloud_provider: CloudProvider, clock: Callable[[], float] = time.time):
        self.kube_client = kube_client
        self.cloud_provider = cloud_provider
        self.clock = clock

    def reconcile(self) -> int:
        """Returns the number of claims garbage-collected."""
        cloud_ids = {nc.status.provider_id for nc in self.cloud_provider.list()}
        removed = 0
        now = self.clock()
        for nc in self.kube_client.list("NodeClaim"):
            if nc.metadata.deletion_timestamp is not None:
                continue
            cond = nc.get_condition(COND_LAUNCHED)
            if cond is None or cond.status != "True":
                continue
            if now - cond.last_transition_time < LAUNCH_GRACE:
                continue
            if nc.status.provider_id and nc.status.provider_id not in cloud_ids:
                self.kube_client.delete(nc)
                removed += 1
        # also GC managed nodes whose backing instance is gone and that have
        # no claim left to cascade their deletion
        claim_ids = {
            nc.status.provider_id for nc in self.kube_client.list("NodeClaim")
        }
        from ..apis import labels as wk

        for node in self.kube_client.list("Node"):
            pid = node.spec.provider_id
            managed = wk.NODEPOOL_LABEL_KEY in node.metadata.labels
            if pid and managed and pid not in cloud_ids and pid not in claim_ids:
                self.kube_client.delete(node)
        return removed
