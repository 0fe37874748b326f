"""Lifecycle controllers: the port's copy of ``karpenter_core_tpu/lifecycle/``.

NodeClaim launch, registration, initialization and liveness; NodeClaim
and Node termination (taint, drain through the eviction queue, provider
delete); NodeClaim and node-lease garbage collection; the consistency
checks; the NodePool hash and counter controllers.
"""

from .nodeclaim_lifecycle import NodeClaimLifecycleController
from .nodeclaim_termination import NodeClaimTerminationController
from .nodeclaim_gc import NodeClaimGarbageCollectionController
from .node_termination import NodeTerminationController, Terminator, EvictionQueue
from .consistency import ConsistencyController
from .nodepool_controllers import NodePoolCounterController, NodePoolHashController
from .lease_gc import LeaseGarbageCollectionController
