"""The greedy per-pod scheduler, the port's copy of
``karpenter_core_tpu/scheduler/``: the correctness oracle of the batched
solve and its fallback for the groups the tensor path does not take
(``scheduler``, ``nodeclaim``, ``existingnode``, ``queue``,
``preferences``, ``builder``), the topology engine, whose counting half
also seeds the solve's spread and affinity quotas (``topology``), and
the PVC zone pins (``volumetopology``)."""

from .scheduler import Scheduler, SchedulerOptions, Results
from .nodeclaim import NodeClaimTemplate, SchedulingNodeClaim
from .existingnode import ExistingNode
from .topology import Topology, TopologyGroup
from .queue import Queue
from .preferences import Preferences
