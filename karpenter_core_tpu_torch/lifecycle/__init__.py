"""Lifecycle controllers, as far as disruption reads them.

Counterpart of ``karpenter_core_tpu/lifecycle/``: the NodePool hash and
counter controllers and the PDB budget of node termination. The other
controllers are not ported yet; their names raise ``NotImplementedError``.
"""

from .nodepool_controllers import NodePoolCounterController, NodePoolHashController

_NOT_PORTED = (
    "NodeClaimLifecycleController",
    "NodeClaimTerminationController",
    "NodeClaimGarbageCollectionController",
    "NodeTerminationController",
    "Terminator",
    "EvictionQueue",
    "ConsistencyController",
    "LeaseGarbageCollectionController",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"lifecycle.{name} is not ported to the PyTorch package yet")
    raise AttributeError(name)
