"""The part of node termination that disruption reads.

Counterpart of ``pdb_disruptions_allowed`` in
``karpenter_core_tpu/lifecycle/node_termination.py``. The termination
controller itself (taint, drain, evict, provider delete) is not ported
yet: its names raise ``NotImplementedError``.
"""

from __future__ import annotations


def pdb_disruptions_allowed(kube_client, pdb) -> int:
    """Dynamic budget, like the real PDB controller: recomputed from the
    current health of matching pods so evictions consume it and healthy
    replacements replenish it. Falls back to the static field when neither
    minAvailable nor maxUnavailable is set."""
    matching = [
        p
        for p in kube_client.list("Pod", namespace=pdb.namespace)
        if pdb.selector.matches(p.metadata.labels)
    ]
    healthy = sum(
        1
        for p in matching
        if p.status.phase == "Running" and p.metadata.deletion_timestamp is None
    )
    if pdb.min_available is not None:
        return healthy - pdb.min_available
    if pdb.max_unavailable is not None:
        unavailable = len(matching) - healthy
        return pdb.max_unavailable - unavailable
    return pdb.disruptions_allowed


_NOT_PORTED = ("NodeTerminationController", "Terminator", "EvictionQueue", "NodeDrainError")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"node_termination.{name} is not ported to the PyTorch package yet")
    raise AttributeError(name)
