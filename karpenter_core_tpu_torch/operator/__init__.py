"""The operator, as far as the chaos pack reads it.

Counterpart of ``karpenter_core_tpu/operator/``: lease-based leader
election (``LeaderElector``). The operator itself, its options and its
singleton controllers are not ported yet; their names raise
``NotImplementedError``.
"""

from .leaderelection import LEASE_NAME, LeaderElector, default_holder_id

_NOT_PORTED = ("Operator", "Options", "SingletonController")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"operator.{name} is not ported to the PyTorch package yet")
    raise AttributeError(name)
