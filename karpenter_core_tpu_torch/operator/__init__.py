"""The operator: the port's copy of ``karpenter_core_tpu/operator/``.

``Operator`` is the composition root (every controller of the
reference's ``controllers.go``, on one device), with its ``Options``
(the upstream operator's environment flags), its ``SingletonController``
loops, the served operational surface and lease-based leader election.
"""

from .options import Options
from .operator import Operator
from .controller import SingletonController
from .leaderelection import LEASE_NAME, LeaderElector, default_holder_id
