"""Disruption: the consolidation loop on PyTorch and CUDA.

Counterpart of ``karpenter_core_tpu/disruption/``.
``DisruptionController.reconcile`` runs the methods in priority order;
the consolidation methods decide through ``BatchedDisruptionEngine``,
whose capacity screens are the Hopper kernel ``csrc/disrupt_screen.cu``
(``screen_kernels``), then verify with warm ``TorchScheduler``
simulations on the provisioner's device.
"""

from .controller import DisruptionController
from .types import Candidate, Command, ACTION_DELETE, ACTION_REPLACE, ACTION_NOOP
from .orchestration import OrchestrationQueue
from .markers import NodeClaimDisruptionController
