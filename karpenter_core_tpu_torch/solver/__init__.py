"""The batched provisioning solve on PyTorch and CUDA.

1. ``vocab``/``encode``: requirements → boolean masks over per-key value
   vocabularies; resources → quantized int32 matrices (host numpy).
2. ``kernels``/``compat_kernels``: the signature × type compat ∧
   offering matrix — one hand-written Hopper kernel launch per pool
   (``csrc/compat_allowed.cu``), plain PyTorch versions beside it.
3. ``pack``: K-open first-fit-decreasing on the C++ packer
   (``native/pack.cc``); cheapest-type assignment.
4. ``merge``: the bucketed, vectorized cross-group merge.
5. ``solver``: ``TorchScheduler``, from pods to NodePlans; the groups
   the tensor path does not take go to the greedy scheduler
   (``scheduler/``), failed relaxable groups through the preference
   ladder and another tensor pass.
6. ``oracle_bridge``: the greedy scheduler's instance-type filter as
   numpy vectors over the catalog's host encodings.
"""

from .solver import NodePlan, SolverResult, TorchScheduler

__all__ = ["NodePlan", "SolverResult", "TorchScheduler"]
