"""The fleet: many tenant clusters multiplexed through one device.

Counterpart of ``karpenter_core_tpu/fleet/``. A single-cluster solve
pays its whole dispatch floor however small the tenant; the fleet shares
it:

- ``registry``: per-tenant provider, cluster and solver handles on the
  registry's device, strictly isolated (no provider or cluster object
  serves two tenants; every identity- or generation-scoped memo carries
  the tenant scope);
- ``megasolve``: the mega-solve engine. Tenants' pack calls coalesce into
  one call of the pack backend (with ``KARPENTER_TORCH_NATIVE=0``, FFD
  scan launches that carry several tenants' jobs), catalog archetypes
  dedupe onto canonical content-addressed entries, and job skeletons
  ride a fleet-wide content plane. ``KARPENTER_TORCH_FLEET_ENGINE``
  (``batched`` | ``solo``): solo, independent per-tenant solves, is the
  plan-identity oracle;
- ``scheduler``: bounded admission, deficit-round-robin fairness across
  tenants, a batch window, per-tenant decision latency.
"""

from .megasolve import FleetEngine, TenantOutcome, fleet_engine_name
from .registry import FleetRegistry, TenantHandle
from .scheduler import FleetScheduler

__all__ = [
    "FleetEngine",
    "FleetRegistry",
    "FleetScheduler",
    "TenantHandle",
    "TenantOutcome",
    "fleet_engine_name",
]
