"""CloudProvider metrics decorator (ref
pkg/cloudprovider/metrics/cloudprovider.go): wraps every SPI method with
duration + error counters.

The port's copy of ``karpenter_core_tpu/cloudprovider/metrics.py``. The
operator hands every controller the decorator, so it is the one provider
identity the solver's per-provider catalog cache and warm memos see
across ticks; other attributes pass through to the inner provider."""

from __future__ import annotations

import time
from typing import List, Optional

from ..apis.nodeclaim import NodeClaim
from ..apis.nodepool import NodePool
from .types import CloudProvider, InstanceType


class MetricsDecorator(CloudProvider):
    def __init__(self, inner: CloudProvider, metrics):
        self.inner = inner
        self.metrics = metrics

    def _measure(self, method: str, fn):
        start = time.perf_counter()
        try:
            return fn()
        except Exception:
            self.metrics.cloudprovider_errors.inc(method=method, provider=self.inner.name())
            raise
        finally:
            self.metrics.cloudprovider_duration.observe(
                time.perf_counter() - start, method=method, provider=self.inner.name()
            )

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        return self._measure("Create", lambda: self.inner.create(node_claim))

    def delete(self, node_claim: NodeClaim) -> None:
        return self._measure("Delete", lambda: self.inner.delete(node_claim))

    def get(self, provider_id: str) -> NodeClaim:
        return self._measure("Get", lambda: self.inner.get(provider_id))

    def list(self) -> List[NodeClaim]:
        return self._measure("List", lambda: self.inner.list())

    def get_instance_types(self, nodepool: Optional[NodePool]) -> List[InstanceType]:
        return self._measure("GetInstanceTypes", lambda: self.inner.get_instance_types(nodepool))

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self._measure("IsDrifted", lambda: self.inner.is_drifted(node_claim))

    def name(self) -> str:
        return self.inner.name()

    # passthrough for fakes' test hooks
    def __getattr__(self, item):
        return getattr(self.inner, item)
