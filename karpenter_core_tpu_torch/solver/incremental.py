"""Content-addressed memo pieces of the JAX package's incremental layer.

Counterpart of the parts of ``karpenter_core_tpu/solver/incremental.py``
that the LP backend's relaxation memo (the ``lprelax`` plane,
``backends/lp.py``) rests on: the bounded ``LRU`` with its per-solve
``CacheStats``, the cap of that one cache, and ``job_digest``. Reuse is
memoization, never approximation: every key is the exact content of a
deterministic computation. The warm store, the job and merge memos and
the solve replay are not ported.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

# LRU caps (entries), one per cache: the JAX package's
# KARPENTER_TPU_LPRELAX_CACHE_MAX default
_CAPS = {"lprelax": 512}


def cache_cap(name: str) -> int:
    return _CAPS[name]


class CacheStats:
    """Per-solve hit/miss/eviction counters, one bucket per cache."""

    __slots__ = ("hits", "misses", "evictions")

    def __init__(self) -> None:
        self.hits: Dict[str, int] = {}
        self.misses: Dict[str, int] = {}
        self.evictions: Dict[str, int] = {}

    def hit(self, cache: str, n: int = 1) -> None:
        self.hits[cache] = self.hits.get(cache, 0) + n

    def miss(self, cache: str, n: int = 1) -> None:
        self.misses[cache] = self.misses.get(cache, 0) + n

    def evict(self, cache: str, n: int = 1) -> None:
        self.evictions[cache] = self.evictions.get(cache, 0) + n

    def to_dict(self) -> dict:
        out: dict = {"hits": dict(self.hits), "misses": dict(self.misses)}
        if self.evictions:
            out["evictions"] = dict(self.evictions)
        total_h = sum(self.hits.values())
        total = total_h + sum(self.misses.values())
        if total:
            out["hit_rate"] = round(total_h / total, 4)
        return out


class LRU:
    """Tiny thread-safe LRU with per-operation stats accounting."""

    def __init__(self, name: str):
        self.name = name
        self._d: OrderedDict = OrderedDict()
        self._mu = threading.Lock()

    def get(self, key, stats: Optional[CacheStats] = None):
        with self._mu:
            v = self._d.get(key)
            if v is None:
                if stats is not None:
                    stats.miss(self.name)
                return None
            self._d.move_to_end(key)
        if stats is not None:
            stats.hit(self.name)
        return v

    def put(self, key, value, stats: Optional[CacheStats] = None) -> None:
        cap = cache_cap(self.name)
        with self._mu:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > cap:
                self._d.popitem(last=False)
                if stats is not None:
                    stats.evict(self.name)

    def __len__(self) -> int:
        with self._mu:
            return len(self._d)

    def items(self) -> list:
        """Point-in-time (key, value) snapshot in LRU order, oldest first."""
        with self._mu:
            return list(self._d.items())

    def clear(self) -> None:
        with self._mu:
            self._d.clear()


def job_digest(reqs: np.ndarray) -> bytes:
    """Collision-safe digest of a job's sorted request matrix (the key
    must not alias two different packings: 128-bit blake2b)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(reqs.tobytes())
    h.update(str(reqs.shape).encode())
    return h.digest()
