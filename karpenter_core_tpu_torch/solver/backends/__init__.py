"""Plan-quality pack backends.

Counterpart of ``karpenter_core_tpu/solver/backends/__init__.py``. A
``PackBackend`` turns prepared pack jobs — the ``(requests, frontier,
max_per_node)`` tuples plus their finalize metadata — into per-job node
assignments, the contract ``TorchScheduler._pack_and_finalize``
consumes:

    pack_jobs(jobs, metas, device, stats, mesh) -> [(node_ids (P,) int32, node_count)]

aligned with ``jobs``. ``node_ids`` indexes the job's size-sorted pod
order (−1 ⇒ unschedulable) exactly like ``pack.batch_pack``; everything
downstream (usage, cheapest-fitting-type choice, offering pricing,
merge) is backend-agnostic, so a backend only decides the *partition*
of pods into nodes, never the pricing or feasibility rules.

Backends:

- ``ffd``  — first-fit-decreasing (``pack.batch_pack``: the C++ packer,
  or the device scan when ``KARPENTER_TORCH_NATIVE=0``). The default.
- ``lp``   — the LP-relaxation backend (``backends/lp.py``): the
  pod-signature × instance-type assignment LP solved by a dual ascent on
  the scheduler's device, rounded through FFD repair packs, refined and
  branched, and cost-guarded so its plan never prices above FFD's on the
  same job.
- ``auto`` — size-calibrated routing (``calibrate.lp_min_job_work``):
  jobs big enough to amortize the LP route to ``lp``, the rest stay on
  ``ffd``.

Selection: ``KARPENTER_TORCH_PACK_BACKEND`` (default ``ffd``), read per
solve; an unknown name falls back to ``ffd``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

import numpy as np


def job_prices(meta: dict) -> np.ndarray:
    """Per viable type, the cheapest offering price admitted by the
    job's zone/capacity-type requirements (zone-pinned when set) — the
    price model ``TorchScheduler._job_skeleton`` prices packed nodes
    with."""
    from ..solver import _job_prices

    return _job_prices(meta)


class PackBackend:
    """One pack engine behind the multi-backend seam."""

    name: str = "?"

    def __init__(self) -> None:
        # backends are process-global singletons; a solve holds this
        # around pack_jobs and its reads of last_stats/last_job_flags so
        # a concurrent solve cannot overwrite them mid-read
        self.lock = threading.Lock()

    def job_token(self, device=None) -> tuple:
        """Everything about this backend's configuration that can change
        its assignment for fixed job inputs on ``device``."""
        raise NotImplementedError

    #: per-job guard flags of the last pack_jobs call (True ⇒ the job's
    #: partition is cost-guarded downstream); backends that never deviate
    #: from FFD leave it empty
    last_job_flags: List[bool] = []

    def pack_jobs(
        self, jobs: List[tuple], metas: List[dict], device=None, stats=None, mesh=None
    ) -> List[Tuple[np.ndarray, int]]:
        """→ [(node_ids, node_count)] aligned with ``jobs``; device work
        runs on ``device`` (None: the card), or on ``mesh``'s shards
        (``solver/sharding.py``) when one is active."""
        raise NotImplementedError


class FFDBackend(PackBackend):
    """First-fit-decreasing through ``pack.batch_pack``."""

    name = "ffd"

    def job_token(self, device=None) -> tuple:
        return ("ffd",)

    def pack_jobs(
        self, jobs: List[tuple], metas: List[dict], device=None, stats=None, mesh=None
    ) -> List[Tuple[np.ndarray, int]]:
        from ..pack import batch_pack

        self.last_job_flags = [False] * len(jobs)
        return batch_pack(jobs, device=device, mesh=mesh)


class AutoBackend(PackBackend):
    """Size-calibrated routing: a job routes to the LP backend when its
    P·T work clears ``calibrate.lp_min_job_work(device)`` (the LP's fixed
    relax cost is only worth paying where a better partition can move
    real dollars), else it stays on FFD."""

    name = "auto"

    def __init__(self) -> None:
        super().__init__()
        from .lp import LPBackend

        self._ffd = FFDBackend()
        self._lp = LPBackend()

    def _route(self, job: tuple, meta: dict, threshold: int) -> PackBackend:
        if job[0].shape[1] != meta["alloc"].shape[1]:
            # stateful port columns: FFD enforces them; the LP lane
            # would only keep FFD's partition
            return self._ffd
        work = int(job[0].shape[0]) * int(len(meta["viable_idx"]))
        return self._lp if work >= threshold else self._ffd

    def job_token(self, device=None) -> tuple:
        # both lanes' configuration: the routing threshold decides which
        # lane a job takes, the lp lane's token that lane's output
        from ..calibrate import lp_min_job_work

        return ("auto", int(lp_min_job_work(device))) + self._lp.job_token()

    def pack_jobs(
        self, jobs: List[tuple], metas: List[dict], device=None, stats=None, mesh=None
    ) -> List[Tuple[np.ndarray, int]]:
        from ..calibrate import lp_min_job_work

        threshold = lp_min_job_work(device) if jobs else 0
        lanes = [self._route(j, m, threshold) for j, m in zip(jobs, metas)]
        results: List[Optional[Tuple[np.ndarray, int]]] = [None] * len(jobs)
        flags = [False] * len(jobs)
        self.last_stats = {}
        for backend in (self._ffd, self._lp):
            idx = [i for i, b in enumerate(lanes) if b is backend]
            if not idx:
                continue
            packed = backend.pack_jobs(
                [jobs[i] for i in idx], [metas[i] for i in idx], device, stats, mesh
            )
            sub_flags = backend.last_job_flags
            for slot, (i, r) in enumerate(zip(idx, packed)):
                results[i] = r
                if sub_flags:
                    flags[i] = sub_flags[slot]
            if backend is self._lp:
                self.last_stats = dict(backend.last_stats)
        self.last_job_flags = flags
        return results


_BACKENDS: dict = {}

# per-thread backend override: a thread that installs one packs through
# it instead of the process-global singleton
_TLS = threading.local()


def set_thread_backend(backend: Optional[PackBackend]) -> None:
    """Install (or with None, clear) this thread's backend override."""
    _TLS.override = backend


def get_backend(name: str) -> PackBackend:
    """Process-global backend singletons (the LP backend's relaxation
    memo is shared across solvers: it is content-addressed)."""
    b = _BACKENDS.get(name)
    if b is None:
        if name == "ffd":
            b = FFDBackend()
        elif name == "lp":
            from .lp import LPBackend

            b = LPBackend()
        elif name == "auto":
            b = AutoBackend()
        else:
            raise ValueError(f"unknown pack backend: {name!r} (ffd | lp | auto)")
        _BACKENDS[name] = b
    return b


def active_backend() -> PackBackend:
    """The per-solve backend selection (env read each solve). A
    thread-local override wins over the env. Unknown names fall back to
    ffd — a typo in an env var must degrade, not fail solves."""
    override = getattr(_TLS, "override", None)
    if override is not None:
        return override
    name = os.environ.get("KARPENTER_TORCH_PACK_BACKEND", "ffd").strip().lower()
    try:
        return get_backend(name or "ffd")
    except ValueError:
        return get_backend("ffd")


def reset_for_tests() -> None:
    """Drop backend singletons AND the shared relaxation planes (the
    lprelax memo is process-shared across LPBackend instances, so
    clearing the singletons alone would leak it into the next test)."""
    _BACKENDS.clear()
    from . import lp as _lp

    _lp.reset_for_tests()
