"""Routing calibration of the ``auto`` pack backend.

Counterpart of the LP part of ``karpenter_core_tpu/solver/calibrate.py``
(``lp_calibration``, ``lp_min_job_work``): what routing a pack job
through the LP backend costs over plain FFD, measured once per process
and device on the device that will run it. The compat routing
thresholds of the JAX package are not ported: every pool's compat runs
the one Hopper kernel.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from .backend import resolve_device

_LP_MIN_CLAMP = (1 << 10, 1 << 24)

# per device ("cuda", "cpu", ...): the calibration of that device
_LP_CAL: Dict[str, dict] = {}


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def lp_calibration(device=None, force: bool = False) -> dict:
    """Measure, once per process and device, what routing a pack job
    through the LP backend costs over plain FFD on ``device`` (None: the
    card):

    - ``lp_relax_floor_ms``  — round trip of a tiny dual ascent
      (backends/lp.py ``relax``), the LP's fixed per-job overhead
    - ``lp_refine_floor_ms`` — round trip of a warm-started re-ascent at
      an 8-iteration budget: what each refinement round adds
    - ``pack_ns_per_unit``   — ``pack.batch_pack``'s cost per pod×frontier
      work unit on a bench-shaped micro-run

    and derive ``lp_min_job_work``: the pods×types work where a job's own
    pack time crosses the relax floor — below it ``auto`` keeps the job
    on ffd. Override: KARPENTER_TORCH_LP_MIN_WORK. A build or launch
    failure raises: the reference's quiet fall back to a static threshold
    would hide a broken kernel behind a routing change."""
    dev = resolve_device(device)
    key = str(dev)
    if key in _LP_CAL and not force:
        return _LP_CAL[key]
    out: dict = {"device": key}
    from .backends import lp as lp_mod
    from .pack import batch_pack

    rng = np.random.RandomState(11)
    jobs = []
    for _ in range(8):
        reqs = rng.randint(1, 200, size=(256, 4)).astype(np.int32)
        frontier = np.sort(
            rng.randint(500, 4000, size=(16, 4)).astype(np.int32), axis=0
        )[::-1].copy()
        jobs.append((reqs, frontier, np.int32(110)))
    units = sum(j[0].shape[0] * len(j[1]) for j in jobs)
    batch_pack(jobs, device=dev)  # warm: builds and loads
    pack_s = min(_timed(lambda: batch_pack(jobs, device=dev)) for _ in range(3))
    out["pack_ns_per_unit"] = round(pack_s / units * 1e9, 3)

    reqs = rng.randint(1, 200, size=(8, 4)).astype(np.float64)
    counts = np.ones(8)
    alloc = rng.randint(500, 4000, size=(8, 4)).astype(np.float64)
    prices = rng.rand(8) + 0.5

    def roundtrip():
        lp_mod.relax(reqs, counts, alloc, prices, iters=32, device=dev)

    roundtrip()  # warm: builds and loads
    floor = min(_timed(roundtrip) for _ in range(5))
    out["lp_relax_floor_ms"] = round(floor * 1000.0, 3)
    _, _, _, w_conv = lp_mod.relax(reqs, counts, alloc, prices, iters=32, device=dev)

    def refine_roundtrip():
        lp_mod.relax(reqs, counts, alloc, prices, iters=8, w0=w_conv, device=dev)

    rfloor = min(_timed(refine_roundtrip) for _ in range(5))
    out["lp_refine_floor_ms"] = round(rfloor * 1000.0, 3)
    threshold = int(floor / max(pack_s / units, 1e-12))
    out["lp_min_job_work"] = max(_LP_MIN_CLAMP[0], min(_LP_MIN_CLAMP[1], threshold))
    _LP_CAL[key] = out
    return out


def lp_min_job_work(device=None) -> int:
    """The auto-backend routing threshold (pods × viable types): env
    override > the calibration of ``device``."""
    env = os.environ.get("KARPENTER_TORCH_LP_MIN_WORK")
    if env:
        try:
            return int(env)
        except ValueError:
            pass  # a typo'd override falls through to calibration
    return lp_calibration(device)["lp_min_job_work"]


def reset_for_tests() -> None:
    _LP_CAL.clear()
