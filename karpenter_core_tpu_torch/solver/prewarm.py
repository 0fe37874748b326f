"""Boot prewarm: pay a process's one-time device costs before its first
authoritative solve.

The reference replays the restored ``jitsig`` inventory through its
jitted functions so a restored process's first solve compiles nothing
(``karpenter_core_tpu/solver/prewarm.py``). The port has no jit: its
one-time costs are loading the kernel libraries (``dlopen`` of each
``csrc/*.cu`` build and of the C++ packer, building them first when the
build directory lacks them) and, on the card, the LP routing's
calibration (``calibrate.lp_calibration``). ``warmup_compile_only``
pays exactly those, on the solver's device:

- on a CUDA device, every ``CudaKernel`` library of the solve path
  (compat, the FFD scan, the existing-node first-fit, the dual ascent),
  every kernel the restored library manifest names
  (``backend.restored_manifest()``, the warm store's ``compilecache``
  plane: the disruption screens where the snapshot's process loaded
  them), and the calibration;
- the C++ packer unless ``KARPENTER_TORCH_NATIVE=0`` turns it off.

The loads run inside ``deviceplane.prewarm_scope()``: their compile
events carry ``cause=prewarm_replay`` and never reach a solve's count,
so a restored process's first solve loads nothing and counts 0. A CPU
solver launches no kernel (its wrappers take the plain versions), so
nothing of the card is loaded for it. A failure raises: a prewarm never
degrades silently. The outcome (libraries, compile events, milliseconds)
is kept for ``last_result()`` and the stats' device block.

Boot order (serving pipeline): restore → prewarm → tick 0. The
reference's ``KARPENTER_TPU_PREWARM`` kill switch is the constant
``PREWARM``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

# the reference's KARPENTER_TPU_PREWARM (on)
PREWARM = True

#: most recent prewarm outcome (stats device block, /debug)
_LAST: Optional[dict] = None


def enabled() -> bool:
    return bool(PREWARM)


def last_result() -> Optional[dict]:
    return dict(_LAST) if _LAST is not None else None


def reset_for_tests() -> None:
    global _LAST
    _LAST = None


def solve_kernels() -> dict:
    """The solve path's kernel wrappers, by kernel name."""
    from . import compat_kernels, pack
    from .backends import lp

    return {
        "compat_allowed": compat_kernels.COMPAT_ALLOWED,
        "ffd_pack": pack.FFD_PACK,
        "pack_existing": pack.PACK_EXISTING,
        "dual_ascent": lp.DUAL_ASCENT,
    }


def warmup_compile_only(solver: Any = None) -> dict:
    """Load the libraries ``solver``'s path launches and, on the card,
    calibrate the LP routing → the outcome: ``status`` (ok | disabled),
    the ``device``, the ``libraries`` loaded, ``compile_events`` (the
    loads this call made), ``calibration`` (its numbers, None off the
    card) and ``prewarm_ms``. ``solver`` None (or a solver without a
    device) means the card; its ``metrics`` take the compile events.
    Raises on any failure."""
    global _LAST
    t0 = time.perf_counter()
    if not enabled():
        _LAST = {"status": "disabled", "device": None, "libraries": [], "compile_events": 0,
                 "calibration": None, "prewarm_ms": 0.0}
        return dict(_LAST)
    from .. import buildlib, native
    from ..tracing import deviceplane
    from .backend import resolve_device, restored_manifest

    device = resolve_device(getattr(solver, "device", None))
    libraries = []
    calibration = None
    with deviceplane.prewarm_scope() as events:
        if device.type == "cuda":
            import torch

            torch.cuda.init()
            # by the device plane's names: the solve path's and the manifest's
            kernels = {k.name: k for k in solve_kernels().values()}
            for row in restored_manifest():
                for name in row["kernels"]:
                    kernels.setdefault(name, buildlib.KERNELS[name])
            for name, kernel in kernels.items():
                kernel.lib()
                libraries.append(name)
        if native.available():
            native.load()
            libraries.append("native_pack")
    metrics = getattr(solver, "metrics", None)
    if metrics is not None:
        for ev in events:
            metrics.xla_compiles.inc(1, fn=ev["fn"], cause=ev["cause"])
    if device.type == "cuda":
        from . import calibrate

        calibration = calibrate.lp_calibration(device)
    _LAST = {
        "status": "ok",
        "device": str(device),
        "libraries": libraries,
        "compile_events": len(events),
        "calibration": calibration,
        "prewarm_ms": round((time.perf_counter() - t0) * 1000.0, 3),
    }
    return dict(_LAST)
