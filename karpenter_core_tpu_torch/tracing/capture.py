"""Slow-solve capture: persist any finished trace whose wall time exceeds
a threshold, so a host-time regression seen once leaves a loadable
artifact behind.

The port's copy of ``karpenter_core_tpu/tracing/capture.py``. The
reference's environment knobs are module constants named for their twin,
read per capture (tests and operators set them):

  SLOW_MS   ``KARPENTER_TPU_TRACE_SLOW_MS``: the wall-time threshold in
            ms; None turns capture off, 0 captures every buffered trace
  DIR       ``KARPENTER_TPU_TRACE_DIR``: the output directory (created on
            demand), by default ``karpenter-torch-traces`` under the
            temporary directory: never the reference's, since ``_prune``
            deletes the oldest files of its directory
  KEEP      ``KARPENTER_TPU_TRACE_KEEP``: files kept (oldest pruned)

The flight recorder's breach dumps (flightrec.py) write to the same
directory under the same pruning. Failures are swallowed after a debug
log: the capture path never takes a solve down.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from .tracer import Trace

SLOW_MS: Optional[float] = None
DIR = os.path.join(tempfile.gettempdir(), "karpenter-torch-traces")
KEEP = 100


def maybe_capture(trace: Trace) -> Optional[str]:
    """Write ``trace`` as Chrome trace-event JSON if it crossed the
    slow-solve threshold. Returns the file path, or None."""
    if SLOW_MS is None or trace.total_ms < float(SLOW_MS):
        return None
    out_dir = DIR
    try:
        from .export import to_chrome_json

        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"solve-{trace.wall_start:.3f}-{trace.trace_id}.trace.json")
        with open(path, "w") as f:
            f.write(to_chrome_json([trace]))
        _prune(out_dir)
        return path
    except OSError:
        logging.getLogger("karpenter").debug("slow-solve trace capture failed", exc_info=True)
        return None


def _prune(out_dir: str) -> None:
    """Keep the newest ``KEEP`` capture files of ``out_dir``."""
    try:
        files = sorted(f for f in os.listdir(out_dir) if f.endswith(".trace.json"))
        for name in files[: max(0, len(files) - int(KEEP))]:
            os.unlink(os.path.join(out_dir, name))
    except OSError:
        pass
