"""Device resolution for the port.

The JAX package probes TPU platforms with bounded subprocess checks and
falls back to the CPU (``karpenter_core_tpu/solver/backend.py``). The
port asks for one explicit ``torch.device``: ``None`` means the card,
and a CUDA device that is not there raises instead of carrying on on
the CPU.

It also keeps the manifest of the kernel libraries (below), the port's
counterpart of the reference's managed compile cache.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: the port runs on cuda or cpu")
    return dev


# -- the kernel libraries' manifest (the warm store's compilecache plane) -----
#
# The reference's compile-cache plane witnesses its XLA executable cache.
# The port's counterpart is the set of ``_build/`` kernel libraries a
# process loaded, each named by the hash of its source and its nvcc
# command (``buildlib.library_path``). A restore keeps the rows the live
# tree would build to the same library and drops the others, and the boot
# prewarm (solver/prewarm.py) loads the kept rows' kernels. The manifest
# rides the environment's fingerprint (``compile_cache_fingerprint``): a
# library built by another torch or CUDA toolkit, or for another device,
# is never trusted, whatever its name.

_MANIFEST_LOCK = threading.Lock()
_RESTORED: Optional[List[dict]] = None


def init_cuda(device) -> None:
    """Create ``device``'s CUDA context now (a card only), the cost a
    first solve would otherwise pay."""
    if resolve_device(device).type == "cuda":
        torch.cuda.init()


def compile_cache_fingerprint() -> dict:
    """What the kernel libraries of this process were built for and
    from: the torch and CUDA versions, the card's compute capability
    (empty without a card) and the digest of each ``csrc/*.cu`` source.
    The warm store records it beside the manifest, and a restore keeps
    the manifest only where it equals the live one."""
    import hashlib

    from .. import buildlib

    capability = ""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        capability = f"sm_{major}{minor}"
    sources = {}
    for name in sorted(os.listdir(buildlib.CSRC)):
        if name.endswith(".cu"):
            with open(os.path.join(buildlib.CSRC, name), "rb") as f:
                sources[name] = hashlib.sha256(f.read()).hexdigest()[:16]
    return {"torch": torch.__version__, "cuda": torch.version.cuda or "", "capability": capability,
            "sources": sources}


def restore_library_manifest(rows) -> Tuple[List[dict], int]:
    """Witness a snapshot's manifest against the live tree → (kept rows,
    dropped count). A row is kept when its source exists, the live tree
    would build it to the same library file and every kernel it names is
    one this process binds; the kept rows are what the boot prewarm
    loads."""
    global _RESTORED
    from .. import buildlib

    kept: List[dict] = []
    dropped = 0
    for row in rows or ():
        try:
            source, library, kernels = str(row["source"]), str(row["library"]), [str(k) for k in row["kernels"]]
        except (KeyError, TypeError, ValueError):
            dropped += 1
            continue
        if (
            not os.path.exists(os.path.join(buildlib.CSRC, source))
            or os.path.basename(buildlib.kernel_library_path(source)) != library
            or any(k not in buildlib.KERNELS for k in kernels)
        ):
            dropped += 1
            continue
        kept.append({"source": source, "library": library, "kernels": kernels})
    with _MANIFEST_LOCK:
        _RESTORED = kept
    return kept, dropped


def restored_manifest() -> List[dict]:
    """The rows the last restore kept (empty before any)."""
    with _MANIFEST_LOCK:
        return [dict(r) for r in _RESTORED or ()]


def reset_manifest() -> None:
    global _RESTORED
    with _MANIFEST_LOCK:
        _RESTORED = None


def compile_cache_status() -> dict:
    """The libraries' status for /debug/device and the stats' device
    block: where they live, how many this process loaded, and what the
    last restore kept."""
    from .. import buildlib

    restored = restored_manifest()
    return {
        "status": "restored" if restored else "live",
        "dir": buildlib.BUILD_DIR,
        "entries": len(buildlib.loaded_libraries()),
        "restored": len(restored),
    }
