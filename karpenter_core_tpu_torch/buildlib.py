"""Build-at-first-use for the port's native sources.

Each source (``native/pack.cc`` with ``g++``, ``csrc/*.cu`` with
``nvcc``) compiles into a shared library with a plain C interface under
``karpenter_core_tpu_torch/_build/`` (gitignored), named by the sha256
of the source and the command, so a binary is reused only when it
provably matches both. The build writes to a temporary name and renames
it into place, so concurrent processes never load a half-written file.
A failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import List, Tuple

BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")


def library_path(src: str, cmd: List[str]) -> str:
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update("\0".join(cmd).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build_shared(src: str, cmd: List[str], timeout: float = 600.0) -> Tuple[str, str]:
    """Compile ``src`` with ``cmd + [src, "-o", <out>]`` unless the
    library for this exact source and command exists. → (library path,
    compiler output, kept beside the library as ``<library>.log`` so a
    reused build reports it too)."""
    path = library_path(src, cmd)
    if os.path.exists(path):
        try:
            with open(path + ".log") as f:
                return path, f.read()
        except OSError:
            return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            cmd + [src, "-o", tmp],
            capture_output=True,
            text=True,
            timeout=timeout,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src} failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        log = proc.stdout + proc.stderr
        with open(tmp + ".log", "w") as f:
            f.write(log)
        os.replace(tmp + ".log", path + ".log")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, log
