"""Build-at-first-use for the port's native sources.

Each source (``native/pack.cc`` with ``g++``, ``csrc/*.cu`` with
``nvcc``) compiles into a shared library with a plain C interface under
``karpenter_core_tpu_torch/_build/`` (gitignored), named by the sha256
of the source and the command, so a binary is reused only when it
provably matches both. The build writes to a temporary name and renames
it into place, so concurrent processes never load a half-written file.
A failed build raises with the compiler's output: there is no fallback.

Each ``CudaKernel`` registers with the device plane
(tracing/deviceplane.py) under its name, the reference's name of the
jitted function it replaces. Kernels of one source share one loaded
library: its load, the build first where ``_build/`` lacks it, is the
plane's compile event, and ``loaded_libraries()`` lists what the process
loaded, the warm store's library manifest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .tracing import deviceplane

BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
CSRC = os.path.join(os.path.dirname(__file__), "csrc")
# the CUDA toolkit's compiler where the toolkit is installed, else nvcc on PATH
NVCC = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# a csrc/*.cu source compiled by g++ as C++: its __host__ __device__ step
# functions behind the *_host entry point, for the CPU tests (no FMA
# contraction, as the kernels' explicit round-to-nearest intrinsics)
HOST_CXX = ["g++", "-x", "c++", "-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]


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


# the kernels by device-plane name, and the libraries the process loaded
# (path → the loaded library, and its manifest row)
KERNELS: Dict[str, "CudaKernel"] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOADED: Dict[str, dict] = {}
_LIBS_LOCK = threading.Lock()
# one lock per library path: its build and load run once, under it alone
_BUILD_LOCKS: Dict[str, threading.Lock] = {}


def kernel_library_path(source: str) -> str:
    """Where the live tree's ``csrc/<source>`` builds for the card."""
    return library_path(os.path.join(CSRC, source), [NVCC] + NVCC_FLAGS)


def loaded_libraries() -> List[dict]:
    """The kernel libraries this process loaded: source, library file
    (named by the hash of the source and the command), the kernels bound
    from it, whether the load built it first, the load's ms and whether it
    raised the device plane's compile event (it does unless the plane was
    off)."""
    with _LIBS_LOCK:
        return [dict(row, library=os.path.basename(path), kernels=list(row["kernels"])) for path, row in _LOADED.items()]


class CudaKernel:
    """A ``csrc/*.cu`` source built by nvcc into a plain-C library, its
    launch function bound through ctypes. ``launches`` counts every
    launch made through ``launch`` and nowhere else (callers reset it);
    ``total_launches`` counts them for the process, the count the device
    plane reads. ``name``: the device plane's name of the kernel. ``helpers``: the library's other
    functions, name → (restype, argtypes), bound once when the library
    loads."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence, helpers: Optional[dict] = None,
                 name: Optional[str] = None) -> None:
        self.src = os.path.join(CSRC, source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.helpers = dict(helpers or {})
        self.name = name or symbol
        self.launches = 0
        self.total_launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        KERNELS[self.name] = self
        deviceplane.register(self.name).source = source

    def library(self) -> str:
        """Where the source builds: named by the source's and the
        command's hash."""
        return library_path(self.src, [NVCC] + NVCC_FLAGS)

    def build(self) -> Tuple[str, str]:
        """Compile the source if needed → (library path, nvcc output)."""
        return build_shared(self.src, [NVCC] + NVCC_FLAGS, timeout=600.0)

    def _load(self) -> ctypes.CDLL:
        """The source's library: loaded by the first kernel that asks (a
        device-plane compile event), shared by the others. ``_LIBS_LOCK``
        guards only the tables: a build runs under its library's own lock,
        so one source's nvcc never holds up another library's load."""
        path = self.library()
        with _LIBS_LOCK:
            build_lock = _BUILD_LOCKS.setdefault(path, threading.Lock())
        with build_lock:
            with _LIBS_LOCK:
                lib = _LIBS.get(path)
                if lib is not None:
                    _LOADED[path]["kernels"].append(self.name)
                    return lib
            t0 = time.perf_counter()
            built = not os.path.exists(path)
            lib = ctypes.CDLL(self.build()[0])
            ms = (time.perf_counter() - t0) * 1000.0
            event = deviceplane.record_library(self.name, path, ms, built)
            with _LIBS_LOCK:
                _LIBS[path] = lib
                _LOADED[path] = {"source": os.path.basename(self.src), "kernels": [self.name], "built": built,
                                 "ms": round(ms, 3), "compile_event": event is not None}
        return lib

    def lib(self) -> ctypes.CDLL:
        """The built library, loaded once."""
        if self._lib is None:  # analysis: allow-lock-discipline — double-checked: a set _lib is final
            with self._lock:
                if self._lib is None:
                    # analysis: allow-wait-under-lock(subprocess — this kernel's one first load: the lock guards only _lib and the launch counts, and no launch can run before the library exists)
                    lib = self._load()
                    fn = getattr(lib, self.symbol)
                    fn.restype = ctypes.c_int
                    fn.argtypes = self.argtypes
                    for name, (restype, argtypes) in self.helpers.items():
                        helper = getattr(lib, name)
                        helper.restype, helper.argtypes = restype, list(argtypes)
                    self._lib = lib
        return self._lib  # analysis: allow-lock-discipline — read after the double-checked load above

    def launch(self, *args, device=None) -> None:
        """Call the launch function; raise on a nonzero cudaError.
        ``device``: the card the arguments live on, made the CUDA runtime's
        current device around the call (a launch function launches, sets
        its attributes and sizes its grid on the current device, and
        ``cudaSetDevice`` is per host thread). The count is taken under
        the kernel's lock: several threads launch at once (the fleet's
        tenant workers), and ``+=`` alone loses updates."""
        fn = getattr(self.lib(), self.symbol)
        if device is None:
            err = fn(*args)
        else:
            import torch

            with torch.cuda.device(device):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: cudaError {err}")
        with self._lock:
            self.launches += 1
            self.total_launches += 1


def same_device(a, b) -> bool:
    """``a`` and ``b`` name one device: ``cuda`` without an index is the
    current card, so ``cuda`` and ``cuda:0`` agree while card 0 is
    current, and ``cuda:1`` never agrees with ``cuda:0``."""
    import torch

    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or (a.index is not None and b.index is not None):
        return a.index == b.index
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def check_tensor(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's launch function takes."""
    if (not same_device(t.device, device) or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def host_library(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` built by g++ as C++ (its ``*_host`` entry
    points), for the CPU tests of a kernel's step functions."""
    return ctypes.CDLL(build_shared(os.path.join(CSRC, source), HOST_CXX, timeout=300.0)[0])
