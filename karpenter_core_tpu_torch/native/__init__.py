"""The port's own C++ packer (``pack.cc``, a copy of the JAX package's).

The first-fit-decreasing pack is sequential scalar work: each pod's
placement depends on every earlier one, so it runs on the host in C++
while the card computes the signature x type masks. ``pack.cc`` is
compiled by ``g++`` at first use into the port's gitignored build
directory (``buildlib.BUILD_DIR``), never next to the source. If it
cannot be built, loading raises: a failed build never turns into the
device engine. ``KARPENTER_TORCH_NATIVE=0`` (the JAX package's
``KARPENTER_TPU_NATIVE``) makes ``available()`` false, and the pack
engines' ``auto`` route then takes the device scans.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .. import buildlib

SRC = os.path.join(os.path.dirname(__file__), "pack.cc")
GXX_CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)


def available() -> bool:
    """Whether the pack engines' ``auto`` route takes this packer: true
    unless ``KARPENTER_TORCH_NATIVE`` is ``0`` (read per call). True does
    not build anything; the first packer call does, and raises if it
    cannot."""
    return os.environ.get("KARPENTER_TORCH_NATIVE", "1") != "0"


def build() -> Tuple[str, str]:
    """Compile ``pack.cc`` if needed → (library path, compiler output)."""
    return buildlib.build_shared(SRC, GXX_CMD, timeout=300.0)


def load() -> ctypes.CDLL:
    """The packer library, building it on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = build()
        lib = ctypes.CDLL(path)
        lib.ffd_pack_native.restype = ctypes.c_int32
        lib.ffd_pack_native.argtypes = [
            _I32P,  # requests
            ctypes.c_int64,  # P
            ctypes.c_int64,  # R
            _I32P,  # frontier
            ctypes.c_int64,  # F
            ctypes.c_int32,  # max_pods_per_node
            ctypes.c_int32,  # k_open
            _I32P,  # node_ids_out
        ]
        lib.pack_existing_native.restype = ctypes.c_int64
        lib.pack_existing_native.argtypes = [
            _I32P,  # requests
            ctypes.c_int64,  # P
            ctypes.c_int64,  # R
            _I32P,  # sig_ids
            ctypes.POINTER(ctypes.c_uint8),  # compat
            ctypes.c_int64,  # S
            _I32P,  # free_caps (in-out)
            ctypes.c_int64,  # M
            _I32P,  # assign_out
        ]
        lib.cheapest_types_native.restype = None
        lib.cheapest_types_native.argtypes = [
            ctypes.POINTER(ctypes.c_int64),  # usage
            ctypes.c_int64,  # N
            ctypes.c_int64,  # R
            _I32P,  # allocatable
            ctypes.c_int64,  # T
            ctypes.POINTER(ctypes.c_double),  # prices
            _I32P,  # out
        ]
        _lib = lib
        return _lib


def ffd_pack_native(
    requests: np.ndarray,  # (P, R) int32, sorted descending by primary
    frontier: np.ndarray,  # (F, R) int32
    max_pods_per_node: int,
    k_open: int = 16,
) -> Tuple[np.ndarray, int]:
    """K-open first-fit-decreasing → (node_ids (P,) int32, -1 ⇒
    unschedulable; node_count)."""
    lib = load()
    requests = np.ascontiguousarray(requests, dtype=np.int32)
    frontier = np.ascontiguousarray(frontier, dtype=np.int32)
    if requests.ndim != 2 or frontier.ndim != 2 or requests.shape[1] != frontier.shape[1]:
        raise ValueError(
            f"requests {requests.shape} and frontier {frontier.shape} must be (P, R) and (F, R)"
        )
    P, R = requests.shape
    node_ids = np.empty(P, dtype=np.int32)
    count = lib.ffd_pack_native(
        requests.ctypes.data_as(_I32P),
        P,
        R,
        frontier.ctypes.data_as(_I32P),
        frontier.shape[0],
        np.int32(min(int(max_pods_per_node), 2**31 - 1)),
        int(k_open),
        node_ids.ctypes.data_as(_I32P),
    )
    return node_ids, int(count)


def pack_existing_native(
    requests: np.ndarray,  # (P, R) int32, sorted descending by primary
    sig_ids: np.ndarray,  # (P,) int32
    compat: np.ndarray,  # (S, M) uint8/bool
    free_caps: np.ndarray,  # (M, R) int32, MUTATED in place
) -> Tuple[np.ndarray, int]:
    """First-fit of each pod, in order, onto the first admissible existing
    node (fixed node order) whose free capacity holds it; the chosen
    node's row of ``free_caps`` is reduced in place → (assign (P,) int32
    node index or -1, pods assigned)."""
    lib = load()
    requests = np.ascontiguousarray(requests, dtype=np.int32)
    sig_ids = np.ascontiguousarray(sig_ids, dtype=np.int32)
    compat = np.ascontiguousarray(compat, dtype=np.uint8)
    if free_caps.dtype != np.int32 or not free_caps.flags.c_contiguous:
        raise ValueError("free_caps must be a C-contiguous int32 array (it is updated in place)")
    P, R = requests.shape
    S, M = compat.shape
    if sig_ids.shape != (P,) or free_caps.shape != (M, R):
        raise ValueError(
            f"requests {requests.shape}, sig_ids {sig_ids.shape}, compat {compat.shape}, "
            f"free_caps {free_caps.shape} disagree"
        )
    if P and (sig_ids.min() < 0 or sig_ids.max() >= S):
        raise ValueError(f"sig_ids out of range for {S} signatures")
    assign = np.empty(P, dtype=np.int32)
    n = lib.pack_existing_native(
        requests.ctypes.data_as(_I32P),
        P,
        R,
        sig_ids.ctypes.data_as(_I32P),
        compat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        S,
        free_caps.ctypes.data_as(_I32P),
        M,
        assign.ctypes.data_as(_I32P),
    )
    return assign, int(n)


def cheapest_types_native(
    usage: np.ndarray,  # (N, R) int
    allocatable: np.ndarray,  # (T, R) int32
    prices: np.ndarray,  # (T,) f64
) -> np.ndarray:
    """Per node, the cheapest type whose allocatable holds its usage →
    (N,) int32 index into the type axis, -1 if none fits."""
    lib = load()
    usage = np.ascontiguousarray(usage, dtype=np.int64)
    allocatable = np.ascontiguousarray(allocatable, dtype=np.int32)
    prices = np.ascontiguousarray(prices, dtype=np.float64)
    N, R = usage.shape
    if allocatable.shape[1] != R or prices.shape != (allocatable.shape[0],):
        raise ValueError(
            f"usage {usage.shape}, allocatable {allocatable.shape}, prices {prices.shape} disagree"
        )
    out = np.empty(N, dtype=np.int32)
    lib.cheapest_types_native(
        usage.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        N,
        R,
        allocatable.ctypes.data_as(_I32P),
        allocatable.shape[0],
        prices.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(_I32P),
    )
    return out
