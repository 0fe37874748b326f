"""Faults the port's analyzer found in the port, each fixed and held
here (ROADMAP queue C):

- ``solver/warmstore.py::_restore_under_root`` restored the kernel
  libraries' manifest (the compile-cache plane) without comparing the
  writer's torch, CUDA and card against the live ones (``cache-persist``):
  a snapshot from another toolchain kept every row whose library name
  matched. The plane now carries ``backend.compile_cache_fingerprint()``
  and a mismatch drops the whole manifest, counted.
- ``buildlib.py::CudaKernel._load`` ran ``nvcc`` (up to 600 s) under the
  process-wide ``_LIBS_LOCK`` (``wait-under-lock``): one source's build
  held every other library's first load. A build now runs under its own
  library's lock only.
- ``solver/solver.py::TorchScheduler._encode_phase`` made the compat
  kernel's first load (its build included) under ``_CATALOG_LOCK``
  (``wait-under-lock``, seen once kernel launches resolve): every other
  solver's encode waited on one nvcc. The library now loads before the
  lock is taken.
"""

from __future__ import annotations

import threading
import time

import pytest


def _rows():
    from karpenter_core_tpu_torch import buildlib

    return [{"source": "disrupt_screen.cu", "library": __import__("os").path.basename(
        buildlib.kernel_library_path("disrupt_screen.cu")), "kernels": ["disrupt.single_screen"]}]


@pytest.mark.parametrize("component", [None, "torch", "cuda", "capability", "sources"])
def test_compile_cache_restores_only_under_the_writers_fingerprint(monkeypatch, component):
    import karpenter_core_tpu_torch.disruption.screen_kernels  # noqa: F401 — registers the screens
    from karpenter_core_tpu_torch.solver import backend, warmstore

    stored = dict(backend.compile_cache_fingerprint(), libraries=_rows())
    if component == "sources":
        stored["sources"] = dict(stored["sources"], **{"disrupt_screen.cu": "0" * 16})
    elif component is not None:
        stored[component] = "another"
    out = warmstore._Outcome("test")
    try:
        warmstore._restore_compile_cache({"compilecache": stored}, out)
        kept = backend.restored_manifest()
    finally:
        backend.reset_manifest()
    if component is None:
        assert (out.restored, out.dropped, len(kept)) == ({"compilecache": 1}, {}, 1)
    else:
        assert (out.restored, out.dropped, kept) == ({}, {"compilecache": 1}, [])


def test_snapshot_carries_the_fingerprint():
    from karpenter_core_tpu_torch.solver import backend

    fp = backend.compile_cache_fingerprint()
    assert set(fp) == {"torch", "cuda", "capability", "sources"}
    assert "compat_allowed.cu" in fp["sources"] and len(fp["sources"]["compat_allowed.cu"]) == 16


def test_one_librarys_build_does_not_hold_another_librarys_load(monkeypatch):
    from karpenter_core_tpu_torch import buildlib
    from karpenter_core_tpu_torch.tracing import deviceplane

    monkeypatch.setattr(buildlib, "KERNELS", dict(buildlib.KERNELS))
    monkeypatch.setattr(buildlib, "_LIBS", {})
    monkeypatch.setattr(buildlib, "_LOADED", {})
    monkeypatch.setattr(buildlib, "_BUILD_LOCKS", {})
    monkeypatch.setattr(deviceplane, "record_library", lambda *a, **k: None)
    monkeypatch.setattr(buildlib.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(buildlib, "library_path", lambda src, cmd: f"/nonexistent/lib{src[-6:]}.so")
    building, release = threading.Event(), threading.Event()

    def build(self):
        if self.src.endswith("slow.cu"):
            building.set()
            release.wait(10)
        return self.library(), ""

    monkeypatch.setattr(buildlib.CudaKernel, "build", build)
    slow = buildlib.CudaKernel("slow.cu", "f", [], name="test.slow")
    fast = buildlib.CudaKernel("fast.cu", "f", [], name="test.fast")
    t = threading.Thread(target=slow._load)
    t.start()
    try:
        assert building.wait(5)
        t0 = time.monotonic()
        fast._load()
        assert time.monotonic() - t0 < 2.0 and t.is_alive()
    finally:
        release.set()
        t.join(10)
    assert sorted(row["source"] for row in buildlib._LOADED.values()) == ["fast.cu", "slow.cu"]


def test_compat_library_loads_before_the_catalog_lock():
    """The encode phase loads the compat kernel's library before it takes
    ``_CATALOG_LOCK`` (read from its source: on the CPU the kernel is
    never loaded)."""
    import inspect

    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    src = inspect.getsource(TorchScheduler._encode_phase)
    assert 0 <= src.index("COMPAT_ALLOWED.lib()") < src.index("with _CATALOG_LOCK:")
