"""The device plane: library builds and loads, launches, host↔device
transfers and device memory, attributed per solve.

The port's copy of ``karpenter_core_tpu/tracing/deviceplane.py``. The
reference observes XLA: a jitted function compiles once per abstract
call signature, so a new signature is a compile event. The port has no
jit. Its kernels are ``csrc/*.cu`` libraries built by nvcc and loaded
with ``dlopen`` (``buildlib.CudaKernel``); a kernel takes any shape
without compiling again. So in the port:

- **compile events** are library loads: the first ``CudaKernel.lib()``
  of a library in the process, which builds it first when ``_build/``
  lacks it (``record_library``; the event says which). Cause ``first``,
  or ``prewarm_replay`` inside :func:`prewarm_scope`. ``new_shape`` and
  ``new_config`` keep their names and never fire;
- **the signature registry** is the reference's: every host entry point
  registers through :func:`wrap` (the decorator :func:`observe`) under
  the reference's ``observe_jit`` name, and records per function the
  population of call signatures (tensors as ``(shape, dtype)``, the rest
  as bounded static reprs) with counts and each signature's first-call
  wall time, capped at 512 a function with the evictions counted. Each
  ``CudaKernel`` registers under the same name as its entry point, so
  one record carries the entry point's signatures and its library
  loads, and reads the kernel's launches from the kernel's own process
  counter (``CudaKernel.total_launches``: one count a launch, kept in
  one place);
- **transfers** (``record_transfer``) ride ``devicetime.transfer`` at the
  boundaries the reference accounts (pack, existing, lp, screen), split
  h2d/d2h per phase, and the compat boundary on the card;
- **memory**: the solver polls ``devicetime.device_memory_stats`` at solve
  end and the boundaries report their device buffers' footprint
  (``record_footprint``), compared against the compat tile budget
  (``compat_kernels.COMPAT_TILE_BYTES``).

Per solve: the solver calls ``reset_solve()`` at solve entry and drains
``consume_solve()`` into ``solver.last_device_stats``, the stats'
``device`` block, the trace's args and the metrics. Process totals
(``compile_count()``, ``totals()``, ``debug_state()``) back
``/debug/device``. The reference's ``KARPENTER_TPU_DEVICEPLANE`` knob is
the constant ``DEVICEPLANE`` (tests monkeypatch it): off, the wrappers
dispatch straight through and reset/consume are no-ops. Launch counts
are the kernels' own, kept either way.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

CAUSE_FIRST = "first"
CAUSE_NEW_SHAPE = "new_shape"  # the reference's; a launch shape compiles nothing here
CAUSE_NEW_CONFIG = "new_config"  # likewise
# a load inside prewarm_scope(): the boot prewarm paying the library
# load before any solve, never in the per-solve accumulator
CAUSE_PREWARM_REPLAY = "prewarm_replay"

# newest-wins ring of compile events for /debug/device
_EVENTS_KEEP = 256
# per-function signature population cap: the registry is an inventory,
# not a cache
_SIGS_PER_FN = 512

# the reference's KARPENTER_TPU_DEVICEPLANE (on)
DEVICEPLANE = True


def enabled() -> bool:
    return bool(DEVICEPLANE)


# ---------------------------------------------------------------------------
# process-global registry


class _FnRecord:
    """One registered entry point: its signature population, its kernel's
    launches and its library loads."""

    __slots__ = (
        "name", "call_site", "static_names", "signatures",
        "calls", "compiles", "evicted", "wrapper", "source",
    )

    def __init__(self, name: str, call_site: str, static_names: Tuple[str, ...]):
        self.name = name
        self.call_site = call_site
        self.static_names = tuple(static_names)
        # sig key -> {"count", "first_ms", "restored"}
        self.signatures: "OrderedDict[tuple, dict]" = OrderedDict()
        self.calls = 0
        self.compiles = 0
        self.evicted = 0
        self.wrapper: Optional[Callable] = None
        self.source = ""  # the kernel's csrc file, once a CudaKernel registers


_MU = threading.Lock()
_REGISTRY: Dict[str, _FnRecord] = {}
_EVENTS: deque = deque(maxlen=_EVENTS_KEEP)
_TOTALS = {"compiles": 0, "calls": 0, "prewarm_compiles": 0}
_TRANSFERS: Dict[Tuple[str, str], int] = {}

_tls = threading.local()


def _acc() -> Optional[dict]:
    return getattr(_tls, "acc", None)


def in_prewarm() -> bool:
    return bool(getattr(_tls, "prewarm", False))


@contextlib.contextmanager
def prewarm_scope():
    """Mark this thread as the boot prewarm: library loads inside the
    scope are attributed ``cause=prewarm_replay``, counted in the
    ``prewarm_compiles`` total and the yielded event list, never in the
    solve-attributed counters or the per-solve accumulator."""
    events: List[dict] = []
    prev = getattr(_tls, "prewarm", False)
    prev_events = getattr(_tls, "prewarm_events", None)
    _tls.prewarm = True
    _tls.prewarm_events = events
    try:
        yield events
    finally:
        _tls.prewarm = prev
        _tls.prewarm_events = prev_events


def reset_solve() -> None:
    """Arm per-solve accumulation on this thread (solve entry)."""
    if not enabled():
        _tls.acc = None
        return
    _tls.acc = {"compiles": [], "transfers": {}, "footprint": 0}


def consume_solve(memory: Optional[dict] = None) -> Optional[dict]:
    """Drain this thread's per-solve accumulator into the stats-shaped
    ``device`` block (None when the plane is off). ``memory`` is the
    device poll (``devicetime.device_memory_stats``, None off the card)."""
    acc = _acc()
    _tls.acc = None
    if acc is None:
        return None
    by_phase: Dict[str, Dict[str, int]] = {}
    direction_totals = {"h2d": 0, "d2h": 0}
    for (direction, phase), nbytes in acc["transfers"].items():
        by_phase.setdefault(phase, {})[direction] = by_phase.get(phase, {}).get(direction, 0) + nbytes
        direction_totals[direction] = direction_totals.get(direction, 0) + nbytes
    budget_mb = tile_budget_mb()
    footprint = int(acc["footprint"])
    headroom = None
    if budget_mb > 0:
        headroom = round(1.0 - footprint / (budget_mb * 1024 * 1024), 4)
    events = acc["compiles"]
    return {
        "compiles": len(events),
        "compile_events": [dict(e) for e in events[:8]],
        "transfer_bytes": direction_totals,
        "transfer_by_phase": by_phase,
        "footprint_bytes": footprint,
        "tile_budget_mb": budget_mb,
        "tile_headroom_frac": headroom,
        "hbm": dict(memory) if memory else None,
    }


def tile_budget_mb() -> float:
    """The compat kernel's per-dispatch output budget in MiB (the
    reference's ``KARPENTER_TPU_COMPAT_TILE_MB``)."""
    from ..solver.compat_kernels import COMPAT_TILE_BYTES

    return COMPAT_TILE_BYTES / (1024 * 1024)


# ---------------------------------------------------------------------------
# the registering seam


_DTYPE_NAMES: Dict[Any, str] = {}


def _dtype_name(dtype: Any) -> str:
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype)
    return name


def _abstract(a: Any) -> tuple:
    """One argument's abstract type: tensors and arrays (anything with
    ``.shape`` and ``.dtype``) become ``("a", shape, dtype)``; dict and
    tuple pytrees recurse; an object with a ``__deviceplane__`` method
    is abstracted through what it returns (the device-resident catalog:
    its planes); everything else is static config by bounded repr. A
    tensor, the common argument, takes the first test and no repr. The
    module never imports torch (tracing/ is host-only): a tensor exists
    only where torch is imported already."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(a, torch.Tensor):
        return ("a", tuple(a.shape), _dtype_name(a.dtype))
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        return ("a", tuple(int(d) for d in shape), _dtype_name(dtype))
    if isinstance(a, dict):
        return ("d",) + tuple((k, _abstract(v)) for k, v in sorted(a.items()))
    if isinstance(a, (tuple, list)):
        return ("t",) + tuple(_abstract(v) for v in a)
    inner = getattr(a, "__deviceplane__", None)
    if callable(inner):
        return _abstract(inner())
    r = repr(a)
    return ("s", r if len(r) <= 512 else r[:509] + "...")


def _has_array(node: tuple) -> bool:
    if node[0] == "a":
        return True
    if node[0] in ("d", "t"):
        return any(_has_array(v if node[0] == "t" else v[1]) for v in node[1:])
    return False


def _sig_key(static_names: Tuple[str, ...], args: tuple, kwargs: dict) -> Tuple[tuple, tuple]:
    """(array part, static part) of one call's signature: arguments whose
    pytree carries tensors land in the array part, the rest (and anything
    named in ``static_names``) is static config."""
    arr: List[tuple] = []
    static: List[tuple] = []
    for i, a in enumerate(args):
        node = _abstract(a)
        (arr if _has_array(node) else static).append((i, node))
    for k in sorted(kwargs):
        node = _abstract(kwargs[k])
        if k not in static_names and _has_array(node):
            arr.append((k, node))
        else:
            static.append((k, node))
    return tuple(arr), tuple(static)


def register(name: str, call_site: str = "", static_names: Tuple[str, ...] = ()) -> _FnRecord:
    """The record of ``name``, created on first use (entry points and
    ``CudaKernel``s register under the same name)."""
    with _MU:
        rec = _REGISTRY.get(name)
        if rec is None:
            rec = _FnRecord(name, call_site, static_names)
            _REGISTRY[name] = rec
        return rec


def _record_compile(rec: _FnRecord, cause: str, ms: float, library: str, built: bool) -> dict:
    from .tracer import current_trace_id

    prewarm = cause == CAUSE_PREWARM_REPLAY
    event = {
        "fn": rec.name,
        "cause": cause,
        "ms": round(ms, 3),
        "trace_id": current_trace_id(),
        "wall": time.time(),
        "library": library,
        "built": bool(built),
    }
    with _MU:
        if prewarm:
            _TOTALS["prewarm_compiles"] += 1
        else:
            rec.compiles += 1
            _TOTALS["compiles"] += 1
        _EVENTS.append(dict(event))
    if prewarm:
        bucket = getattr(_tls, "prewarm_events", None)
        if bucket is not None:
            bucket.append(event)
    else:
        acc = _acc()
        if acc is not None:
            acc["compiles"].append(event)
    return event


def record_library(name: str, path: str, ms: float, built: bool) -> Optional[dict]:
    """One library loaded by the kernel registered as ``name`` (``built``:
    compiled first) → its compile event, None while the plane is off."""
    if not enabled():
        return None
    rec = register(name)
    cause = CAUSE_PREWARM_REPLAY if in_prewarm() else CAUSE_FIRST
    return _record_compile(rec, cause, ms, os.path.basename(path), built)


def wrap(name: str, fn: Callable, static_names: Tuple[str, ...] = (), call_site: str = "") -> Callable:
    """Register ``fn`` under ``name`` and return the observing wrapper.
    Every call records its signature; none raises a compile event (a
    launch shape compiles nothing). While the plane is off the wrapper is
    one flag test and a passthrough call."""
    static_names = tuple(static_names)
    if not call_site:
        code = getattr(getattr(fn, "__wrapped__", fn), "__code__", None)
        if code is not None:
            call_site = f"{os.path.basename(code.co_filename)}:{code.co_firstlineno}"
    rec = register(name)
    with _MU:
        rec.call_site = call_site
        rec.static_names = static_names

    @functools.wraps(fn)
    def observed(*args, **kwargs):
        if not enabled():
            return fn(*args, **kwargs)
        key = _sig_key(static_names, args, kwargs)
        with _MU:
            meta = rec.signatures.get(key)
            rec.calls += 1
            _TOTALS["calls"] += 1
            fresh = meta is None
            if fresh:
                meta = {"count": 0, "first_ms": None}
                rec.signatures[key] = meta
                while len(rec.signatures) > _SIGS_PER_FN:
                    rec.signatures.popitem(last=False)
                    rec.evicted += 1
            else:
                meta.pop("restored", None)  # a restored row's first live call
            meta["count"] += 1
        if not fresh:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        with _MU:
            meta["first_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    observed.__deviceplane_fn__ = name
    with _MU:
        rec.wrapper = observed
    return observed


def observe(name: str, static_names: Tuple[str, ...] = ()):
    """Decorator form of ``wrap`` (the reference's ``observe_jit``)."""

    def deco(fn: Callable) -> Callable:
        return wrap(name, fn, static_names=static_names)

    return deco


# ---------------------------------------------------------------------------
# transfer + footprint accounting (rides devicetime)


def record_transfer(direction: str, nbytes: int, phase: str = "solve") -> None:
    """Account ``nbytes`` moved across the host/device boundary.
    ``direction`` is ``h2d`` or ``d2h``; ``phase`` names the boundary."""
    if nbytes <= 0 or not enabled():
        return
    key = (direction, phase)
    with _MU:
        _TRANSFERS[key] = _TRANSFERS.get(key, 0) + int(nbytes)
    acc = _acc()
    if acc is not None:
        acc["transfers"][key] = acc["transfers"].get(key, 0) + int(nbytes)


def nbytes_of(*arrays: Any) -> int:
    """Total byte size of tensors and arrays (anything exposing
    ``nbytes``, else size*itemsize, else 0)."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        n = getattr(a, "nbytes", None)
        if n is None:
            size = getattr(a, "size", None)
            itemsize = getattr(getattr(a, "dtype", None), "itemsize", None)
            n = size * itemsize if isinstance(size, int) and itemsize is not None else 0
        total += int(n)
    return total


def record_footprint(nbytes: int) -> None:
    """Report one device-buffer footprint of a boundary (the compat
    output, a scan's inputs); the per-solve block keeps the max."""
    if nbytes <= 0 or not enabled():
        return
    acc = _acc()
    if acc is not None and nbytes > acc["footprint"]:
        acc["footprint"] = int(nbytes)


# ---------------------------------------------------------------------------
# global consumers: /debug/device, the warm store's plane


def compile_count() -> int:
    """Process-lifetime solve-attributed compile events."""
    with _MU:
        return _TOTALS["compiles"]


def launch_counts() -> Dict[str, int]:
    """Kernel launches per registered name, for the process: each
    kernel's own counter (``CudaKernel.total_launches``)."""
    from .. import buildlib

    return {name: k.total_launches for name, k in list(buildlib.KERNELS.items()) if k.total_launches}


def totals() -> dict:
    with _MU:
        return {
            "compiles": _TOTALS["compiles"],
            "prewarm_compiles": _TOTALS["prewarm_compiles"],
            "calls": _TOTALS["calls"],
            "functions": len(_REGISTRY),
            "transfer_bytes": {f"{d}.{p}": n for (d, p), n in sorted(_TRANSFERS.items())},
        }


def prewarm_compile_count() -> int:
    with _MU:
        return _TOTALS["prewarm_compiles"]


def compile_totals_by_label() -> Dict[Tuple[str, str], int]:
    """(fn, cause) -> count over the retained event ring."""
    out: Dict[Tuple[str, str], int] = {}
    with _MU:
        for ev in _EVENTS:
            key = (ev["fn"], ev["cause"])
            out[key] = out.get(key, 0) + 1
    return out


def recent_compiles(tail: int = 32) -> List[dict]:
    with _MU:
        return [dict(e) for e in list(_EVENTS)[-max(1, tail):]]


def _jsonable(node: Any):
    if isinstance(node, tuple):
        return [_jsonable(v) for v in node]
    return node


def registry_state() -> List[dict]:
    """Per-function inventory: signatures with shapes, counts and
    first-call ms, and the kernel's launches."""
    out: List[dict] = []
    launches = launch_counts()
    with _MU:
        for rec in _REGISTRY.values():
            sigs = [
                {
                    "shapes": _jsonable(arr),
                    "static": _jsonable(static),
                    "count": meta.get("count", 0),
                    "first_ms": meta.get("first_ms"),
                    "restored": bool(meta.get("restored", False)),
                }
                for (arr, static), meta in rec.signatures.items()
            ]
            out.append(
                {
                    "fn": rec.name,
                    "call_site": rec.call_site,
                    "source": rec.source,
                    "static_names": list(rec.static_names),
                    "calls": rec.calls,
                    "compiles": rec.compiles,
                    "launches": launches.get(rec.name, 0),
                    "evicted": rec.evicted,
                    "signatures": sigs,
                }
            )
    return sorted(out, key=lambda r: r["fn"])


def debug_state(tail: int = 32) -> dict:
    """The /debug/device payload: totals, the per-function registry and
    the recent compile events with their trace ids."""
    return {
        "enabled": enabled(),
        "totals": totals(),
        "tile_budget_mb": tile_budget_mb(),
        "compiles_by_label": {
            f"{fn}|{cause}": n for (fn, cause), n in sorted(compile_totals_by_label().items())
        },
        "registry": registry_state(),
        "recent_compiles": recent_compiles(tail),
    }


# ---------------------------------------------------------------------------
# the warm store's signature plane (jitsig)


def export_signatures() -> List[tuple]:
    """Serializable (fn, static_names, [(arr_part, static_part), ...])
    rows: keys only, counts stay process-local."""
    with _MU:
        return [(rec.name, rec.static_names, list(rec.signatures.keys())) for rec in _REGISTRY.values()]


def import_signatures(rows: List[tuple]) -> Tuple[int, int]:
    """Re-anchor a snapshot's signature inventory → (restored, dropped).
    A row restores only onto a function this process registered through
    ``wrap()`` with the same static-argument names; anything else is
    dropped. Restored signatures are inventory: count 0, flagged
    ``restored`` until their first live call."""
    restored = dropped = 0
    for row in rows:
        try:
            name, static_names, keys = row
            static_names = tuple(static_names)
        except (TypeError, ValueError):
            dropped += 1
            continue
        with _MU:
            rec = _REGISTRY.get(name)
            if rec is None or rec.wrapper is None or rec.static_names != static_names:
                dropped += len(keys) if isinstance(keys, list) else 1
                continue
            for key in keys:
                try:
                    arr, static = key
                    k = (tuple(tuple(x) if isinstance(x, list) else x for x in arr),
                         tuple(tuple(x) if isinstance(x, list) else x for x in static))
                except (TypeError, ValueError):
                    dropped += 1
                    continue
                if k not in rec.signatures:
                    rec.signatures[k] = {"count": 0, "first_ms": None, "restored": True}
                restored += 1
    return restored, dropped


def replay_targets(restored_only: bool = True) -> List[dict]:
    """Per registered function, the signature keys still flagged
    ``restored`` (``restored_only=False``: every known one) and its live
    wrapper."""
    out: List[dict] = []
    with _MU:
        for rec in _REGISTRY.values():
            if rec.wrapper is None:
                continue
            keys = [k for k, meta in rec.signatures.items() if meta.get("restored") or not restored_only]
            if keys:
                out.append({"fn": rec.name, "static_names": rec.static_names, "keys": keys, "wrapper": rec.wrapper})
    return sorted(out, key=lambda r: r["fn"])


def reset() -> None:
    """Drop every record's signatures, call and compile counts, the event
    ring and the transfer totals (tests, simulate_process_death). The
    records survive, and the kernels keep their launch counts: a loaded
    library and the launches it made are facts of the process."""
    with _MU:
        for rec in _REGISTRY.values():
            rec.signatures.clear()
            rec.calls = 0
            rec.compiles = 0
            rec.evicted = 0
        _EVENTS.clear()
        _TOTALS["compiles"] = 0
        _TOTALS["calls"] = 0
        _TOTALS["prewarm_compiles"] = 0
        _TRANSFERS.clear()
