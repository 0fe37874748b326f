"""Runtime lock-order witness: the dynamic half of the
concurrency proof plane.

When installed (env-switched by the witness entry point,
``analysis/witness.py``, via ``KARPENTER_TORCH_LOCK_WITNESS=1``, BEFORE
the package imports; off in production), the witness
monkeypatches ``threading.Lock`` / ``RLock`` / ``Condition`` with
factories that inspect the *creation site* of each primitive. A site
present in the static lock inventory (``concurrency.witness_inventory``)
with a matching constructor kind gets a thin recording wrapper; every
other creation — stdlib internals, function-local locks, sink locks —
gets the real primitive untouched.

Wrapped primitives maintain a per-thread held stack and record every
*consecutive* acquisition edge (top-of-stack lock held when another
inventoried lock is acquired). At the end of the witnessed run the entry
point asserts ``observed ⊆ static_order_graph()``: every nesting the test
run actually exercised was predicted by the static analysis. The two
sides validate each other — a static resolution gap shows up as an
unexplained observed edge, and a static-only edge costs nothing (the
graph is a may-analysis superset by construction).

Sink locks (observability/interning leaves) are deliberately NOT
instrumented: a metrics bump under a Condition is statically invisible
but provably harmless — the lock-order rule verifies sinks never
acquire coordination locks, so no sink can extend a chain.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, Set, Tuple

ENV_SWITCH = "KARPENTER_TORCH_LOCK_WITNESS"

# real primitives captured at import time — factories and internal
# bookkeeping must never recurse through the patch
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_installed = False
_root: str = ""
_inventory: Dict[Tuple[str, int], Tuple[str, str]] = {}
_edges: Set[Tuple[str, str]] = set()
_acquired: Set[str] = set()  # every instrumented lock acquired at least once
_edges_mu = _REAL_LOCK()
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = []
        _tls.stack = s
    return s


def _push(lock_id: str, record: bool = True) -> None:
    s = _stack()
    if lock_id not in _acquired:
        with _edges_mu:
            _acquired.add(lock_id)
    if record and s and s[-1] != lock_id:
        edge = (s[-1], lock_id)
        with _edges_mu:
            _edges.add(edge)
    s.append(lock_id)


def _pop(lock_id: str) -> None:
    s = _stack()
    for i in range(len(s) - 1, -1, -1):
        if s[i] == lock_id:
            del s[i]
            return


class _WitnessLock:
    """Recording proxy over a real Lock/RLock. Only the acquisition
    protocol is intercepted; everything else delegates."""

    __slots__ = ("_lock", "lock_id")

    def __init__(self, lock, lock_id: str) -> None:
        self._lock = lock
        self.lock_id = lock_id

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            _push(self.lock_id)
        return got

    def release(self) -> None:
        _pop(self.lock_id)
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        fn = getattr(self._lock, "locked", None)
        return bool(fn()) if fn is not None else False

    def __repr__(self) -> str:
        return f"<witness {self.lock_id} over {self._lock!r}>"


class _WitnessCondition:
    """Recording proxy over a real Condition. ``wait`` pops the held
    entry for its duration (the wait releases the underlying lock) and
    re-pushes WITHOUT recording — the original acquisition already
    recorded the edge, and a fresh edge at wakeup would invent
    orderings the code never requested."""

    __slots__ = ("_cond", "lock_id")

    def __init__(self, cond, lock_id: str) -> None:
        object.__setattr__(self, "_cond", cond)
        object.__setattr__(self, "lock_id", lock_id)

    def acquire(self, *args, **kwargs) -> bool:
        got = self._cond.acquire(*args, **kwargs)
        if got:
            _push(self.lock_id)
        return got

    def release(self) -> None:
        _pop(self.lock_id)
        self._cond.release()

    def __enter__(self) -> bool:
        got = self._cond.__enter__()
        _push(self.lock_id)
        return got

    def __exit__(self, *exc) -> None:
        _pop(self.lock_id)
        return self._cond.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None):
        _pop(self.lock_id)
        try:
            return self._cond.wait(timeout)
        finally:
            _push(self.lock_id, record=False)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _pop(self.lock_id)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _push(self.lock_id, record=False)

    def __getattr__(self, name: str):
        return getattr(object.__getattribute__(self, "_cond"), name)

    def __repr__(self) -> str:
        return f"<witness {self.lock_id} over {self._cond!r}>"


def _site_of_caller() -> Optional[Tuple[str, int]]:
    frame = sys._getframe(2)
    fn = frame.f_code.co_filename
    if not fn.startswith(_root):
        return None
    rel = os.path.relpath(fn, _root).replace(os.sep, "/")
    return (rel, frame.f_lineno)


def _lock_factory(*args, **kwargs):
    site = _site_of_caller()
    hit = _inventory.get(site) if site is not None else None
    if hit is not None and hit[1] == "Lock":
        return _WitnessLock(_REAL_LOCK(*args, **kwargs), hit[0])
    return _REAL_LOCK(*args, **kwargs)


def _rlock_factory(*args, **kwargs):
    site = _site_of_caller()
    hit = _inventory.get(site) if site is not None else None
    # `threading.Condition(threading.RLock())` shares one creation line:
    # the inventory entry there is the Condition — kind-mismatched sites
    # get the real primitive so the Condition factory wraps exactly once
    if hit is not None and hit[1] == "RLock":
        return _WitnessLock(_REAL_RLOCK(*args, **kwargs), hit[0])
    return _REAL_RLOCK(*args, **kwargs)


def _condition_factory(*args, **kwargs):
    site = _site_of_caller()
    hit = _inventory.get(site) if site is not None else None
    if hit is not None and hit[1] == "Condition":
        return _WitnessCondition(_REAL_CONDITION(*args, **kwargs), hit[0])
    return _REAL_CONDITION(*args, **kwargs)


def install(root: Optional[str] = None) -> bool:
    """Patch the threading constructors. Idempotent; returns whether the
    witness is installed after the call. Must run BEFORE the package
    modules that create inventoried locks are imported."""
    global _installed, _root
    if _installed:
        return True
    from .concurrency import witness_inventory
    from .engine import repo_root

    _root = os.path.abspath(root or repo_root())
    _inventory.update(witness_inventory(_root))
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    _installed = True
    return True


def uninstall() -> None:
    """Restore the real constructors (already-created wrappers keep
    working — they hold real primitives)."""
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _installed = False


def installed() -> bool:
    return _installed


def observed_edges() -> Set[Tuple[str, str]]:
    with _edges_mu:
        return set(_edges)


def observed_locks() -> Set[str]:
    """The instrumented locks acquired since install (or the last reset)."""
    with _edges_mu:
        return set(_acquired)


def reset_edges() -> None:
    with _edges_mu:
        _edges.clear()
        _acquired.clear()


def instrumented_count() -> int:
    return len(_inventory)


def verify_against_static(root: Optional[str] = None) -> Tuple[Set[Tuple[str, str]], Set[Tuple[str, str]]]:
    """→ (observed, unexplained): the witness passes when ``unexplained``
    is empty — every observed acquisition edge is in the static graph."""
    from .concurrency import static_order_graph

    observed = observed_edges()
    static = static_order_graph(root or _root or None)
    return observed, observed - static
