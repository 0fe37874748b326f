"""Runtime knob witness: observed env reads ⊆ static registry.

The static knob inventory (``configprov.repo_registry``) claims to be
authoritative. This module makes that claim falsifiable at runtime, the
lockwitness pattern: when ``KARPENTER_TORCH_KNOB_WITNESS=1``, env access
is instrumented *before* the package (and torch) import, every
``KARPENTER_TORCH_*`` name read during the witnessed run is recorded,
and the run's gate asserts each observed name is present in the static
inventory. A read the analyzer cannot see (an exec'd string, a name
built through a shape ``configprov`` doesn't resolve) fails the gate
with instructions to extend the analyzer — never to weaken the gate.

The switch is read by ``analysis/witness.py``, the witnessed run's
entry point, before ``install()``: that probe is therefore unrecorded.

Instrumentation detail: ``os._Environ`` inherits ``get`` and
``__contains__`` from ``Mapping`` (they route through ``__getitem__``),
so installing recording overrides on the *class* observes every
``os.environ.get`` / ``os.getenv`` / ``in`` probe while leaving
``__getitem__`` itself untouched — bulk snapshots (``dict(os.environ)``,
``os.environ.copy()``, subprocess spawning) do not pollute the observed
set with names the process never asked for individually.
"""

from __future__ import annotations

import os
import re
import threading
from typing import List, Optional, Set, Tuple

from .engine import DEFAULT_CONFIG

#: the witness entry point reads this switch BEFORE install() — that
#: probe is therefore deliberately unrecorded, mirroring
#: analysis/lockwitness.ENV_SWITCH
ENV_SWITCH = "KARPENTER_TORCH_KNOB_WITNESS"

_PREFIX = DEFAULT_CONFIG.knob_prefix

_observed: Set[str] = set()
_mu = threading.Lock()
_installed = False


def _record(key: object) -> None:
    if isinstance(key, str) and key.startswith(_PREFIX):
        with _mu:
            _observed.add(key)


def install() -> None:
    """Instrument env access. Must run before the package (and torch)
    import so import-time reads are witnessed too."""
    global _installed
    if _installed:
        return
    env_cls = type(os.environ)

    def get(self, key, default=None):  # noqa: ANN001 — Mapping.get signature
        _record(key)
        try:
            return self[key]
        except KeyError:
            return default

    def contains(self, key):  # noqa: ANN001
        _record(key)
        try:
            self[key]
        except KeyError:
            return False
        return True

    env_cls.get = get
    env_cls.__contains__ = contains
    _installed = True


def installed() -> bool:
    return _installed


def observed_names() -> Set[str]:
    with _mu:
        return set(_observed)


def reset() -> None:
    with _mu:
        _observed.clear()


def verify_against_static(
    root: Optional[str] = None,
) -> Tuple[Set[str], List[str]]:
    """(observed, unexplained): every name read at runtime that the
    static knob inventory does not account for — by exact name or by a
    dynamic-knob pattern (f-string families like
    KARPENTER_TORCH_SERVING_<NAME>_CAP)."""
    from .configprov import static_knob_names

    names, patterns = static_knob_names(root)
    names = set(names) | {ENV_SWITCH}
    observed = observed_names()
    unexplained = sorted(
        n
        for n in observed
        if n not in names and not any(p.match(n) for p in patterns)
    )
    return observed, unexplained
