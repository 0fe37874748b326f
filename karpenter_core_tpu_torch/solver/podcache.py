"""Cross-solve per-pod memoization.

The provisioner's steady state re-solves largely the same pending pods
every batch window (the reference re-lists pods each loop but its
per-pod work is cheap Go; our per-pod work is Python attribute walking
— profiling shows signature extraction + request summing dominate the
50k-pod solve). Informer-style clients hand back the *same* object
until it changes, and every write through ``kube.client`` bumps
``metadata.resource_version`` — so (identity, resource_version) is a
sound memo key for everything derived from a pod's spec:

- its request ResourceList (``resources.requests_for_pods``), interned
  so the 50k-pod batch collapses to a few dozen unique request rows
  that quantize once per axis instead of once per pod;
- the label keys its topology/affinity selectors reference (the
  relevant-label set ``encode.group_pods`` builds signatures under);
- its constraint signature (``encode.pod_signature``), revalidated per
  batch against the batch's relevant-label-key fingerprint.

The memo rides on the Pod object itself (``pod._karp_memo``), so it is
garbage-collected with the pod and needs no eviction policy. The two
module-global intern maps (request shapes, signature tuples) are pure
dedup accelerators: ids are monotonic and never reused, so clearing a
map (size bound, or ``reset()`` in tests) can never alias two different
contents onto one id — it only costs some dedup until re-interned.
Consumers resolve ids through their own batch's memos
(``encode.build_requests_matrix_ids``), never through the global maps.

Invariant: mutating a pod's spec/labels without bumping
``metadata.resource_version`` (every kube-client write does) serves a
stale memo — any in-place mutator must drop ``pod._karp_memo`` itself.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..scheduling import resources


@dataclass(slots=True)
class PodMemo:
    selector_keys: tuple  # label keys this pod's selectors reference
    requests: dict  # interned request ResourceList (do not mutate)
    req_id: int  # interned request-shape id (monotonic, never reused)
    # (relevant-label-keys stable digest, signature tuple, interned sig id) —
    # one field written/read atomically (single reference assignment under
    # the GIL), so concurrent group_pods calls with different fingerprints
    # (provisioner vs disruption threads) can never observe a torn
    # fp/sig/sig_id triple
    sig_state: Optional[Tuple[bytes, tuple, int]] = None


_REQ_INTERN: Dict[tuple, Tuple[int, dict]] = {}
_SIG_INTERN: Dict[tuple, int] = {}
_NEXT_REQ = itertools.count()
_NEXT_SIG = itertools.count()
_LOCK = threading.Lock()
# dedup-map size bound: a weeks-long provisioner under heavy deployment
# churn must not accumulate request/signature shapes forever. Clearing
# only loses dedup (ids are monotonic), never correctness.
_INTERN_MAX = 100_000


def _selector_keys(pod) -> tuple:
    spec = pod.spec
    tsc = spec.topology_spread_constraints
    a = spec.affinity
    # fast path: no selectors anywhere (the common pod at 50k scale)
    if not tsc and (a is None or (a.pod_affinity is None and a.pod_anti_affinity is None)):
        return ()
    keys = set()

    def collect(sel) -> None:
        if sel is None:
            return
        keys.update(sel.match_labels.keys())
        keys.update(e.key for e in sel.match_expressions)

    for c in tsc:
        collect(c.label_selector)
    if a is not None:
        for pa in (a.pod_affinity, a.pod_anti_affinity):
            if pa is None:
                continue
            for t in pa.required:
                collect(t.label_selector)
            for w in pa.preferred:
                collect(w.pod_affinity_term.label_selector)
    # sorted: the key tuple is memo material feeding signature digests —
    # raw set iteration order is process-unstable (PYTHONHASHSEED)
    return tuple(sorted(keys))


def _intern_requests(requests: dict) -> Tuple[dict, int]:
    key = tuple(sorted(requests.items()))
    with _LOCK:
        hit = _REQ_INTERN.get(key)
        if hit is None:
            if len(_REQ_INTERN) >= _INTERN_MAX:
                _REQ_INTERN.clear()
            hit = (next(_NEXT_REQ), requests)
            _REQ_INTERN[key] = hit
        return hit[1], hit[0]


def intern_sig(sig: tuple) -> int:
    """Small-int id for a signature tuple: equal tuples get equal ids,
    so grouping hashes one int per pod instead of a nested tuple."""
    with _LOCK:
        sid = _SIG_INTERN.get(sig)
        if sid is None:
            if len(_SIG_INTERN) >= _INTERN_MAX:
                _SIG_INTERN.clear()
            sid = next(_NEXT_SIG)
            _SIG_INTERN[sig] = sid
        return sid


def _build(pod) -> PodMemo:
    requests, rid = _intern_requests(resources.requests_for_pods(pod))
    return PodMemo(selector_keys=_selector_keys(pod), requests=requests, req_id=rid)


def get_memos(pods) -> List[PodMemo]:
    return get_memos_rvs(pods)[0]


def get_memos_rvs(pods) -> Tuple[List[PodMemo], List[object]]:
    """Memos plus the resource_versions read while validating them."""
    out: List[PodMemo] = []
    rvs: List[object] = []
    append = out.append
    rv_append = rvs.append
    build = _build
    for pod in pods:
        d = pod.__dict__
        rv = pod.metadata.resource_version
        rv_append(rv)
        cached = d.get("_karp_memo")
        if cached is not None and cached[0] == rv:
            append(cached[1])
            continue
        memo = build(pod)
        d["_karp_memo"] = (rv, memo)
        append(memo)
    return out, rvs


def sig_for_id() -> Dict[int, tuple]:
    """Reverse view of the signature intern table (id → signature
    tuple), for the warm store's writer (solver/warmstore.py): interned
    ids are process-local ordinals, so persisted keys carry the signature
    content and re-intern on load."""
    with _LOCK:
        return {sid: sig for sig, sid in _SIG_INTERN.items()}


def reset() -> None:
    """Test hook: drop the dedup maps (ids stay monotonic, so stale
    memos on live pods remain harmless — they just re-intern)."""
    with _LOCK:
        _REQ_INTERN.clear()
        _SIG_INTERN.clear()


def reset_process() -> None:
    """Restart simulation (warm-store tests): reset the intern maps and
    their counters as a fresh interpreter would. Unlike ``reset()`` this
    reuses ids, so callers must also drop every pod object carrying a
    ``_karp_memo`` from the old world (a restarted process reads its
    pods afresh)."""
    global _NEXT_REQ, _NEXT_SIG
    with _LOCK:
        _REQ_INTERN.clear()
        _SIG_INTERN.clear()
        _NEXT_REQ = itertools.count()
        _NEXT_SIG = itertools.count()
