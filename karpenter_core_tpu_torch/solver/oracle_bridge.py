"""Vectorised instance-type filtering for the greedy scheduler, backed by
the batched solve's catalog encodings: the port's copy of
``karpenter_core_tpu/solver/oracle_bridge.py``.

The greedy scheduler's hot loop is ``filter_instance_types_by_requirements``
(scheduler/nodeclaim.py; ref nodeclaim.go:245): every pod added to a
claim re-filters the claim's remaining types with per-type Python set
algebra. The batched solve already holds each catalog as host mask
arrays (``EncodedInstanceTypes.key_masks/key_has/key_neg/offering_avail``);
this bridge evaluates the same three predicates as (T,)-vector numpy ops
against them:

- compat: the per-key Intersects mask logic of the compat kernel, for a
  single signature (the claim's merged requirements);
- fits: a milli-unit allocatable matrix compare (the greedy scheduler's
  exact ``resources.fits`` for whole-milli quantities);
- offering: zone/capacity-type-allowed ∧ available over the encoded
  (T, Z, C) offering array.

Nothing here touches the card: the arrays are the host side of the
encodings.

Entries: inside a ``TorchScheduler`` solve the bridge reads the
scheduler's own catalog entries (``build_scheduler(catalog_entry=...)``),
so one encoding serves both paths; a ``build_scheduler`` called alone
reads a bounded registry of the bridge's own. The first filter call of a
claim sees the pool's full type list (registered by ``refresh`` once per
scheduler build); later calls see shrinking sublists and resolve rows
through an identity map validated per lookup (``entry.catalog[row] is
it``). The maps hold their entries weakly: an entry its cache dropped (a
catalog whose content changed, or one evicted) is never served again.

Bail-outs (None → the caller runs the exact Python loop): fewer than 32
types, Gt/Lt bounds on a shared key on either side (the both-negative
carve-out is inexact for disjoint ranges), or types that are not
registered.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..apis import labels as wk
from ..scheduling import Requirements

# id(instance_type) → (weak catalog entry, row); validated by identity on
# every lookup. A live entry holds its catalog, so a mapped id cannot be
# recycled while its entry is alive.
_IT_ROWS: Dict[int, tuple] = {}
_IT_ROWS_MAX = 65536
# id(list) → (weak entry, rows, the list itself): a claim re-filters the
# SAME remaining-list object on every pod add, so row resolution is
# amortized to one identity check instead of an O(T) per-type walk. The
# strong ref to the list keeps its id from being recycled while mapped.
_LIST_ROWS: Dict[int, tuple] = {}
_LIST_ROWS_MAX = 4096


def _own_entry(catalog: List):
    """The process-wide catalog cache's entry, for a build_scheduler
    called outside a solve."""
    from .solver import _catalog_entry

    return _catalog_entry(catalog)


def refresh(instance_types: List, catalog_entry: Optional[Callable] = None) -> None:
    """Register or refresh the encoding of a pool's full catalog list,
    once per scheduler build, so in-place offering changes are caught by
    the catalog fingerprint and not rechecked per filter call.
    ``catalog_entry`` maps the list to its entry (default: the
    process-wide catalog cache)."""
    if not instance_types:
        return
    entry = (catalog_entry or _own_entry)(instance_types)
    # prune mappings whose entry is gone, so dead encodings are never
    # served (and the maps stay bounded)
    if len(_IT_ROWS) > _IT_ROWS_MAX:
        _IT_ROWS.clear()
    else:
        stale = [k for k, (ref, _) in _IT_ROWS.items() if ref() is None]
        for k in stale:
            del _IT_ROWS[k]
    stale_lists = [k for k, v in _LIST_ROWS.items() if v[0]() is None]
    for k in stale_lists:
        del _LIST_ROWS[k]
    ref = weakref.ref(entry)
    for row, it in enumerate(entry.catalog):
        _IT_ROWS[id(it)] = (ref, row)


def _bounded_keys(enc) -> frozenset:
    """Catalog keys carrying Gt/Lt bounds (cached on the encoding)."""
    cached = enc.runtime_caches.get(("bounded_keys",))
    if cached is None:
        from .solver import _cache_put

        cached = frozenset(
            key
            for key, reqs in enc.key_reqs.items()
            if any(r.greater_than is not None or r.less_than is not None for _, r in reqs)
        )
        _cache_put(enc, ("bounded_keys",), cached)
    return cached


_MILLI = 10**6  # nanos per milli-unit
_CLAMP = 1 << 62


def _alloc_milli(enc) -> Tuple[np.ndarray, Dict[str, int], np.ndarray]:
    """(T, R) milli-unit allocatable matrix + name→column map + per-type
    any-negative flag, cached on the encoding. Raw nanos overflow int64
    for large memory quantities; milli units are exact for the whole-milli
    values every real quantity has (capacity floors, requests ceil, so a
    sub-milli fragment can only make the check conservative)."""
    cached = enc.runtime_caches.get(("alloc_milli",))
    if cached is None:
        names = sorted({k for it in enc.instance_types for k in it.allocatable()})
        cols = {n: i for i, n in enumerate(names)}
        mat = np.zeros((len(enc.instance_types), len(names)), dtype=np.int64)
        neg = np.zeros(len(enc.instance_types), dtype=bool)
        for t, it in enumerate(enc.instance_types):
            for k, v in it.allocatable().items():
                # a type with ANY negative allocatable never fits
                neg[t] |= v < 0
                mat[t, cols[k]] = min(max(int(v), 0) // _MILLI, _CLAMP)
        cached = (mat, cols, neg)
        from .solver import _cache_put

        _cache_put(enc, ("alloc_milli",), cached)
    return cached


def register_filtered(parent: List, keep: np.ndarray, remaining: List) -> None:
    """Pre-register the row mapping of a filtered sublist of ``parent``.

    A claim commits ``filtered.remaining`` (a NEW list object) after
    every successful add; without this the next filter call pays an O(T)
    identity-map walk to re-resolve rows. The child's rows are the
    parent's rows masked by ``keep``."""
    if len(remaining) < 32:
        return  # fast_filter bails below 32 types: the mapping would be dead
    cached = _LIST_ROWS.get(id(parent))
    if cached is None or cached[2] is not parent:
        return
    if len(_LIST_ROWS) > _LIST_ROWS_MAX:
        _LIST_ROWS.clear()
        return  # the parent's mapping is gone too; the next call re-resolves both
    _LIST_ROWS[id(remaining)] = (cached[0], cached[1][keep], remaining)


def fast_filter(
    instance_types: List, requirements: Requirements, requests: Dict[str, int]
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """→ (compat, fits, offering) bool vectors aligned with
    ``instance_types``, or None when this list or requirement shape is
    not vectorisable (the caller runs the exact loop)."""
    # below ~32 types the exact Python loop is cheaper than the per-call
    # mask assembly
    if len(instance_types) < 32:
        return None
    from .encode import _is_neg, extend_encoded_masks

    # amortized row resolution: same list object ⇒ same rows
    lkey = id(instance_types)
    cached = _LIST_ROWS.get(lkey)
    entry = cached[0]() if cached is not None and cached[2] is instance_types else None
    if entry is not None:
        rows = cached[1]
    else:
        # resolve through the identity map; one shared entry required.
        # Unregistered lists bail to the exact loop (re-encoding here
        # would thrash the bounded caches): build_scheduler's refresh
        # registers each pool's catalog once per build.
        first = _IT_ROWS.get(id(instance_types[0]))
        entry = first[0]() if first is not None else None
        if entry is None or entry.catalog[first[1]] is not instance_types[0]:
            return None
        rows = np.empty(len(instance_types), dtype=np.int64)
        for j, it in enumerate(instance_types):
            hit = _IT_ROWS.get(id(it))
            if hit is None or hit[0]() is not entry or entry.catalog[hit[1]] is not it:
                return None
            rows[j] = hit[1]
        if len(_LIST_ROWS) > _LIST_ROWS_MAX:
            _LIST_ROWS.clear()
        _LIST_ROWS[lkey] = (weakref.ref(entry), rows, instance_types)
    enc = entry.enc

    bounded = _bounded_keys(enc)
    # pass 1: bail decisions BEFORE any vocab mutation (interning a novel
    # value and then bailing would leave the shared vocab wider than the
    # cached masks)
    for key, req in requirements.items():
        if key not in enc.key_masks:
            continue
        if key in bounded or req.greater_than is not None or req.less_than is not None:
            return None  # inexact both-negative carve-out for ranges
    # pass 2: intern + collect
    sig_masks: List[tuple] = []
    zone_allowed = None
    ct_allowed = None
    grew = False
    for key, req in requirements.items():
        if key == wk.LABEL_TOPOLOGY_ZONE:
            zone_allowed = np.array([req.has(z) for z in enc.zones], dtype=bool)
        elif key == wk.CAPACITY_TYPE_LABEL_KEY:
            ct_allowed = np.array([req.has(c) for c in enc.capacity_types], dtype=bool)
        if key not in enc.key_masks:
            continue  # the type side lacks the key entirely → Intersects passes
        kv = entry.vocab.key_vocab(key)
        before = kv.size
        for v in req.values:
            kv.intern(v)
        grew = grew or kv.size != before
        sig_masks.append((key, req))
    # self-healing width check: extend also when a past caller grew the
    # vocab without extending. The batched solve re-uploads its card-side
    # type planes when it sees the widths changed (_device_catalog).
    if grew or any(
        enc.key_masks[key].shape[1] != entry.vocab.key_vocab(key).size for key, _ in sig_masks
    ):
        extend_encoded_masks(enc, entry.vocab)

    compat = np.ones(len(rows), dtype=bool)
    for key, req in sig_masks:
        kv = entry.vocab.key_vocab(key)
        smask = entry.vocab.encode_mask(req, kv.size)
        tmask = enc.key_masks[key][rows]
        overlap = (tmask & smask[None, :]).any(axis=1)
        both_neg = enc.key_neg[key][rows] & _is_neg(req)
        # the signature side has the key by construction; the type side may not
        compat &= (~enc.key_has[key][rows]) | overlap | both_neg

    # fits: milli-unit compare over the request's keys only (ceil side)
    mat, cols, neg = _alloc_milli(enc)
    fits = ~neg[rows]
    for k, v in requests.items():
        if v <= 0:
            continue
        col = cols.get(k)
        if col is None:
            fits[:] = False
            break
        fits &= mat[rows, col] >= min(-(-int(v) // _MILLI), _CLAMP)

    # offering: some available (zone, ct) pair the requirements allow
    avail = enc.offering_avail[rows]
    if zone_allowed is not None:
        avail = avail & zone_allowed[None, :, None]
    if ct_allowed is not None:
        avail = avail & ct_allowed[None, None, :]
    offering = avail.any(axis=(1, 2))

    return compat, fits, offering
