"""Bucketed, vectorized cross-group merge engine (host numpy).

Counterpart of ``karpenter_core_tpu/solver/merge.py``, its cross-solve
screen-row memo included. The scalar merge pass
(`TorchScheduler._merge_scalar`) is a pure-Python O(N·K) pairwise
first-fit loop: per candidate pair it runs a dozen small numpy ops, two
fingerprint lookups, and a Requirements rebuild. This module keeps the
exact first-fit semantics (the scalar loop is the semantic twin of the
Go oracle's shared-node behavior) but restructures the work:

Phase 1 — bucket: records group by
(encoding, pool) identity — the first checks the scalar loop makes —
and each bucket precomputes stacked arrays: usage ``(N, R)``, seed
``alloc_cap (N, R)``, bit-packed ``(N, ceil(T/8))`` screen masks
(viable ∧ self-fits ∧ self-offering — each a *necessary* condition of
the pair checks, see below), zone/capacity-type masks, zone-pin ids,
and interned requirement fingerprints backed by a dense
intersects matrix seeded from the solver's ``_intersects_cache`` —
computed once per distinct fingerprint pair instead of per record pair.

Phase 2 — screen + apply: records run in the global sorted order. Each record's full candidate
row over its bucket's open clusters is computed in one broadcast:
zone-pin agreement, nonempty zone/ct intersections, pinned-zone bit,
bitwise-AND of the packed type masks, the combined-usage-vs-
min(alloc_cap) reject, and the exact requirements-intersects lookup.
Only the (typically tiny) surviving candidate list is walked in Python
— in cluster-creation order, preserving first-fit — through
``TPUScheduler._merge_pair_exact``, the same exact tail (combined-load
fits against ``_alloc_full``, offering availability on the intersected
masks, per-node hostname limits, Requirements union) the scalar engine
uses, so the two engines cannot drift.

Screen soundness: every vectorized reject is a necessary condition of
the scalar accept. The packed per-record mask ANDs ``viable`` with
"this record's own usage fits the type" and "the type has an available
offering within this record's own zone/ct masks"; a cluster's mask is
the AND over members. Combined usage ≥ each member's usage and the
intersected zone/ct masks ⊆ each side's own, so any type passing the
scalar's combined fits ∧ off_ok check sets the bit on every member and
on the record — the AND is nonzero. The intersects lookup is *exact*
(it is the scalar's own cached combined-fingerprint check, interned),
so the apply tail skips it.

The port has no engine switch: this vector engine is the JAX package's
default (``KARPENTER_TPU_MERGE_ENGINE=vector``, merge.py:70), and
``TorchScheduler._merge_scalar`` stays beside it as the parity reference
the tests hold it to.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .contracts import contract


# bucket-local fits precompute walks records in blocks so the
# (block, T, R) broadcast stays small
_FITS_BLOCK = 128

# optimistic pairwise screen cap: above this many records per bucket the
# (N, N, R) combined-usage broadcast outgrows its win — fall back to the
# per-record screen
_PAIR_MAX = 768


class _Bucket:
    """One (encoding, pool) class: stacked per-record tensors plus the
    live vectorized state of its open (screenable) merge clusters."""

    __slots__ = (
        "enc",
        "Z",
        "T",
        "zone_index",
        "usage",
        "alloc_cap",
        "zone_ok",
        "ct_ok",
        "zid",
        "screen8",
        "rec_fp",
        "fp_ids",
        "fps",
        "fp_reqs",
        "imat",
        "k",
        "cl_list",
        "cl_usage",
        "cl_alloc_cap",
        "cl_zone_ok",
        "cl_ct_ok",
        "cl_zid",
        "cl_screen8",
        "cl_fp",
        "cl_seed",
        "dirty",
        "pair_cand",
    )

    def __init__(self, solver, records: List[dict], idxs: List[int], scan_cap: int):
        r0 = records[idxs[0]]
        enc = r0["enc"]
        self.enc = enc
        T = len(enc.instance_types)
        Z = len(enc.zones)
        self.Z = Z
        self.T = T
        self.zone_index = {z: zi for zi, z in enumerate(enc.zones)}
        N = len(idxs)
        R = len(r0["usage"])

        self.usage = np.empty((N, R), dtype=np.int64)
        self.alloc_cap = np.empty((N, R), dtype=np.int64)
        zone_ok = np.empty((N, Z), dtype=bool)
        ct_ok = np.empty((N, len(enc.capacity_types)), dtype=bool)
        self.zid = np.empty(N, dtype=np.int32)
        for j, i in enumerate(idxs):
            r = records[i]
            self.usage[j] = r["usage"]
            self.alloc_cap[j] = r["alloc_cap"]
            zone_ok[j] = r["zone_ok"]
            ct_ok[j] = r["ct_ok"]
            self.zid[j] = self.zone_index[r["zone"]] if r["zone"] is not None else -1
        self.zone_ok = zone_ok
        self.ct_ok = ct_ok

        # packed screen rows (viable ∧ self-fits ∧ self-offering): a pure
        # function of each record's content, so records carrying a job-memo
        # identity reuse last tick's row (solver/incremental.py) instead of
        # broadcasting the (N, T, R) fits check again
        ws = getattr(solver, "_warm", None)
        stats = getattr(solver, "_cstats", None)
        rkeys = [records[i].get("_rkey") for i in idxs]
        self.screen8 = np.empty((N, (T + 7) // 8), dtype=np.uint8)
        missing: List[int] = []
        if ws is None:
            missing = list(range(N))
        else:
            for j, rk in enumerate(rkeys):
                row = ws.screen_rows.get(rk, stats) if rk is not None else None
                if row is None:
                    missing.append(j)
                else:
                    self.screen8[j] = row

        if missing:
            M = len(missing)
            viable = np.empty((M, T), dtype=bool)
            for k, j in enumerate(missing):
                viable[k] = records[idxs[j]]["viable"]
            # self-fits: types holding each record's OWN usage — combined
            # usage dominates every member's, so this is a sound screen bit
            alloc = solver._alloc_full(enc, r0["daemon"])
            usage_m = self.usage[missing]
            fits = np.empty((M, T), dtype=bool)
            for s in range(0, M, _FITS_BLOCK):
                e = min(s + _FITS_BLOCK, M)
                fits[s:e] = np.all(usage_m[s:e, None, :] <= alloc[None, :, :], axis=-1)

            # self-offering: types with an available offering within the
            # record's own zone/ct masks (zone-pin narrows to one zone);
            # records of one pack job share masks, so combos dedupe hard
            off = np.empty((M, T), dtype=bool)
            combos: Dict[tuple, np.ndarray] = {}
            avail = enc.offering_avail
            for k, j in enumerate(missing):
                if self.zid[j] >= 0:
                    zsel = np.zeros(Z, dtype=bool)
                    zsel[self.zid[j]] = True
                else:
                    zsel = zone_ok[j]
                ckey = (zsel.tobytes(), ct_ok[j].tobytes())
                v = combos.get(ckey)
                if v is None:
                    v = avail[:, zsel][:, :, ct_ok[j]].any(axis=(1, 2))
                    combos[ckey] = v
                off[k] = v

            sub8 = np.packbits(viable & fits & off, axis=1)
            for k, j in enumerate(missing):
                self.screen8[j] = sub8[k]
                if ws is not None and rkeys[j] is not None:
                    # analysis: allow-cache-key(solver) — the row's content is fixed by its _rkey (job-key identity); the solver is only the receiver
                    ws.screen_rows.put(rkeys[j], sub8[k].copy(), stats)

        # requirement fingerprints interned per bucket; the intersects
        # matrix is EXACT (the scalar's own check, memoized per distinct
        # pair) and lazily filled, seeded from solver._intersects_cache
        self.fp_ids: Dict[tuple, int] = {}
        self.fps: List[tuple] = []
        self.fp_reqs: List[object] = []
        self.imat = np.full((16, 16), -1, dtype=np.int8)
        self.rec_fp = np.empty(N, dtype=np.int32)
        for j, i in enumerate(idxs):
            merged = records[i]["merged"]
            self.rec_fp[j] = (
                -1 if merged is None else self._intern(merged.fingerprint(), merged)
            )

        # open-cluster state (only the globally screenable prefix)
        cap = scan_cap
        self.k = 0
        self.cl_list: List[dict] = []
        self.cl_usage = np.empty((cap, R), dtype=np.int64)
        self.cl_alloc_cap = np.empty((cap, R), dtype=np.int64)
        self.cl_zone_ok = np.empty((cap, Z), dtype=bool)
        self.cl_ct_ok = np.empty((cap, ct_ok.shape[1]), dtype=bool)
        self.cl_zid = np.empty(cap, dtype=np.int32)
        self.cl_screen8 = np.empty((cap, self.screen8.shape[1]), dtype=np.uint8)
        self.cl_fp = np.empty(cap, dtype=np.int32)
        # optimistic screen state: while no cluster of this bucket has
        # absorbed anything, every open cluster is bit-identical to its
        # seed record, so the per-record screen is a row gather from ONE
        # pairwise record×record candidate matrix (computed lazily).
        # The first absorb sets ``dirty`` and the bucket falls back to
        # the per-record broadcast (screen_candidates) for good.
        self.cl_seed = np.empty(cap, dtype=np.int64)
        self.dirty = False
        self.pair_cand: Optional[np.ndarray] = None

    # -- fingerprint interning / exact intersects lookups ---------------

    def _intern(self, fp: tuple, reqs) -> int:
        fid = self.fp_ids.get(fp)
        if fid is None:
            fid = len(self.fps)
            self.fp_ids[fp] = fid
            self.fps.append(fp)
            self.fp_reqs.append(reqs)
            if fid >= self.imat.shape[0]:
                grown = np.full((2 * fid, 2 * fid), -1, dtype=np.int8)
                grown[: self.imat.shape[0], : self.imat.shape[1]] = self.imat
                self.imat = grown
        return fid

    def _intersects_row(self, solver, cl_fp: np.ndarray, rid: int) -> np.ndarray:
        """(len(cl_fp),) bool of exact Requirements.intersects verdicts
        between each cluster fingerprint and the record's, via the dense
        matrix; unknown pairs compute once and land in the matrix AND in
        the solver's cross-engine ``_intersects_cache``."""
        vals = self.imat[cl_fp, rid]
        unknown = np.flatnonzero(vals < 0)
        if unknown.size:
            cache = solver._intersects_cache
            fp_r, req_r = self.fps[rid], self.fp_reqs[rid]
            for u in unknown:
                aid = int(cl_fp[u])
                key = (self.fps[aid], fp_r)
                ok = cache.get(key)
                if ok is None:
                    ok = self.fp_reqs[aid].intersects(req_r) is None
                    # fp_reqs[i] is the Requirements object interned
                    # UNDER fps[i] (same index, _intern): the key's
                    # fingerprints are content addresses of exactly the
                    # two objects intersected; cl_fp/rid/imat only select
                    # which interned pair is being resolved
                    # analysis: allow-cache-key(self.fp_reqs, self.imat, cl_fp, rid)
                    cache[key] = ok
                    cache[(fp_r, self.fps[aid])] = ok
                v = np.int8(1 if ok else 0)
                self.imat[aid, rid] = v
                self.imat[rid, aid] = v
                vals[u] = v
        return vals > 0

    def pair_candidates(self, solver) -> np.ndarray:
        """(N, N) screen verdicts between every record pair of this
        bucket, condition-for-condition identical to screen_candidates
        PLUS the exact intersects lookup — valid against any cluster
        that is still bit-identical to its seed record (no absorbs).
        Computed once per bucket, lazily."""
        if self.pair_cand is not None:
            return self.pair_cand
        N = self.usage.shape[0]
        zid = self.zid
        # zone-pin agreement (cluster axis = columns / seeds)
        cand = (zid[None, :] == -1) | (zid[:, None] == -1) | (
            zid[None, :] == zid[:, None]
        )
        # both sides carry a requirement fingerprint
        cand &= (self.rec_fp[:, None] >= 0) & (self.rec_fp[None, :] >= 0)
        zo = self.zone_ok.astype(np.float32)
        co = self.ct_ok.astype(np.float32)
        cand &= (zo @ zo.T) > 0
        cand &= (co @ co.T) > 0
        # the effective pinned zone must survive the intersection
        if self.Z:
            eff = np.where(zid[None, :] >= 0, zid[None, :], zid[:, None])
            effc = np.clip(eff, 0, self.Z - 1)
            rows = np.arange(N)
            zi_at = self.zone_ok[rows[:, None], effc]
            zj_at = self.zone_ok[rows[None, :], effc]
            cand &= (eff < 0) | (zi_at & zj_at)
        # packed screen masks overlap (viable ∧ fits ∧ offering)
        sb = np.unpackbits(self.screen8, axis=1)[:, : self.T].astype(np.float32)
        cand &= (sb @ sb.T) > 0
        # combined usage within both sides' alloc_cap seeds
        cand &= np.all(
            self.usage[:, None, :] + self.usage[None, :, :]
            <= np.minimum(self.alloc_cap[:, None, :], self.alloc_cap[None, :, :]),
            axis=-1,
        )
        # exact pairwise intersects via the interned fingerprint matrix
        # (fills the same imat / cross-solve cache the fallback uses)
        fps = np.unique(self.rec_fp[self.rec_fp >= 0])
        for fid in fps:
            self._intersects_row(solver, fps, int(fid))
        safe = np.clip(self.rec_fp, 0, None)
        cand &= self.imat[safe[:, None], safe[None, :]] > 0
        self.pair_cand = cand
        return cand

    # -- cluster state ---------------------------------------------------

    def add_cluster(self, m: dict, j: int) -> None:
        """Track a fresh cluster (seeded from bucket-record j) in the
        screenable window."""
        k = self.k
        self.cl_list.append(m)
        self.cl_usage[k] = self.usage[j]
        self.cl_alloc_cap[k] = self.alloc_cap[j]  # seed's — never updated,
        # matching the scalar engine's cheap-reject exactly
        self.cl_zone_ok[k] = self.zone_ok[j]
        self.cl_ct_ok[k] = self.ct_ok[j]
        self.cl_zid[k] = self.zid[j]
        self.cl_screen8[k] = self.screen8[j]
        self.cl_fp[k] = self.rec_fp[j]
        self.cl_seed[k] = j
        self.k = k + 1

    def absorb(self, k: int, j: int, m: dict) -> None:
        """Fold record j into cluster row k after a successful exact
        merge (m is the cluster dict _merge_pair_exact just updated)."""
        self.dirty = True  # cluster k no longer mirrors its seed record
        self.cl_usage[k] += self.usage[j]
        if self.cl_zid[k] < 0:
            self.cl_zid[k] = self.zid[j]
        self.cl_zone_ok[k] &= self.zone_ok[j]
        self.cl_ct_ok[k] &= self.ct_ok[j]
        self.cl_screen8[k] &= self.screen8[j]
        merged = m["merged"]
        self.cl_fp[k] = self._intern(merged.fingerprint(), merged)


@contract(
    "K", "K", "K Z", "K C", "K B", "K R", "K R", "()", "Z", "C", "B", "R", "R",
    out="K",
    eval_shape=False,
)
def screen_candidates(
    cl_zid: np.ndarray,
    cl_fp: np.ndarray,
    cl_zone_ok: np.ndarray,
    cl_ct_ok: np.ndarray,
    cl_screen8: np.ndarray,
    cl_usage: np.ndarray,
    cl_alloc_cap: np.ndarray,
    rz,
    zone_ok: np.ndarray,
    ct_ok: np.ndarray,
    screen8: np.ndarray,
    usage: np.ndarray,
    alloc_cap: np.ndarray,
) -> np.ndarray:
    """One record's full candidate row over K open clusters in one
    broadcast (every reject a *necessary* condition of the scalar
    accept — see module docstring) → (K,) bool."""
    K = cl_zid.shape[0]
    Z = zone_ok.shape[0]
    cand = ((cl_zid == -1) | (rz == -1) | (cl_zid == rz)) & (cl_fp >= 0)
    zinter = cl_zone_ok & zone_ok[None, :]
    cand &= zinter.any(axis=1)
    cand &= (cl_ct_ok & ct_ok[None, :]).any(axis=1)
    eff = np.where(cl_zid >= 0, cl_zid, rz)
    if Z and (eff >= 0).any():
        zbit = zinter[np.arange(K), np.clip(eff, 0, Z - 1)]
        cand &= (eff < 0) | zbit
    cand &= ((cl_screen8 & screen8[None, :]) != 0).any(axis=1)
    cand &= np.all(
        cl_usage + usage[None, :] <= np.minimum(cl_alloc_cap, alloc_cap[None, :]),
        axis=1,
    )
    return cand


def merge_records_vector(
    solver, records: List[dict], pods, scan_cap: int
) -> List[dict]:
    """Vectorized first-fit merge over pre-sorted records → the merged
    cluster list (same order and contents as the scalar engine)."""
    st = solver._merge_stats
    merged: List[dict] = []

    by_key: Dict[tuple, List[int]] = {}
    for i, r in enumerate(records):
        # daemon rides in the key so every record of a bucket shares
        # the _alloc_full table the fits screen precomputes against
        # (one daemon vector per pool makes this a no-op split)
        by_key.setdefault(
            (id(r["enc"]), id(r["pool"]), len(r["usage"]), r["daemon"].tobytes()),
            [],
        ).append(i)
    buckets: List[Optional[tuple]] = [None] * len(records)
    for idxs in by_key.values():
        b = _Bucket(solver, records, idxs, scan_cap)
        for j, i in enumerate(idxs):
            buckets[i] = (b, j)

    screened = 0
    applied = 0
    for i, r in enumerate(records):
        b, j = buckets[i]
        placed = False
        # clusters past the global scan cap are emit-only, exactly
        # like the scalar engine's merged[:cap] window
        K = b.k
        if K and b.rec_fp[j] >= 0:
            screened += K
            if not b.dirty and b.usage.shape[0] <= _PAIR_MAX:
                # optimistic path: every open cluster still mirrors
                # its seed record, so the row is a gather from the
                # pairwise matrix (intersects already folded in)
                rows = np.flatnonzero(b.pair_candidates(solver)[j, b.cl_seed[:K]])
            else:
                cand = screen_candidates(
                    b.cl_zid[:K],
                    b.cl_fp[:K],
                    b.cl_zone_ok[:K],
                    b.cl_ct_ok[:K],
                    b.cl_screen8[:K],
                    b.cl_usage[:K],
                    b.cl_alloc_cap[:K],
                    b.zid[j],
                    b.zone_ok[j],
                    b.ct_ok[j],
                    b.screen8[j],
                    b.usage[j],
                    b.alloc_cap[j],
                )
                rows = np.flatnonzero(cand)
                if rows.size:
                    ok = b._intersects_row(solver, b.cl_fp[rows], int(b.rec_fp[j]))
                    rows = rows[ok]
            for k in rows:
                m = b.cl_list[int(k)]
                if solver._merge_pair_exact(m, r, pods, skip_intersects=True):
                    b.absorb(int(k), j, m)
                    applied += 1
                    placed = True
                    break
        if not placed:
            m = dict(r, members=list(r["members"]))
            merged.append(m)
            if len(merged) <= scan_cap:
                b.add_cluster(m, j)

    st["merge_candidates_screened"] = st.get("merge_candidates_screened", 0) + screened
    st["merge_pairs_applied"] = st.get("merge_pairs_applied", 0) + applied
    return merged
