"""Warm-state persistence: snapshot and restore of the cross-solve planes.

Counterpart of ``karpenter_core_tpu/solver/warmstore.py``. A restarted
provisioner pays the cold, restart-shaped solve on its first ticks; the
memo planes are content-addressed with process-stable blake2b
fingerprints (solver/stablehash.py), so this module writes them to a
versioned snapshot file and re-anchors them in a fresh process, whose
first solve is then a warm one.

What persists, per plane:

- **catalog** (``solver._CATALOG_CACHE``): vocab, axis and the numpy
  encoding of each entry this solver's pools resolve to, with the
  entry's derived-array caches (content keys only). Stored by content
  fingerprint: the in-memory identity key is an address and never
  written. The card-resident type side (``device_catalog``) is left out
  and uploaded again at first use on the restoring solver's device: a
  snapshot holds host data only, never a CUDA tensor.
- **compat** (``_CatalogEntry.sig_rows``): host numpy rows keyed by
  (pool fingerprint, signature, device); signatures are stored as their
  content and re-interned on load.
- **job**, **merge**, **emit**, **mergerow**: keys carry the catalog
  entry's identity head ``(id(entry), fingerprint)``, stored as
  ``("encfp", fingerprint)`` and rebound to the live entry on load.
- **route**: stored as signature tuples and re-interned.
- **seeds**: guarded in memory by ``Cluster.generation()``, which does
  not survive a restart; the snapshot records a content witness of the
  kube-visible pod, node and claim world, and on load the plane restores
  only when the live world's witness matches, re-anchored to the live
  generation.
- **intersects**: fingerprint-addressed, as is.
- **lprelax**: the solver device's LP relaxation memo
  (``backends/lp.py::export_relax_plane``), content-keyed.

- **jitsig**: the device plane's signature inventory
  (``deviceplane.export_signatures``), restored only onto entry points
  this process registered with the same static-argument names.
- **compilecache**: the manifest of the kernel libraries the writer
  loaded (``buildlib.loaded_libraries``), each named by the hash of its
  source and nvcc command, beside the writer's fingerprint
  (``backend.compile_cache_fingerprint``: torch, CUDA, the card's
  capability, the sources' digests). Under another torch, CUDA or card
  the whole manifest is dropped and counted; so is a row whose source's
  digest differs or that the live tree would build to another library.
  The boot prewarm
  (``prewarm.warmup_compile_only``) loads the kept rows' kernels, so a
  restored process's first solve loads none.

The device-computed planes (compat rows, job, merge, emit, mergerow,
lprelax) restore only into a solver on the writer's device; on another
device they are dropped and counted. The fleet's planes (fleet/megasolve.py) ride the same store: a
tenant's restore publishes each restored job skeleton into the fleet's
``fleetjob`` content plane (``restore(..., fleet_plane=)``), and the
canonical-catalog plane persists by content fingerprint
(``snapshot_fleet_plane`` / ``restore_fleet_plane``); the ``fleetenv``
memo is keyed by live generation counters and never written.

Soundness: a restored entry must witness the same read-set as a freshly
computed one. An entry whose witness does not match the live world is
dropped, never trusted, and every plane reports restored and dropped
counts (``last_warmstore_stats`` and the
``karpenter_tpu_warmstore_{restored,dropped}_entries{plane=...}``
counters). A snapshot whose magic, schema, key contract or digest
differs (one the JAX package wrote, say) is dropped whole.

The snapshot directory is the ``directory=`` argument, else
``WARMSTORE_DIR`` (None: persistence off), and ``MAX_MB`` caps a
snapshot's size (planes are trimmed cheapest first, and the trims
recorded).
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import pickle
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import buildlib
from ..tracing import deviceplane, tracer
from . import backend, incremental, podcache
from .stablehash import stable_hash

log = logging.getLogger("karpenter.torch.warmstore")

SCHEMA = 2

# the snapshot directory and the size cap: the defaults of the JAX
# package's KARPENTER_TPU_WARMSTORE_DIR (unset) and _MAX_MB
WARMSTORE_DIR: Optional[str] = None
MAX_MB = 256.0

#: The writer's key-layout contract, one line per plane. A change to how
#: a plane's keys are built must edit its line (and so the contract
#: hash): a reader whose contract differs drops the whole snapshot.
_KEY_CONTRACT = (
    ("catalog", "content fp -> (vocab, axis, numpy enc); sig_rows[(pool_fp, sig_tuple, device)]"),
    ("compat", "(pool_fp, sig_tuple, device) -> SigRow (host numpy rows) on the owning catalog entry"),
    ("route", "(sig_tuple..., ('ce', 'tensor')) -> (tensor_idx, parked_idx, oracle_idx)"),
    ("job", "(('encfp', fp), pool_fp, zone, reqs digest, masks..., port features, engine+backend tokens, device) + tenant scope -> JobSkeleton"),
    ("merge", "('vector', scan_cap, rkey stream) -> MergeSkeleton; rkey = (job key, node ordinal)"),
    ("emit", "absorption trail (rkey...) -> emitted offering choice"),
    ("mergerow", "rkey -> packed screen row"),
    ("seeds", "(constraint key..., exclusion uids, sim_drained, tenant scope) -> domain counts; plane guard = cluster witness"),
    ("intersects", "(reqs fp, reqs fp) -> bool"),
    ("lprelax", "(reqs digest, capacity bytes, price-table float64 bytes, iteration budget int, refine-stage tag...) -> (t_star, has_fit, float64 bound, dual weights)"),
    ("jitsig", "(fn name, static-argname tuple) -> signature keys (deviceplane inventory; static reprs bounded at 512)"),
    ("compilecache", "{torch, cuda, capability, sources {source: sha256[:16]}, libraries [{source, library (lib<stem>-<sha256(source, nvcc command)[:12]>.so), kernels}] the writer loaded}"),
    ("device", "compat, job, merge, emit, mergerow and lprelax restore only into a solver on the writer's device"),
)
CONTRACT = stable_hash(_KEY_CONTRACT).hex()

_MAGIC = b"KTORCH-WARMSTORE\n"

# payload planes in trim order: over MAX_MB the cheapest to recompute
# drop first (catalogs last: they are the largest cold-solve cost)
_TRIM_ORDER = ("jitsigs", "lprelax", "screen_rows", "emits", "merges", "intersects", "jobs", "routes", "seeds", "catalogs")

# the device-computed planes (see the module docstring)
_DEVICE_PLANES = ("compat", "job", "merge", "emit", "mergerow", "lprelax")

_LAST_LOCK = threading.Lock()
_LAST: Dict[str, Optional[dict]] = {"snapshot": None, "restore": None}


def max_bytes() -> int:
    return max(1, int(float(MAX_MB) * 1024 * 1024))


def last_outcomes() -> dict:
    with _LAST_LOCK:
        return {k: dict(v) if v else None for k, v in _LAST.items()}


def _set_last(kind: str, outcome: dict) -> None:
    with _LAST_LOCK:
        _LAST[kind] = dict(outcome)


# -- key codecs: in-memory identity heads <-> content-addressed stored keys ---


def _store_job_key(key: tuple) -> Optional[tuple]:
    """Persisted form of one job-memo key: the identity head
    ``(id(entry), fp)`` becomes ``("encfp", fp)`` and the trailing
    tenant scope is split off (written once per snapshot)."""
    head = key[0]
    if not (isinstance(head, tuple) and len(head) == 2 and isinstance(head[1], bytes)):
        return None
    return (("encfp", head[1]),) + key[1:-1]


def _rebind_job_key(stored: tuple, enc_heads: Dict[bytes, tuple], tenant_scope: tuple) -> Optional[tuple]:
    """Re-anchor one persisted job key: ``("encfp", fp)`` rebinds to the
    live catalog entry's identity head (no live entry of that content →
    dropped) and the snapshot's tenant scope rides the key unchanged."""
    tag = stored[0]
    if not (isinstance(tag, tuple) and len(tag) == 2 and tag[0] == "encfp"):
        return None
    head = enc_heads.get(tag[1])
    if head is None:
        return None
    return (head,) + stored[1:] + (tenant_scope,)


def _store_rkey(rkey: tuple) -> Optional[tuple]:
    jk = _store_job_key(rkey[0])
    return None if jk is None else (jk, int(rkey[1]))


def _rebind_rkey(stored: tuple, enc_heads: Dict[bytes, tuple], tenant_scope: tuple) -> Optional[tuple]:
    jk = _rebind_job_key(stored[0], enc_heads, tenant_scope)
    return None if jk is None else (jk, int(stored[1]))


def _sanitize_runtime_caches(caches: dict) -> dict:
    """The persistable part of an encoding's derived-array cache: numpy
    values under content keys. The ``("type_ord",)`` table maps object
    ids and must never cross a process boundary."""
    return {k: v for k, v in caches.items() if k != ("type_ord",) and isinstance(v, np.ndarray)}


# -- the cluster-world witness of the seed plane --------------------------------


def cluster_witness(kube_client) -> Optional[bytes]:
    """Content digest of the kube-visible pod, node and claim world the
    seed counts derive from. Conservative: any difference (one the seeds
    would not see included) drops the seed plane to a recount."""
    if kube_client is None:
        return None
    try:
        pods = tuple(sorted(
            (
                p.namespace,
                p.metadata.name,
                tuple(sorted((p.metadata.labels or {}).items())),
                p.spec.node_name or "",
                getattr(p.status, "phase", "") or "",
                p.metadata.deletion_timestamp is not None,
            )
            for p in kube_client.list("Pod")
        ))
        nodes = tuple(sorted(
            (n.metadata.name, tuple(sorted((n.metadata.labels or {}).items())))
            for n in kube_client.list("Node")
        ))
        claims = tuple(sorted(
            (c.metadata.name, tuple(sorted((c.metadata.labels or {}).items())))
            for c in kube_client.list("NodeClaim")
        ))
        return stable_hash((pods, nodes, claims))
    except Exception:  # noqa: BLE001 — a witness failure degrades to "no seeds"
        log.debug("cluster witness failed", exc_info=True)
        return None


# -- snapshot (writer) ------------------------------------------------------------


def _collect_catalog_entries(solver) -> List[tuple]:
    """(fingerprint, entry) of every cached catalog entry this solver's
    pools resolve to."""
    from .solver import _CATALOG_CACHE, _CATALOG_LOCK

    _pools, pool_catalogs = solver._build_pools()
    out: List[tuple] = []
    seen = set()
    with _CATALOG_LOCK:
        for cat in pool_catalogs:
            entry = _CATALOG_CACHE.get(tuple(map(id, cat)))
            if entry is None or entry.fingerprint in seen:
                continue
            seen.add(entry.fingerprint)
            out.append((entry.fingerprint, entry))
    return out


def build_payload(solver) -> dict:
    """The (pre-pickle) snapshot payload of the solver's warm state and
    catalog entries: host data only. Reads, never mutates, the planes."""
    from .backends import lp as lp_backend
    from .solver import _CATALOG_LOCK

    ws = incremental.warm_state_for(solver)
    tenant_scope = tuple(getattr(solver, "_tenant_scope", ()) or ())
    sig_names = podcache.sig_for_id()

    catalogs: List[dict] = []
    # the catalog fetch probes the cloud provider (its own lock): before
    # _CATALOG_LOCK, which never nests a foreign lock
    entries = _collect_catalog_entries(solver)
    with _CATALOG_LOCK:
        for fp, entry in entries:
            rows = []
            for (pool_fp, sid, device), row in entry.sig_rows.items():
                sig = sig_names.get(sid)
                if sig is not None:  # the intern table may have been cleared: drop, never guess
                    rows.append((pool_fp, sig, device, row))
            enc = copy.copy(entry.enc)
            enc.runtime_caches = {}
            catalogs.append(dict(
                fingerprint=fp,
                vocab=entry.vocab,
                axis=entry.axis,
                enc=enc,
                runtime_caches=_sanitize_runtime_caches(entry.enc.runtime_caches),
                sig_rows=rows,
            ))

    payload: dict = {
        "schema": SCHEMA,
        "contract": CONTRACT,
        "tenant": tenant_scope,
        "device": str(solver.device),
        "catalogs": catalogs,
        "routes": [],
        "jobs": [],
        "merges": [],
        "emits": [],
        "screen_rows": [],
        "seeds": {"witness": None, "generation": None, "entries": []},
        "intersects": [],
        # the LP relaxation memo of the solver's device: keys are
        # digests, bytes and ints, values numpy (nothing process-private)
        "lprelax": lp_backend.export_relax_plane(solver.device),
        # the device plane's signature inventory and the kernel libraries'
        # manifest: keys and names only
        "jitsigs": deviceplane.export_signatures(),
        "compilecache": dict(backend.compile_cache_fingerprint(), libraries=buildlib.loaded_libraries()),
    }
    if ws is None:
        return payload

    for key, val in ws.routes.items():
        # analysis: allow-process-boundary — the ordinals are translated here; only the signatures' content is stored
        sigs = [sig_names.get(part) for part in key[:-1]]
        if all(sig is not None for sig in sigs):
            payload["routes"].append((tuple(sigs), key[-1], val))

    for key, skel in ws.jobs.items():
        stored = _store_job_key(key)
        if stored is not None:
            payload["jobs"].append((stored, skel))

    for key, skel in ws.merges.items():
        engine, cap, rkeys = key
        srk = [_store_rkey(rk) for rk in rkeys]
        if any(s is None for s in srk):
            continue
        clusters = []
        for cluster in skel.clusters:
            trail = [_store_rkey(rk) for rk in cluster[0]]
            if any(t is None for t in trail):
                clusters = None
                break
            clusters.append((tuple(trail),) + tuple(cluster[1:]))
        if clusters is not None:
            payload["merges"].append(((engine, cap, tuple(srk)), clusters, int(skel.applied)))

    for trail, emitted in ws.emits.items():
        strail = [_store_rkey(rk) for rk in trail]
        if not any(s is None for s in strail):
            payload["emits"].append((tuple(strail), emitted))

    for rkey, row in ws.screen_rows.items():
        stored = _store_rkey(rkey)
        if stored is not None:
            payload["screen_rows"].append((stored, row))

    # the witness reads the kube store (its own lock): before ws.lock
    witness = cluster_witness(solver.kube_client)
    with ws.lock:
        payload["seeds"] = {
            "witness": witness,
            # the writer's counter value, for debugging only: restore
            # re-anchors to the live cluster's counter
            "generation": ws.seed_generation,
            "entries": [(k, dict(v)) for k, v in ws.seed_lru.items()],
        }
    payload["intersects"] = list(ws.intersects.items())
    return payload


def _plane_counts(payload: dict) -> dict:
    return {
        "catalog": len(payload.get("catalogs", ())),
        "compat": sum(len(c["sig_rows"]) for c in payload.get("catalogs", ())),
        "route": len(payload.get("routes", ())),
        "job": len(payload.get("jobs", ())),
        "merge": len(payload.get("merges", ())),
        "emit": len(payload.get("emits", ())),
        "mergerow": len(payload.get("screen_rows", ())),
        "seeds": len((payload.get("seeds") or {}).get("entries", ())),
        "intersects": len(payload.get("intersects", ())),
        "lprelax": len(payload.get("lprelax", ())),
        "jitsig": sum(len(r[2]) for r in payload.get("jitsigs", ()) if len(r) == 3),
        "compilecache": len((payload.get("compilecache") or {}).get("libraries", ())),
    }


def write_snapshot(payload: dict, directory: str) -> Optional[str]:
    """Write one payload to a content-addressed snapshot file. An
    oversized payload trims planes in ``_TRIM_ORDER`` (recorded in the
    header). → the path, or None when nothing useful fits."""
    trimmed: List[str] = []
    cap = max_bytes()
    body = pickle.dumps(payload, protocol=4)
    for plane in _TRIM_ORDER:
        if len(body) <= cap:
            break
        if plane == "seeds":
            payload["seeds"] = {"witness": None, "generation": None, "entries": []}
        elif payload.get(plane):
            payload[plane] = []
        else:
            continue
        trimmed.append(plane)
        body = pickle.dumps(payload, protocol=4)
    if len(body) > cap:
        log.warning("warm-store snapshot exceeds its cap even after trimming; not written")
        return None
    header = {
        "schema": SCHEMA,
        "contract": CONTRACT,
        "payload_sha256": hashlib.sha256(body).hexdigest(),
        "planes": _plane_counts(payload),
        "tenant": list(payload.get("tenant", ())),
        "device": payload.get("device"),
        "trimmed": trimmed,
    }
    os.makedirs(directory, exist_ok=True)
    digest = hashlib.blake2b(body, digest_size=8).hexdigest()
    path = os.path.join(directory, f"warmstore-{digest}.snap")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write((json.dumps(header) + "\n").encode())
        f.write(body)
    os.replace(tmp, path)  # a killed writer never leaves a half snapshot
    return path


def snapshot(solver, directory: Optional[str] = None) -> Optional[str]:
    """Snapshot the solver's warm planes into ``directory`` (default
    ``WARMSTORE_DIR``; None: persistence off → None). Never raises: a
    failure leaves the cold restart the process would have paid anyway."""
    directory = directory or WARMSTORE_DIR
    if directory is None:
        return None
    try:
        with tracer.trace_root("warmstore.snapshot", buffer_if="never"):
            payload = build_payload(solver)
            path = write_snapshot(payload, directory)
    except Exception:  # noqa: BLE001 — persistence never fails the caller
        log.exception("warm-store snapshot failed")
        return None
    if path is not None:
        _set_last("snapshot", {"path": path, "planes": _plane_counts(payload)})
    return path


# -- restore (reader) ------------------------------------------------------------


def read_snapshot(path: str) -> Tuple[Optional[dict], Optional[str]]:
    """→ (payload, drop reason). A snapshot is dropped whole on any
    magic, schema, contract or digest mismatch: restored state is either
    provably the writer's, or absent."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        return None, f"unreadable: {e}"
    if not raw.startswith(_MAGIC):
        return None, "bad magic"
    try:
        nl = raw.index(b"\n", len(_MAGIC))
        header = json.loads(raw[len(_MAGIC):nl])
        body = raw[nl + 1:]
    except (ValueError, json.JSONDecodeError) as e:
        return None, f"bad header: {e}"
    if header.get("schema") != SCHEMA:
        return None, f"schema mismatch: {header.get('schema')} != {SCHEMA}"
    if header.get("contract") != CONTRACT:
        return None, "key-layout contract mismatch"
    if hashlib.sha256(body).hexdigest() != header.get("payload_sha256"):
        return None, "payload digest mismatch (truncated or corrupt)"
    try:
        payload = pickle.loads(body)
    except Exception as e:  # noqa: BLE001 — any unpickling failure means "no snapshot"
        return None, f"unpicklable payload: {e}"
    if payload.get("schema") != SCHEMA or payload.get("contract") != CONTRACT:
        return None, "payload/header version skew"
    return payload, None


class _Outcome:
    """Per-plane restored and dropped counts."""

    def __init__(self, path: str):
        self.path = path
        self.restored: Dict[str, int] = {}
        self.dropped: Dict[str, int] = {}
        self.reason: Optional[str] = None

    def ok(self, plane: str, n: int = 1) -> None:
        if n:
            self.restored[plane] = self.restored.get(plane, 0) + n

    def drop(self, plane: str, n: int = 1) -> None:
        if n:
            self.dropped[plane] = self.dropped.get(plane, 0) + n

    def drop_all(self, payload: Optional[dict], reason: str) -> dict:
        self.reason = reason
        if payload is not None:
            for plane, n in _plane_counts(payload).items():
                self.drop(plane, n)
        else:
            self.drop("snapshot", 1)
        return self.to_dict()

    def to_dict(self) -> dict:
        out = {"path": self.path, "restored": dict(self.restored), "dropped": dict(self.dropped)}
        if self.reason:
            out["reason"] = self.reason
        return out


def _restore_catalogs(solver, payload: dict, same_device: bool, out: _Outcome) -> Dict[bytes, tuple]:
    """Install the snapshot's catalog entries whose content fingerprint
    matches a live catalog, rebound to the live objects and generation,
    and their compat rows (only from a writer on this device). → fp →
    live identity head, for rebinding job keys."""
    from .solver import (
        _CATALOG_CACHE,
        _CATALOG_LOCK,
        _CatalogEntry,
        _cache_insert,
        _catalog_fingerprint,
    )

    cg = getattr(solver.cloud_provider, "catalog_generation", None)
    pools, pool_catalogs = solver._build_pools()
    live: Dict[bytes, tuple] = {}  # fp -> (catalog list, generation)
    for pool, cat in zip(pools, pool_catalogs):
        gen = cg(pool.nodepool) if callable(cg) else None
        live.setdefault(_catalog_fingerprint(cat), (cat, gen))

    enc_heads: Dict[bytes, tuple] = {}
    with _CATALOG_LOCK:
        for snap in payload.get("catalogs", ()):
            fp = snap["fingerprint"]
            hit = live.get(fp)
            if hit is None:
                # the live catalog's content differs: the entry and every
                # row on it are dropped, never trusted
                out.drop("catalog")
                out.drop("compat", len(snap["sig_rows"]))
                continue
            cat, gen = hit
            key = tuple(map(id, cat))
            entry = _CATALOG_CACHE.get(key)
            if entry is None or entry.fingerprint != fp:
                enc = snap["enc"]
                # equal digests mean position-wise identical content: the
                # encoding rebinds to the live catalog objects
                enc.instance_types = list(cat)
                enc.runtime_caches = dict(snap.get("runtime_caches") or {})
                entry = _CatalogEntry(list(cat), fp, snap["vocab"], snap["axis"], enc, generation=gen)
                _cache_insert(key, entry)
            else:
                entry.generation = gen
            entry.own(solver.cloud_provider)
            out.ok("catalog")
            enc_heads[fp] = (id(entry), fp)
            if not same_device:
                out.drop("compat", len(snap["sig_rows"]))
                continue
            cap = incremental.cache_cap("compat")
            for pool_fp, sig, device, row in snap["sig_rows"]:
                rkey = (pool_fp, podcache.intern_sig(sig), device)
                if rkey not in entry.sig_rows:
                    entry.sig_rows[rkey] = row
                    entry.sig_rows.move_to_end(rkey)
                    while len(entry.sig_rows) > cap:
                        entry.sig_rows.popitem(last=False)
            out.ok("compat", len(snap["sig_rows"]))
    return enc_heads


def _restore_seeds(ws, plane: dict, live_witness: Optional[bytes], live_generation: Optional[int],
                   out: _Outcome) -> None:
    """Re-anchor the seed plane: valid only when the recorded cluster
    witness matches the live world, and then bound to the live
    generation, so the next informer event invalidates it like seeds
    counted in this process."""
    entries = plane.get("entries") or []
    if not entries:
        return
    witness = plane.get("witness")
    if live_generation is None or witness is None or live_witness is None or witness != live_witness:
        out.drop("seeds", len(entries))
        return
    with ws.lock:
        ws.seed_lru.clear()
        ws.seed_generation = live_generation
        for key, val in entries:
            ws.seed_lru.put(key, dict(val))
    out.ok("seeds", len(entries))


def _restore_lprelax(solver, payload: dict, out: _Outcome) -> None:
    """Re-anchor the LP relaxation memo into the solver device's plane.
    Each row must parse as the contract line says (bytes keys, a sane
    iteration budget, a finite price table and bound); the live key is
    rebuilt from the parsed parts, and a malformed row is dropped."""
    rows = payload.get("lprelax", ())
    if not rows:
        return
    from .backends import lp as lp_backend

    plane = lp_backend.relax_plane(solver.device)
    for row in rows:
        try:
            key, value = row
            digest, alloc_b, prices_b, iters = key[0], key[1], key[2], key[3]
            stage = tuple(key[4:])
            if not (isinstance(digest, bytes) and isinstance(alloc_b, bytes) and isinstance(prices_b, bytes)):
                out.drop("lprelax")
                continue
            if not isinstance(iters, int) or iters < 8:
                out.drop("lprelax")
                continue
            prices = np.frombuffer(prices_b, dtype=np.float64)
            if prices.size == 0 or not np.isfinite(prices).all():
                out.drop("lprelax")
                continue
            t_star, has_fit, bound, w = value
            if not (np.isfinite(float(bound)) and float(bound) >= 0.0):
                out.drop("lprelax")
                continue
            plane.put(
                (digest, alloc_b, prices_b, int(iters)) + stage,
                (np.asarray(t_star), np.asarray(has_fit, dtype=bool), float(bound), np.asarray(w)),
            )
            out.ok("lprelax")
        except (TypeError, ValueError, IndexError):
            out.drop("lprelax")


def restore(solver, path: str, metrics=None, fleet_plane=None) -> dict:
    """Restore a snapshot into ``solver``'s warm world. Every plane
    re-anchors against the live world; what fails its witness is dropped
    and counted. ``fleet_plane`` (the fleet's ``SkeletonPlane``) also
    takes each restored job skeleton under the key's tenant-free prefix,
    as a live solve publishes it. → the outcome (also
    ``solver.last_warmstore_stats`` and the warm-store counters of
    ``metrics``)."""
    out = _Outcome(path)
    try:
        with tracer.trace_root("warmstore.restore", buffer_if="never"):
            _restore_under_root(solver, path, out, fleet_plane)
    except Exception:  # noqa: BLE001 — a corrupt plane degrades to cold, never crashes the caller
        log.exception("warm-store restore failed; remaining planes dropped")
        out.reason = "restore error (see logs)"
    return _publish(solver, out.to_dict(), metrics)


def _restore_under_root(solver, path: str, out: _Outcome, fleet_plane=None) -> None:
    payload, reason = read_snapshot(path)
    if payload is None:
        out.drop_all(None, reason or "unreadable")
        return
    ws = incremental.warm_state_for(solver)
    if ws is None:
        out.drop_all(payload, "incremental path disabled")
        return
    same_device = payload.get("device") == str(solver.device)
    snap_scope = tuple(payload.get("tenant", ()) or ())
    enc_heads = _restore_catalogs(solver, payload, same_device, out)

    for sigs, engine_tok, val in payload.get("routes", ()):
        ws.routes.put(tuple(podcache.intern_sig(s) for s in sigs) + (engine_tok,), val)
        out.ok("route")

    if not same_device:
        # device-computed planes from another device are never served
        counts = _plane_counts(payload)
        for plane in _DEVICE_PLANES:
            if plane != "compat":  # counted with their catalog entries
                out.drop(plane, counts[plane])
    else:
        for stored, skel in payload.get("jobs", ()):
            key = _rebind_job_key(stored, enc_heads, snap_scope)
            if key is None:
                out.drop("job")
                continue
            ws.jobs.put(key, skel)
            if fleet_plane is not None:
                fleet_plane.skeleton_put(key[:-1], skel)
            out.ok("job")

        for (engine, cap, srkeys), clusters, applied in payload.get("merges", ()):
            rkeys = [_rebind_rkey(rk, enc_heads, snap_scope) for rk in srkeys]
            rebuilt = []
            for cluster in clusters:
                trail = [_rebind_rkey(rk, enc_heads, snap_scope) for rk in cluster[0]]
                if any(t is None for t in trail):
                    rebuilt = None
                    break
                rebuilt.append((tuple(trail),) + tuple(cluster[1:]))
            if rebuilt is None or any(rk is None for rk in rkeys):
                out.drop("merge")
                continue
            ws.merges.put((engine, cap, tuple(rkeys)), incremental.MergeSkeleton(rebuilt, applied))
            out.ok("merge")

        for strail, emitted in payload.get("emits", ()):
            trail = [_rebind_rkey(rk, enc_heads, snap_scope) for rk in strail]
            if any(t is None for t in trail):
                out.drop("emit")
                continue
            ws.emits.put(tuple(trail), emitted)
            out.ok("emit")

        for stored, row in payload.get("screen_rows", ()):
            rkey = _rebind_rkey(stored, enc_heads, snap_scope)
            if rkey is None:
                out.drop("mergerow")
                continue
            ws.screen_rows.put(rkey, row)
            out.ok("mergerow")

        _restore_lprelax(solver, payload, out)

    cluster = solver.cluster
    live_gen = cluster.generation() if cluster is not None else None
    _restore_seeds(ws, payload.get("seeds") or {}, cluster_witness(solver.kube_client), live_gen, out)

    inter = ws.intersects_cache()
    n_inter = 0
    for key, verdict in payload.get("intersects", ()):
        if key not in inter:
            inter[key] = verdict
            n_inter += 1
    out.ok("intersects", n_inter)

    n_ok, n_drop = deviceplane.import_signatures(payload.get("jitsigs", ()))
    out.ok("jitsig", n_ok)
    out.drop("jitsig", n_drop)
    _restore_compile_cache(payload, out)


def _restore_compile_cache(payload: dict, out: "_Outcome") -> None:
    """Witness the snapshot's library manifest against the live process:
    a library is code this process would load and launch, trustworthy
    only when the torch and CUDA versions and the card's capability it
    was built for equal the live ones, and its source's digest the live
    source's. Any mismatch drops the rows counted (the boot prewarm then
    loads nothing restored, and the first solve loads the libraries
    itself)."""
    stored = payload.get("compilecache") or {}
    rows = list(stored.get("libraries") or ())
    live = backend.compile_cache_fingerprint()
    if (
        stored.get("torch") != live["torch"]
        or stored.get("cuda") != live["cuda"]
        or stored.get("capability") != live["capability"]
    ):
        backend.restore_library_manifest(())
        out.drop("compilecache", len(rows))
        return
    digests, live_digests = stored.get("sources") or {}, live["sources"]
    same = [r for r in rows if isinstance(r, dict) and digests.get(r.get("source")) == live_digests.get(r.get("source"))]
    kept, n_drop = backend.restore_library_manifest(same)
    out.ok("compilecache", len(kept))
    out.drop("compilecache", n_drop + len(rows) - len(same))


def _publish(solver, result: dict, metrics) -> dict:
    _set_last("restore", result)
    solver.last_warmstore_stats = dict(result)
    if metrics is not None:
        for plane, n in result.get("restored", {}).items():
            metrics.warmstore_restored.inc(n, plane=plane)
        for plane, n in result.get("dropped", {}).items():
            metrics.warmstore_dropped.inc(n, plane=plane)
    return result


# -- the fleet's canonical-catalog plane -------------------------------------------


def snapshot_fleet_plane(plane, directory: Optional[str] = None) -> Optional[str]:
    """Snapshot a ``CatalogPlane``'s canonical catalogs (content-addressed
    by fingerprint) → path, or None when persistence is off or failed."""
    directory = directory or WARMSTORE_DIR
    if directory is None:
        return None
    try:
        payload = {"schema": SCHEMA, "contract": CONTRACT, "tenant": (), "fleet_canon": plane.export_canon()}
        return write_snapshot(payload, directory)
    except Exception:  # noqa: BLE001 — persistence never fails the fleet
        log.exception("fleet-plane snapshot failed")
        return None


def restore_fleet_plane(plane, path: str) -> dict:
    """Install a snapshot's canonical catalogs into ``plane``: the
    fingerprints are their own witness, the plane generations are minted
    afresh. → the outcome."""
    payload, reason = read_snapshot(path)
    if payload is None:
        return {"path": path, "restored": {}, "dropped": {"fleetcanon": 1}, "reason": reason}
    n = plane.import_canon(payload.get("fleet_canon", ()))
    return {"path": path, "restored": {"fleetcanon": n}, "dropped": {}}


# -- restart simulation: every in-memory plane dropped as a process exit would --


def simulate_process_death() -> None:
    """Wipe every cross-solve in-memory plane: the catalog cache, every
    WarmState, the LP relaxation memos and backend singletons, and the
    pod intern maps with their counters (a fresh interpreter restarts ids
    at zero), the device plane's signature roster and compile history,
    and the restored library manifest. Callers must also drop pod objects
    carrying ``_karp_memo`` from the old world: a restarted process reads
    its pods afresh. The kernel libraries stay loaded: only a fresh
    process loads them again."""
    from . import backends
    from .solver import _CATALOG_CACHE, _CATALOG_LOCK

    with _CATALOG_LOCK:
        _CATALOG_CACHE.clear()
    incremental.reset()
    podcache.reset_process()
    backends.reset_for_tests()
    deviceplane.reset()
    backend.reset_manifest()
    with _LAST_LOCK:
        _LAST["snapshot"] = None
        _LAST["restore"] = None
