"""Consolidated per-solve stats: one stable schema over the solver's
stat blobs — ``last_timings``, ``last_merge_stats``,
``last_cache_stats``, ``last_pack_stats`` — plus the disruption
engine's ``last_decision_stats`` when a controller is wired in.

Consumers:

- ``/debug/solve/stats`` (operator/server.py) serves exactly this dict;
- ``bench.py _split`` derives its per-config columns from it (the
  emitted BENCH keys are unchanged, so round-over-round trajectories
  stay comparable — see ``bench_fields``);
- the flight recorder (tracing/flightrec.py) embeds it per decision.

Schema discipline: every top-level key below is always present (empty
dict / None when the layer didn't run), and additions bump ``SCHEMA``.

The port's copy of ``karpenter_core_tpu/solver/stats.py``, at the same
schema. The port keeps its solve's trace id as ``last_trace_id`` (its
``last_timings`` stays numeric); the ``shard`` block is None (no
sharded path); the ``device`` block is the device plane's
(``solver.last_device_stats``, tracing/deviceplane.py), with the kernel
libraries' status (``backend.compile_cache_status()``) and the boot
prewarm's outcome (``prewarm.last_result()``) beside it, as the
reference carries its compile cache's.
"""

from __future__ import annotations

from typing import Optional

SCHEMA = 7  # 7: "pareto" block (plancost.pareto_report: price,
# disruption cost, spread slack, consolidation headroom, active weights;
# None when no plans were emitted); 6: device block carries the boot
# prewarm outcome; 5: "device" block; 4: "warmstore" block (snapshot/
# restore outcome, per-plane restored/dropped counts); 3: "route" block
# (tensor/parked/oracle pod split per solve + oracle share); 2: "shard"
# block (mesh padding)


def _round3(v) -> float:
    try:
        return round(float(v), 3)
    except (TypeError, ValueError):
        return 0.0


def solve_stats(solver, disruption=None) -> dict:
    """The stable consolidated view of ``solver``'s most recent solve.
    ``disruption`` (optional DisruptionController or anything exposing
    ``last_decision_stats``) contributes the last disruption decision."""
    t = getattr(solver, "last_timings", None) or {}
    cs = getattr(solver, "last_cache_stats", None) or {}
    ms = getattr(solver, "last_merge_stats", None) or {}
    ps = getattr(solver, "last_pack_stats", None) or {}
    dstats = getattr(disruption, "last_decision_stats", None) if disruption is not None else None
    return {
        "schema": SCHEMA,
        "trace_id": getattr(solver, "last_trace_id", None) or t.get("trace_id"),
        "timings": {
            "total_ms": _round3(t.get("total_ms", 0.0)),
            "device_ms": _round3(t.get("device_ms", 0.0)),
            "host_ms": _round3(t.get("host_ms", 0.0)),
        },
        "cache": {
            "hits": dict(cs.get("hits", {})),
            "misses": dict(cs.get("misses", {})),
            "evictions": dict(cs.get("evictions", {})),
            "hit_rate": cs.get("hit_rate"),
        },
        "merge": {
            "ms": _round3(ms.get("merge_ms", 0.0)),
            "engine": ms.get("merge_engine"),
            "records": int(ms.get("merge_records", 0) or 0),
            "candidates_screened": int(ms.get("merge_candidates_screened", 0) or 0),
            "pairs_applied": int(ms.get("merge_pairs_applied", 0) or 0),
        },
        "pack_backend": dict(ps),
        "pareto": dict(pp) if (pp := getattr(solver, "last_pareto", None)) else None,
        "shard": dict(ss) if (ss := getattr(solver, "last_shard_stats", None)) else None,
        "route": dict(rs) if (rs := getattr(solver, "last_route_stats", None)) else None,
        "disruption": dict(dstats) if dstats else None,
        "warmstore": _warmstore_block(solver),
        "device": _device_block(solver),
    }


def _device_block(solver) -> Optional[dict]:
    """The per-solve device block, the kernel libraries' status and the
    boot prewarm's outcome: None while the solver records no device
    stats (the plane off)."""
    ds = getattr(solver, "last_device_stats", None)
    if not ds:
        return None
    from . import backend, prewarm

    out = dict(ds)
    out["compile_cache"] = backend.compile_cache_status()
    out["prewarm"] = prewarm.last_result()
    return out


def _warmstore_block(solver) -> Optional[dict]:
    """The most recent snapshot/restore outcome. The solver's own stamp
    wins; the process-level fallback covers the restore-before-first-
    tick path, where the restore ran through a throwaway solver before
    the provisioner built its live one (the planes are shared module
    state either way — only the outcome record rides an instance)."""
    wss = getattr(solver, "last_warmstore_stats", None)
    if wss:
        return dict(wss)
    from . import warmstore

    return warmstore.last_outcomes().get("restore")


def bench_fields(stats: dict) -> dict:
    """Project the consolidated schema onto the flat per-config BENCH
    columns (``device_ms``/``host_ms``/``cache_*``/``merge_*``/
    ``pack_backend``) the round artifacts have carried —
    the bench readers consume the stable schema, the emitted artifact
    keys stay byte-compatible with prior rounds."""
    out: dict = {}
    t = stats.get("timings", {})
    out["device_ms"] = round(t.get("device_ms", 0.0), 2)
    out["host_ms"] = round(t.get("host_ms", 0.0), 2)
    cache = stats.get("cache", {})
    if cache.get("hits") or cache.get("misses"):
        out["cache_hits"] = dict(cache.get("hits", {}))
        out["cache_misses"] = dict(cache.get("misses", {}))
        if cache.get("hit_rate") is not None:
            out["cache_hit_rate"] = cache["hit_rate"]
    ps = stats.get("pack_backend", {})
    if ps and ps.get("backend") not in (None, "ffd"):
        out["pack_backend"] = dict(ps)
    pp = stats.get("pareto")
    if pp:
        out["pareto"] = dict(pp)
    sh = stats.get("shard")
    if sh:
        out["shard"] = dict(sh)
    rt = stats.get("route")
    if rt:
        out["route"] = dict(rt)
    wss = stats.get("warmstore")
    if wss:
        out["warmstore"] = dict(wss)
    dev = stats.get("device")
    if dev:
        # compact projection: the event list stays on the debug route
        cc = dev.get("compile_cache") or {}
        out["device"] = {
            "compiles": dev.get("compiles", 0),
            "transfer_bytes": dict(dev.get("transfer_bytes", {})),
            "footprint_bytes": dev.get("footprint_bytes", 0),
            "tile_headroom_frac": dev.get("tile_headroom_frac"),
            "compile_cache_status": cc.get("status"),
            "compile_cache_entries": cc.get("entries"),
        }
    merge = stats.get("merge", {})
    out["merge_ms"] = round(merge.get("ms", 0.0), 2)
    out["merge_candidates_screened"] = merge.get("candidates_screened", 0)
    out["merge_pairs_applied"] = merge.get("pairs_applied", 0)
    if merge.get("engine"):
        out["merge_engine"] = merge["engine"]
    return out


def route_payload(solver_ref, disruption_ref=None) -> Optional[dict]:
    """The /debug/solve/stats payload builder: ``solver_ref`` /
    ``disruption_ref`` are zero-arg callables resolving the CURRENT
    solver / disruption controller (the operator swaps solvers when the
    nodepool set changes, so the route must re-resolve per request).
    Returns None when no solver has solved yet (route answers 404)."""
    solver = solver_ref() if callable(solver_ref) else solver_ref
    if solver is None or not getattr(solver, "last_timings", None):
        return None
    disruption = disruption_ref() if callable(disruption_ref) else disruption_ref
    return solve_stats(solver, disruption)
