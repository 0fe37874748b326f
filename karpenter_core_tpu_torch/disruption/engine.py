"""Batched disruption engine: the multi/single-node consolidation
decision as a device-scale subset search.

Counterpart of ``karpenter_core_tpu/disruption/engine.py``. The reference
binary-searches ONE sort order (disruption cost) with a full scheduling
simulation per probe, capped at 100 candidates
(multinodeconsolidation.go:58-137). This engine scores candidate node
**subsets** — every prefix of several sort orders (cost, price saved,
pod count, emptiness), per-pool and per-zone prefixes, plus the
cross-pool merge of per-pool winners — in one launch of the subset
screen (``tpu_repack.screen_subsets``, the hand-written Hopper kernel
``csrc/disrupt_screen.cu``), brackets the canonical order with the true
batched repack lower bound (``repack_feasible``), and verifies only
frontier subsets with simulations that run warm through the solver's
incremental memos (route / compat rows / job / merge / seed —
``helpers.simulate_scheduling`` reuses a long-lived simulation
scheduler and passes the drained provider-id tuple as
``TorchScheduler.solve(sim_drained=...)``, the seed-key delta).

**Decision contract (the plan-identity gate).** The engine's *chosen
command* follows the sequential oracle's contract exactly: the
canonical (disruption-cost) order's screen/repack bounds produce the
same bounded verification sequence as
``MultiNodeConsolidation.first_n_consolidation``, verification runs the
same ``method._attempt`` / ``method.compute_consolidation`` code, and
the binary-search fallback is literally the sequential method's.
Batched-engine commands are therefore plan-identical to the sequential
path by construction (``KARPENTER_TORCH_DISRUPT_ENGINE=sequential``
retains it as the oracle). The wider subset family contributes pruning
(screen feasibility is downward-closed: an infeasible subset proves
every superset infeasible) and observability (``last_engine_stats``
reports when the family contains a larger feasible subset than the
canonical prefix — the cross-pool winner the sequential order cannot
see), never a divergent command.

**Delta-keyed simulation memos.** Two cross-tick caches (LRU-capped at
``incremental._CAPS["disruptbounds"]`` and ``["disruptverify"]``) make
the steady state cheap, under the incremental invariant (reuse is
memoization, never approximation):

- **bounds** — the family's screen/repack bounds, keyed by the ordered
  candidate provider-id tuple + ``Cluster.generation()`` (witnesses
  every informer-fed input: candidate pods, node availability, the
  surviving fleet) + the pool/catalog world key. Any cluster or catalog
  event invalidates.
- **verdicts** — *negative only*: a subset whose drain simulation
  failed (or single-candidate consolidation no-op'd), keyed by the
  **drained-node subset** (sorted provider ids) + generation + world
  key. Successful commands are never cached — they execute and change
  the world. The drained-subset component is what keeps a drained-node
  probe from ever aliasing the undrained solve.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tracing import tracer
from ..solver import incremental
from ..utils import pod as podutils
from .types import ACTION_NOOP, Candidate, Command

# subset-family size bound (the JAX package's KARPENTER_TPU_DISRUPT_FAMILY_MAX
# default): beyond it, prefix sizes are subsampled per order
# (geometrically toward the full prefix) — never silently: the dropped
# count rides in last_engine_stats["family_capped"]
FAMILY_MAX = 8192
# alternate-order batched repacks per decision (KARPENTER_TPU_DISRUPT_ALT_REPACKS;
# each is one pack; the canonical order's repack always runs — it is
# the decision bound). Extra orders refine the family's lower bounds only.
ALT_REPACKS = 2


def engine_mode() -> str:
    """batched (default) | sequential, from KARPENTER_TORCH_DISRUPT_ENGINE
    (the JAX package's KARPENTER_TPU_DISRUPT_ENGINE), read per decision;
    the sequential path is the retained plan-identity oracle."""
    v = os.environ.get("KARPENTER_TORCH_DISRUPT_ENGINE", "batched").strip().lower()
    return v if v in ("batched", "sequential") else "batched"


def _family_max() -> int:
    return max(16, int(FAMILY_MAX))


def _alt_repacks() -> int:
    return max(0, int(ALT_REPACKS))


@dataclass
class FamilyBounds:
    """One decision's batched bounds: the canonical-order sandwich that
    drives the command, plus the whole family's screen verdicts."""

    k_hi: int  # canonical screen upper bound (screen_prefixes)
    k_lo: int  # canonical repack lower bound (repack_prefixes)
    # per order label: {"screen_k": largest screen-feasible prefix,
    # "repack_k": largest repack-feasible prefix (alt orders only when
    # budgeted), "size": candidates in the order}
    orders: Dict[str, dict] = field(default_factory=dict)
    subsets_screened: int = 0
    screen_feasible: int = 0
    family_capped: int = 0  # subsets dropped by the family-size bound
    # the family's best screen-feasible subset when it beats the
    # canonical prefix (observability only — the decision contract pins
    # the command to the oracle order)
    best_family: Optional[dict] = None


class BatchedDisruptionEngine:
    """Shared by the multi- and single-node consolidation methods; one
    instance per DisruptionController (wired through ctx.engine)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.bounds = incremental.LRU("disruptbounds")
        self.verdicts = incremental.LRU("disruptverify")
        self.cstats = incremental.CacheStats()
        self.last_engine_stats: Optional[dict] = None

    # -- invalidation witnesses -----------------------------------------

    def _generation(self) -> Optional[int]:
        gen = getattr(self.ctx.cluster, "generation", None)
        return gen() if callable(gen) else None

    def _world_key(self) -> Optional[tuple]:
        """Pool + catalog content witness for the memo keys: every
        nodepool's replay fingerprint and catalog generation/fingerprint
        (solver/incremental.py). None (→ no memoization) when any pool
        or catalog cannot be fingerprinted."""
        try:
            pools = [
                np_
                for np_ in self.ctx.kube_client.list("NodePool")
                if np_.metadata.deletion_timestamp is None
            ]
        except Exception:  # noqa: BLE001 — unprobeable world: skip memoization
            return None
        keys = []
        for np_ in sorted(pools, key=lambda p: p.name):
            try:
                its = self.ctx.cloud_provider.get_instance_types(np_) or []
            except Exception:  # noqa: BLE001 — unprobeable catalog: skip memoization
                return None
            keys.append(
                (
                    incremental.pool_replay_fingerprint(np_),
                    incremental.catalog_key(self.ctx.cloud_provider, np_, its),
                )
            )
        return tuple(keys)

    # -- subset family ---------------------------------------------------

    def _orders(self, candidates: List[Candidate]) -> List[Tuple[str, tuple]]:
        """The structured sort-order family over the (already
        cost-sorted) candidate list: index tuples whose prefixes are the
        engine's subsets. Deduplicated — a single-pool cluster's pool
        order IS the cost order."""
        n = len(candidates)
        idx = list(range(n))

        def resched(c: Candidate) -> int:
            return sum(1 for p in (c.pods or []) if podutils.is_reschedulable(p))

        def used_fraction(c: Candidate) -> float:
            try:
                alloc = c.instance_type.allocatable()
                avail = c.state_node.available()
            except Exception:  # noqa: BLE001 — unpriceable node sorts last
                return 1.0
            fracs = []
            for k, cap in alloc.items():
                cap_f = float(cap)
                if cap_f > 0:
                    fracs.append(1.0 - float(avail.get(k, 0)) / cap_f)
            return max(fracs) if fracs else 1.0

        ordered: List[Tuple[str, tuple]] = [("cost", tuple(idx))]
        ordered.append(
            (
                "price",
                tuple(sorted(idx, key=lambda i: (-(candidates[i].price() or 0.0), i))),
            )
        )
        ordered.append(
            ("pods", tuple(sorted(idx, key=lambda i: (resched(candidates[i]), i))))
        )
        ordered.append(
            (
                "emptiness",
                tuple(sorted(idx, key=lambda i: (used_fraction(candidates[i]), i))),
            )
        )
        pools = sorted({c.nodepool.name for c in candidates})
        if len(pools) > 1:
            for pool in pools:
                sub = tuple(i for i in idx if candidates[i].nodepool.name == pool)
                if len(sub) >= 2:
                    ordered.append((f"pool:{pool}", sub))
        zones = sorted({c.zone for c in candidates})
        if len(zones) > 1:
            for zone in zones:
                sub = tuple(i for i in idx if candidates[i].zone == zone)
                if len(sub) >= 2:
                    ordered.append((f"zone:{zone}", sub))
        out: List[Tuple[str, tuple]] = []
        seen: Dict[tuple, str] = {}
        for label, order in ordered:
            if order in seen:
                continue
            seen[order] = label
            out.append((label, order))
        return out

    @staticmethod
    def _prefix_sizes(order_len: int, budget: int) -> List[int]:
        """Prefix sizes (≥2) to screen for one order under a per-order
        subset budget: all of them when they fit, else a geometric
        subsample that always keeps 2 and the full prefix."""
        full = list(range(2, order_len + 1))
        if len(full) <= budget:
            return full
        picks = np.unique(
            np.geomspace(2, order_len, num=max(2, budget)).round().astype(int)
        )
        return [int(k) for k in picks if 2 <= k <= order_len]

    def _family_masks(
        self, n: int, orders: List[Tuple[str, tuple]]
    ) -> Tuple[np.ndarray, List[Tuple[str, int]], int]:
        """(S, N) membership masks for every family subset plus a
        (order label, prefix size) descriptor per row; the third return
        is the number of subsets dropped by the family-size cap."""
        cap = _family_max()
        total = sum(max(0, len(o) - 1) for _, o in orders)
        per_order = max(4, cap // max(1, len(orders))) if total > cap else n
        rows: List[np.ndarray] = []
        descr: List[Tuple[str, int]] = []
        dropped = 0
        for label, order in orders:
            sizes = self._prefix_sizes(len(order), per_order)
            dropped += max(0, len(order) - 1 - len(sizes))
            mask = np.zeros(n, dtype=bool)
            prev = 0
            for k in sizes:
                mask[list(order[prev:k])] = True
                prev = k
                rows.append(mask.copy())
                descr.append((label, k))
        if not rows:
            return np.zeros((0, n), dtype=bool), [], dropped
        return np.stack(rows), descr, dropped

    # -- batched bounds (cross-tick memoized) ----------------------------

    def _bounds(self, cands: List[Candidate]) -> FamilyBounds:
        gen = self._generation()
        world = self._world_key()
        key = None
        if gen is not None and world is not None:
            # the ordered provider-id tuple is the candidate-set delta;
            # generation witnesses every informer-fed input the bounds
            # read (candidate pods, node availability, fleet free
            # space), the world key witnesses pools + catalogs
            key = (gen, world, tuple(c.provider_id() for c in cands))
            hit = self.bounds.get(key, self.cstats)
            if hit is not None:
                return hit
        fb = self._compute_bounds(cands)
        if key is not None:
            self.bounds.put(key, fb, self.cstats)  # analysis: allow-cache-key(self.ctx)
            # — self.ctx reads are witnessed by (generation, world key):
            # every cluster mutation bumps generation (state/cluster.py),
            # every pool/catalog mutation moves the world key
        return fb

    def _compute_bounds(self, cands: List[Candidate]) -> FamilyBounds:
        from . import tpu_repack

        n = len(cands)
        with tracer.span("disrupt.screen", candidates=n):
            k_hi = tpu_repack.screen_prefixes(self.ctx, cands)
            orders = self._orders(cands)
            masks, descr, dropped = self._family_masks(n, orders)
            feas = (
                tpu_repack.screen_subsets(self.ctx, cands, masks)
                if len(masks)
                else np.zeros(0, dtype=bool)
            )
        fb = FamilyBounds(k_hi=k_hi, k_lo=0)
        fb.subsets_screened = int(len(masks))
        fb.screen_feasible = int(np.count_nonzero(feas))
        fb.family_capped = dropped
        order_screen: Dict[str, int] = {}
        for (label, k), ok in zip(descr, feas):
            if ok:
                order_screen[label] = max(order_screen.get(label, 0), k)
        for label, order in orders:
            fb.orders[label] = {
                "size": len(order),
                "screen_k": order_screen.get(label, 0),
            }
        with tracer.span("disrupt.repack", candidates=n):
            k_lo_vec = tpu_repack.repack_feasible(self.ctx, cands)
            fb.k_lo = (
                int(np.max(np.flatnonzero(k_lo_vec))) + 1 if k_lo_vec.any() else 0
            )
            fb.orders["cost"]["repack_k"] = fb.k_lo
            # refine the most promising non-canonical orders with the
            # true batched repack (bounded: each is one pack dispatch)
            alts = [
                (label, order)
                for label, order in orders
                if label != "cost" and order_screen.get(label, 0) > fb.k_hi
            ]
            alts.sort(key=lambda lo: -order_screen.get(lo[0], 0))
            for label, order in alts[: _alt_repacks()]:
                vec = tpu_repack.repack_feasible(
                    self.ctx, [cands[i] for i in order]
                )
                fb.orders[label]["repack_k"] = (
                    int(np.max(np.flatnonzero(vec))) + 1 if vec.any() else 0
                )
        # cross-pool merge of per-pool winners: union of each pool's
        # largest screen-feasible prefix, screened as one extra subset
        pool_orders = {
            label: order for label, order in orders if label.startswith("pool:")
        }
        if len(pool_orders) > 1:
            union: List[int] = []
            for label, order in pool_orders.items():
                k = order_screen.get(label, 0)
                union.extend(order[:k])
            if len(union) >= 2:
                mask = np.zeros((1, n), dtype=bool)
                mask[0, sorted(set(union))] = True
                with tracer.span("disrupt.screen", candidates=n, crosspool=True):
                    ok = tpu_repack.screen_subsets(self.ctx, cands, mask)
                fb.subsets_screened += 1
                if len(ok) and ok[0]:
                    fb.screen_feasible += 1
                    fb.orders["crosspool"] = {
                        "size": int(mask.sum()),
                        "screen_k": int(mask.sum()),
                    }
        # the family's best feasible subset, for the observability story
        # ("the engine saw a bigger consolidation than the oracle order
        # permits") — never the command source
        best_label, best_k = None, 0
        for label, o in fb.orders.items():
            if o.get("screen_k", 0) > best_k:
                best_label, best_k = label, o["screen_k"]
        if best_label is not None and best_k > fb.k_hi:
            fb.best_family = {"order": best_label, "size": best_k}
        return fb

    # -- delta-keyed verification (negative-verdict memo) ----------------

    def _attempt_multi(
        self, method, cands: List[Candidate], k: int
    ) -> Optional[Command]:
        """One prefix verification through the drained-subset verdict
        memo: a generation-guarded negative verdict skips the
        simulation; anything else runs the sequential method's own
        ``_attempt`` (same spot/price/type guards — identity by shared
        code). Only failures are memoized: successful commands execute
        and change the world."""
        subset = cands[:k]
        gen = self._generation()
        world = self._world_key()
        vkey = None
        if gen is not None and world is not None:
            vkey = (
                "multi",
                gen,
                world,
                tuple(sorted(c.provider_id() for c in subset)),
            )
            known = self.verdicts.get(vkey, self.cstats)
            if known is not None:
                return None  # memoized: this drain set cannot consolidate
        with tracer.span("disrupt.verify", subset=k):
            cmd = method._attempt(subset)
        failed = cmd is None
        if failed and vkey is not None:
            # method carries no decision state beyond ctx (ctx-derived
            # reads are witnessed by generation + world key); k only
            # selects the drained subset, which the sorted provider-id
            # tuple in the key witnesses exactly
            self.verdicts.put(vkey, failed, self.cstats)  # analysis: allow-cache-key(method,k)
        return cmd

    # -- the multi-node decision ----------------------------------------

    def multi_command(self, method, candidates: List[Candidate], max_n: int) -> Command:
        """Batched replacement for ``first_n_consolidation``: same
        decision contract (canonical bounds → descending bounded
        verification → shared binary-search fallback), with the family
        screened in one launch and probes running warm."""
        from . import methods as methods_mod

        t0 = time.perf_counter()
        stats: dict = {"engine": "batched", "candidates": len(candidates)}
        self.last_engine_stats = stats
        if len(candidates) < 2:
            return Command()
        max_n = min(max_n, len(candidates))
        cands = candidates[:max_n]
        deadline = self.ctx.clock() + methods_mod.MULTI_NODE_CONSOLIDATION_TIMEOUT
        fb = self._bounds(cands)
        stats.update(
            screen_upper_k=fb.k_hi,
            repack_lower_k=fb.k_lo,
            subsets_screened=fb.subsets_screened,
            screen_feasible_subsets=fb.screen_feasible,
            family_capped=fb.family_capped,
            orders=fb.orders,
        )
        if fb.best_family is not None:
            stats["best_family"] = fb.best_family
        verified = [0]
        try:
            # screen infeasibility at k=2 proves every prefix infeasible
            # (capacity is necessary, infeasibility upward-closed): the
            # no-op is decided with ZERO simulations — the steady-state
            # fast path (first_n_consolidation short-circuits identically)
            if fb.k_hi == 0 and fb.k_lo < 2:
                return Command()
            tries = sorted(
                {k for k in (fb.k_hi, fb.k_hi - 1, fb.k_hi - 2, fb.k_lo) if k >= 2},
                reverse=True,
            )
            if not tries:
                # no usable bounds: the sequential fallback at the
                # reference-sized cap (probes are full simulations,
                # memoized like every other probe)
                return self._binary_search_memo(
                    method, cands, min(max_n, methods_mod.max_parallel()), deadline,
                    verified,
                )
            attempted_min = tries[0]
            for k in tries[:4]:  # bounded verification attempts
                if self.ctx.clock() > deadline:
                    break
                verified[0] += 1
                cmd = self._attempt_multi(method, cands, k)
                if cmd is not None:
                    return cmd
                attempted_min = min(attempted_min, k)
            return self._binary_search_memo(
                method,
                cands,
                min(max_n, attempted_min - 1, methods_mod.max_parallel()),
                deadline,
                verified,
            )
        finally:
            stats["subsets_verified"] = verified[0]
            stats["decision_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
            stats["cache"] = self.cstats.to_dict()

    def _binary_search_memo(
        self, method, candidates: List[Candidate], max_n: int, deadline: float,
        verified: list,
    ) -> Command:
        """``MultiNodeConsolidation._binary_search`` probe-for-probe —
        same ranges, same outcomes — with each probe routed through the
        drained-subset verdict memo (a memoized failure IS the
        simulation's failure at this generation, so skipping the solve
        changes nothing but time)."""
        lo_, hi = 1, max_n - 1
        last = Command()
        while lo_ <= hi:
            if self.ctx.clock() > deadline:
                return last
            mid = (lo_ + hi) // 2
            verified[0] += 1
            cmd = self._attempt_multi(method, candidates, mid + 1)
            if cmd is not None:
                last = cmd
                lo_ = mid + 1
            else:
                hi = mid - 1
        return last

    # -- the condition cohorts (expiration / drift) -----------------------

    def condition_command(self, method, candidates: List[Candidate]) -> Command:
        """Batched dispatch for the condition cohorts: the sequential
        ``ConditionMethod._simulate_in_order`` loop — same order, same
        success criterion, same one-winner contract — with (a) the whole
        cohort screened in one single-screen launch (in-place
        feasibility is observability: a screen-feasible candidate's
        pods fit surviving capacity, so its drain needs no replacement),
        and (b) known-blocked drains memoized negatively, so a cohort
        that failed to simulate at this generation re-decides without
        re-simulating on the next pass. Blocked candidates re-announce
        via the recorder only on the pass that actually simulates —
        events are telemetry, not plan state, so plan identity to the
        sequential oracle holds probe-for-probe."""
        from . import tpu_repack
        from .helpers import CandidateDeletingError, _blocked, simulate_scheduling

        t0 = time.perf_counter()
        stats: dict = {
            "engine": "batched",
            "cohort": method.type_name,
            "candidates": len(candidates),
        }
        self.last_engine_stats = stats
        screened = inplace = 0
        if len(candidates) > 1:
            with tracer.span(
                "disrupt.screen", candidates=len(candidates), cohort=method.type_name
            ):
                feasible = tpu_repack.screen_singles(self.ctx, candidates)
            screened = len(candidates)
            inplace = int(np.count_nonzero(np.asarray(feasible, dtype=bool)))
        stats["subsets_screened"] = screened
        stats["screen_feasible_subsets"] = inplace
        verified = 0
        gen = self._generation()
        world = self._world_key()
        try:
            for candidate in candidates:
                vkey = None
                if gen is not None and world is not None:
                    # the drain simulation reads only the drained node +
                    # the informer/catalog world — NOT the condition that
                    # nominated it — so a blocked verdict is shared
                    # across the expiration/drift cohorts
                    vkey = ("cond", gen, world, (candidate.provider_id(),))
                    known = self.verdicts.get(vkey, self.cstats)
                    if known is not None:
                        continue  # memoized: this drain cannot schedule its pods
                verified += 1
                with tracer.span("disrupt.verify", subset=1, cohort=method.type_name):
                    try:
                        results = simulate_scheduling(
                            self.ctx.kube_client,
                            self.ctx.cluster,
                            self.ctx.provisioner,
                            [candidate],
                        )
                    except CandidateDeletingError:
                        # transient (mid-deletion) — not memoized: the
                        # sequential loop re-probes it next pass too
                        continue
                if not results.all_non_pending_pods_scheduled():
                    _blocked(
                        self.ctx.recorder,
                        candidate,
                        "Scheduling simulation failed to schedule all pods",
                    )
                    if vkey is not None:
                        # see _attempt_multi: ctx reads are witnessed by
                        # (generation, world key), the drained node by
                        # its provider id
                        self.verdicts.put(vkey, True, self.cstats)  # analysis: allow-cache-key(method)
                    continue
                return Command(
                    candidates=[candidate], replacements=results.new_node_claims
                )
            return Command()
        finally:
            stats["subsets_verified"] = verified
            stats["decision_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
            stats["cache"] = self.cstats.to_dict()

    # -- the single-node decision ----------------------------------------

    def single_command(self, method, candidates: List[Candidate]) -> Command:
        """Batched replacement for the single-node scan: one-launch
        feasibility screen (the singleton rows of the subset family),
        then the sequential verify loop with the drained-candidate
        noop memo pruning known-futile simulations."""
        from . import methods as methods_mod
        from . import tpu_repack

        t0 = time.perf_counter()
        stats: dict = {"engine": "batched", "candidates": len(candidates)}
        self.last_engine_stats = stats
        screened = 0
        if len(candidates) > 1:
            with tracer.span("disrupt.screen", candidates=len(candidates)):
                feasible = tpu_repack.screen_singles(self.ctx, candidates)
            screened = len(candidates)
            candidates = [c for c, ok in zip(candidates, feasible) if ok]
        stats["subsets_screened"] = screened
        stats["screen_feasible_subsets"] = len(candidates)
        verified = 0
        deadline = self.ctx.clock() + methods_mod.SINGLE_NODE_CONSOLIDATION_TIMEOUT
        try:
            gen = self._generation()
            world = self._world_key()
            for c in candidates:
                if self.ctx.clock() > deadline:
                    return Command()
                vkey = None
                if gen is not None and world is not None:
                    vkey = ("single", gen, world, (c.provider_id(),))
                    known = self.verdicts.get(vkey, self.cstats)
                    if known is not None:
                        continue  # memoized noop for this drained node
                verified += 1
                with tracer.span("disrupt.verify", subset=1):
                    cmd = method.compute_consolidation([c])
                noop = cmd.action() == ACTION_NOOP
                if noop:
                    if vkey is not None:
                        # see _attempt_multi: ctx reads are witnessed by
                        # (generation, world key), the drained node by
                        # its provider id
                        self.verdicts.put(vkey, noop, self.cstats)  # analysis: allow-cache-key(method)
                    continue
                if not method.validate(cmd):
                    return Command()
                return cmd
            method.mark_consolidated()
            return Command()
        finally:
            stats["subsets_verified"] = verified
            stats["decision_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
            stats["cache"] = self.cstats.to_dict()
