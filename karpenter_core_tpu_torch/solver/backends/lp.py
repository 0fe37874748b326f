"""LP-relaxation pack backend.

Counterpart of ``karpenter_core_tpu/solver/backends/lp.py``. The
pod-signature × instance-type assignment LP, relaxed to continuous
variables — per pack job, with S the job's distinct request rows
(signatures), T its viable types priced by their cheapest admitted
offering (backends.job_prices):

    min  Σ_t price_t · x_t                       x_t  = nodes of type t
    s.t. Σ_s y_st · count_s · req_sr ≤ x_t · alloc_tr   ∀ t, r
         Σ_t y_st = 1                            ∀ s  (y_st = 0 where a
         x, y ≥ 0                                      signature can't fit t)

Solved on the scheduler's device as a projected multiplicative-weights
ascent on the LP dual (``dual_ascent``: the Hopper kernel
``csrc/dual_ascent.cu`` on a CUDA tensor, ``dual_ascent_reference`` on
a CPU tensor): resource shadow prices μ_tr ≥ 0 held to each type's price
budget (μ_t · alloc_t ≤ price_t) by projection, objective Σ_s count_s ·
min_t μ_t · req_s. Every dual-feasible μ certifies a lower bound on the
cost of any integral plan for the job (weak duality); the bound is
re-evaluated on the host in float64 with a 1−1e−9 safety factor, so
float32 device arithmetic can never round it above the true optimum.

The primal decision reuses μ: each signature routes to the type where
its resource bundle is cheapest under the shadow prices, and the
per-type pod sets are packed by the FFD engine restricted to that one
type's capacity row (the repair pass), so every emitted assignment is
feasible by construction. A cost guard prices both candidates (the LP
rounding and the plain FFD pack) with the finalize step's
cheapest-fitting-type model and keeps the strictly cheaper one: the LP
backend never emits a plan that prices above FFD's on the same job,
never strands a pod FFD would have scheduled, and on price-flat
catalogs it gives FFD's plan exactly.

Between the guard and the bound:

- **Primal-dual refinement** (``LP_REFINE_ROUNDS`` rounds):
  after the repair pass, the dual re-ascends warm-started against the
  repaired primal's residuals, re-routes and re-repairs, one batched
  repair pack per round. The bound only tightens (max over rounds); a
  round's candidate replaces the incumbent only on a strict price
  improvement with the same scheduled set.
- **Restricted branch-and-bound** (``LP_BRANCH_K`` wide):
  the k most-fractional signature→type choices each spawn a depth-1
  branch forcing the signature onto its runner-up; the surviving
  branches pack as one batch, and a branch whose dual bound cannot beat
  the incumbent is pruned without packing (counted in
  ``last_branch_table``).
- **Warm-started duals as a cache plane**: converged dual weights ride
  the relax memo's value, and the memo (``lprelax``) is one plane per
  ``torch.device`` shared by every ``LPBackend``: a steady-state solve
  hits it and runs zero ascent iterations. The key is the dual solve's
  whole read-set (request digest, capacity and price tables, iteration
  budget, refine-stage tag), so a hit never changes a plan. The plane
  is per device so a CPU solve cannot stand in for the card's.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import buildlib
from ...tracing import deviceplane
from .. import devicetime, incremental
from ..backend import resolve_device
from . import PackBackend, job_prices

_BIG = np.float32(1e12)  # padded/unavailable-type price: finite, never argmin
# the route's value where a signature fits no type: float32(_BIG * 1e6)
_MASKED = np.float32(_BIG * np.float32(1e6))


# dual-ascent iteration budget, primal-dual refinement rounds and branch
# width — the JAX package's KARPENTER_TPU_LP_ITERS, _LP_REFINE_ROUNDS and
# _LP_BRANCH_K defaults (backends/lp.py)
LP_ITERS = 160
LP_REFINE_ROUNDS = 2
LP_BRANCH_K = 2


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, (n - 1)).bit_length())


DUAL_ASCENT = buildlib.CudaKernel(
    "dual_ascent.cu", "dual_ascent_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 5,
    helpers={"dual_ascent_plan": (ctypes.c_int, [ctypes.c_int64] * 3 + [ctypes.c_void_p])},
    name="lp.dual_ascent",
)
PLAN_FIELDS = ("threads", "owners", "groups", "types", "regs", "global", "bytes")


def dual_ascent_plan(S: int, T: int, R: int, lib=None) -> Optional[Dict[str, int]]:
    """The kernel's layout for (S, T, R): threads of its block, threads of
    a replica of the types, replicas, types a thread, rows in registers,
    work area in device memory, its bytes; None where no layout exists.
    ``lib``: a library exporting ``dual_ascent_plan`` (default: the
    card's build)."""
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    if (lib or DUAL_ASCENT.lib()).dual_ascent_plan(S, T, R, out) != 0:
        return None
    return dict(zip(PLAN_FIELDS, out))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_r a[..., r] · b[..., r] in axis order, each product and sum
    rounded to float32 (the kernel's order: no FMA, no reassociation)."""
    acc = a[..., 0] * b[..., 0]
    for r in range(1, a.shape[-1]):
        acc = acc + a[..., r] * b[..., r]
    return acc


def dual_ascent_reference(
    reqs: torch.Tensor,  # (S, R) f32 signature rows (0 on padding)
    counts: torch.Tensor,  # (S,) f32 pod multiplicities (0 on padding)
    alloc: torch.Tensor,  # (T, R) f32 capacities (0 on padding rows)
    prices: torch.Tensor,  # (T,) f32 finite (_BIG on padding)
    valid: torch.Tensor,  # (T,) bool
    w0: torch.Tensor,  # (T, R) f32 positive starting weights
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dual ascent on the tensors' device:
    the JAX package's ``_dual_ascent_kernel`` step as XLA compiles it
    (util / rowmax(util) folded into demand / (alloc_safe · rowmax), the
    update's multiply-add fused), with every sum taken in axis or
    signature order as the kernel takes it.
    → (w (T, R), t_star (S,) int32, has_fit (S,) bool).

    μ is a per-type weight row scaled onto the price budget (μ_t =
    price_t · w_t / (w_t · alloc_t)), feasible at every step; the weights
    move multiplicatively toward each type's congested resources (routed
    demand per unit capacity)."""
    S, R = reqs.shape
    T = alloc.shape[0]
    dev = reqs.device
    fit = (reqs[:, None, :] <= alloc[None, :, :]).all(dim=-1) & valid[None, :]
    has_fit = fit.any(dim=1)
    alloc_safe = torch.clamp(alloc, min=1.0)
    masked = torch.tensor(float(_MASKED), dtype=torch.float32, device=dev)
    lo = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    weight = (counts * has_fit.to(torch.float32))[:, None] * reqs  # (S, R): count_s · req_s

    def route(w):
        mu = prices[:, None] * w / torch.maximum(_dot(w, alloc), lo)[:, None]
        cost = _dot(reqs[:, None, :], mu[None, :, :])  # (S, T)
        return torch.where(fit, cost, masked).argmin(dim=1)

    w = w0.clone()
    for k in range(iters):
        t_star = route(w)
        demand = torch.zeros((T, R), dtype=torch.float32, device=dev)
        for s in range(S):  # signature order: the kernel's sum order
            demand.index_add_(0, t_star[s : s + 1], weight[s : s + 1])
        peak = torch.maximum((demand / alloc_safe).max(dim=1, keepdim=True).values, tiny)
        norm = demand / (alloc_safe * peak)
        # lr · norm + 1 with one rounding (the fused multiply-add of the
        # reference's compiled step): the product is exact in float64
        w = w * (step_lr(k) * norm.to(torch.float64) + 1.0).to(torch.float32)
    return w, route(w).to(torch.int32), has_fit


def step_lr(k: int) -> float:
    """The ascent's step size at iteration ``k``, 0.5 / sqrt(k + 1), as a
    float32 value: 0.5 times 1 / sqrt(k + 1) rounded once to float32 (the
    kernel's ``step_lr``)."""
    return float(np.float32(0.5) * np.float32(1.0 / math.sqrt(k + 1.0)))


@deviceplane.observe("lp.dual_ascent", static_names=("iters",))
def dual_ascent(
    reqs: torch.Tensor,
    counts: torch.Tensor,
    alloc: torch.Tensor,
    prices: torch.Tensor,
    valid: torch.Tensor,
    w0: torch.Tensor,
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counterpart of ``_dual_ascent_kernel`` (same arguments as
    ``dual_ascent_reference``): one launch of ``csrc/dual_ascent.cu`` on
    CUDA tensors (or a raise), the plain version on CPU tensors."""
    dev = reqs.device
    if dev.type == "cpu":
        return dual_ascent_reference(reqs, counts, alloc, prices, valid, w0, iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S, R = reqs.shape
    T = alloc.shape[0]
    for name, t, dtype, shape in (
        ("reqs", reqs, torch.float32, (S, R)),
        ("counts", counts, torch.float32, (S,)),
        ("alloc", alloc, torch.float32, (T, R)),
        ("prices", prices, torch.float32, (T,)),
        ("valid", valid, torch.bool, (T,)),
        ("w0", w0, torch.float32, (T, R)),
    ):
        buildlib.check_tensor(name, t, dtype, shape, dev)
    w = torch.empty((T, R), dtype=torch.float32, device=dev)
    t_star = torch.empty(S, dtype=torch.int32, device=dev)
    has_fit = torch.empty(S, dtype=torch.uint8, device=dev)
    # no plan (bad arguments): the launch refuses them with a cudaError
    plan = dual_ascent_plan(S, T, R)
    scratch = None
    if plan is not None and plan["global"]:
        scratch = torch.empty(plan["bytes"] // 4 + 1, dtype=torch.float32, device=dev)
    DUAL_ASCENT.launch(
        reqs.data_ptr(), counts.data_ptr(), alloc.data_ptr(), prices.data_ptr(),
        valid.data_ptr(), w0.data_ptr(), S, T, R, int(iters),
        None if scratch is None else scratch.data_ptr(),
        w.data_ptr(), t_star.data_ptr(), has_fit.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, device=dev,
    )
    return w, t_star, has_fit.view(torch.bool)


def _host_bound(
    w: np.ndarray,
    reqs: np.ndarray,
    counts: np.ndarray,
    alloc: np.ndarray,
    prices: np.ndarray,
) -> float:
    """Re-certify the bound from the returned dual weights in float64:
    project μ onto the price budget with a 1−1e−9 margin (so float
    rounding can never push μ infeasible) and evaluate Σ count·ν — a
    valid lower bound for any feasible μ, independent of the device's
    float32 arithmetic."""
    w64 = np.asarray(w, dtype=np.float64)
    denom = np.maximum((w64 * alloc).sum(axis=1, keepdims=True), 1e-300)
    mu = (prices[:, None] * w64 / denom) * (1.0 - 1e-9)
    cost_st = reqs @ mu.T  # (S, T)
    fit = np.all(reqs[:, None, :] <= alloc[None, :, :], axis=-1)
    cost_st = np.where(fit, cost_st, np.inf)
    nu = cost_st.min(axis=1, initial=np.inf)
    nu = np.where(np.isfinite(nu), nu, 0.0)
    return float((nu * counts).sum())


def _dual_prices(w: np.ndarray, alloc: np.ndarray, prices: np.ndarray) -> np.ndarray:
    """The float64 μ table (T, R) behind ``_host_bound``'s projection —
    the branch stage prices signatures with exactly the certified dual."""
    w64 = np.asarray(w, dtype=np.float64)
    denom = np.maximum((w64 * alloc).sum(axis=1, keepdims=True), 1e-300)
    return (np.asarray(prices, dtype=np.float64)[:, None] * w64 / denom) * (1.0 - 1e-9)


def relax(
    reqs: np.ndarray,  # (S, R) signature rows
    counts: np.ndarray,  # (S,) pod multiplicities
    alloc: np.ndarray,  # (T, R) capacities
    prices: np.ndarray,  # (T,) finite prices (mask infeasible types to _BIG)
    iters: int,
    w0: Optional[np.ndarray] = None,  # (T, R) warm-start weights
    device=None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """One padded relaxation solve on ``device`` (None: the card) →
    (t_star (S,), has_fit (S,), bound, w (T, R) converged dual weights).
    ``bound`` is a certified lower bound ($/hr) on any integral plan that
    serves these pods from these types at these prices; ``w`` seeds warm
    re-ascents. ``timings``: a dict that gets the call's split in ms
    (pad, upload, kernel, download, host_bound), the device synchronised
    between the parts, which only a measurement asks for."""
    dev = resolve_device(device)
    clock = _Split(dev, timings)
    S, R = reqs.shape
    T = alloc.shape[0]
    S_pad, T_pad = _pow2(S), _pow2(T)
    reqs_p = np.zeros((S_pad, R), dtype=np.float32)
    reqs_p[:S] = reqs
    counts_p = np.zeros(S_pad, dtype=np.float32)
    counts_p[:S] = counts
    alloc_p = np.zeros((T_pad, R), dtype=np.float32)
    alloc_p[:T] = alloc
    prices_p = np.full(T_pad, _BIG, dtype=np.float32)
    prices_p[:T] = np.minimum(prices, _BIG)
    valid_p = np.zeros(T_pad, dtype=bool)
    valid_p[:T] = np.asarray(prices) < _BIG
    # scale-invariant cold start: w0 = 1/alloc makes every resource axis
    # contribute equally to the price budget (μ0_r = price/(R·alloc_r)),
    # so convergence does not depend on quantization scale. Warm starts
    # override the real rows only; padding rows stay neutral.
    w0_p = 1.0 / np.maximum(alloc_p, 1.0).astype(np.float32)
    if w0 is not None:
        w0_p[:T] = np.maximum(np.asarray(w0, dtype=np.float32), 1e-12)
    clock.lap("pad")
    deviceplane.record_footprint(deviceplane.nbytes_of(reqs_p, counts_p, alloc_p, prices_p, valid_p, w0_p))
    with devicetime.track(phase="lp"):
        devicetime.transfer("h2d", reqs_p, counts_p, alloc_p, prices_p, valid_p, w0_p, phase="lp")
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        inputs = (t(reqs_p), t(counts_p), t(alloc_p), t(prices_p), t(valid_p), t(w0_p))
        clock.lap("upload")
        w, t_star, has_fit = dual_ascent(*inputs, int(iters))
        clock.lap("kernel")
        # analysis: allow-host-sync(the one sync of the relax call: rounding reads host arrays)
        w, t_star, has_fit = w.cpu().numpy(), t_star.cpu().numpy()[:S], has_fit.cpu().numpy()[:S]
    devicetime.transfer("d2h", w, t_star, has_fit, phase="lp")
    clock.lap("download")
    real = valid_p[:T]
    bound = _host_bound(
        w[:T][real].astype(np.float64),
        reqs_p[:S].astype(np.float64),
        counts_p[:S].astype(np.float64),
        alloc_p[:T][real].astype(np.float64),
        prices_p[:T][real].astype(np.float64),
    )
    clock.lap("host_bound")
    return t_star, has_fit, bound, w[:T]


class _Split:
    """``relax``'s parts timed into ``out`` (ms), the device synchronised
    at each lap; nothing at all when ``out`` is None."""

    def __init__(self, device, out: Optional[Dict[str, float]]) -> None:
        self.device, self.out = device, out
        self.t = time.perf_counter() if out is not None else 0.0

    def lap(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            # analysis: allow-host-sync(a timed split waits for the card by design; off unless asked)
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = (now - self.t) * 1000.0
        self.t = now


def dual_bound(
    reqs: np.ndarray, alloc: np.ndarray, prices: np.ndarray, iters: int = 256, device=None
) -> float:
    """Standalone relaxation lower bound over raw per-pod request rows
    (deduped to signatures internally) — what plancost uses to report
    the optimality gap for any backend's emitted plan."""
    if reqs.shape[0] == 0 or alloc.shape[0] == 0:
        return 0.0
    finite = np.isfinite(np.asarray(prices, dtype=np.float64))
    if not finite.any():
        return 0.0
    uniq, inv = np.unique(np.asarray(reqs), axis=0, return_inverse=True)
    counts = np.bincount(inv.ravel(), minlength=len(uniq)).astype(np.float64)
    _, _, bound, _ = relax(
        uniq.astype(np.float64),
        counts,
        np.asarray(alloc, dtype=np.float64)[finite],
        np.asarray(prices, dtype=np.float64)[finite],
        iters,
        device=device,
    )
    return bound


def _candidate_cost(
    reqs: np.ndarray,
    node_ids: np.ndarray,
    node_count: int,
    alloc: np.ndarray,
    prices: np.ndarray,
) -> float:
    """Price a candidate partition exactly as the finalize step will:
    per node, the cheapest viable type that holds its load."""
    from ..pack import assign_cheapest_types, node_usage_from_assignment

    if node_count == 0:
        return 0.0
    usage = node_usage_from_assignment(reqs, np.asarray(node_ids), int(node_count))
    chosen = assign_cheapest_types(usage, alloc, prices)
    if np.any(chosen < 0):
        return float("inf")
    return float(prices[chosen].sum())


def _candidate_headroom(
    reqs: np.ndarray,
    node_ids: np.ndarray,
    node_count: int,
    alloc: np.ndarray,
    prices: np.ndarray,
) -> float:
    """Mean free capacity fraction across a candidate's opened nodes —
    the consolidation-headroom term of the Pareto tie-break (plancost
    ``cost_weights``): when two partitions price identically, the one
    leaving more slack consolidates cheaper later."""
    from ..pack import assign_cheapest_types, node_usage_from_assignment

    if node_count == 0:
        return 0.0
    usage = node_usage_from_assignment(reqs, np.asarray(node_ids), int(node_count))
    chosen = assign_cheapest_types(usage, alloc, prices)
    if np.any(chosen < 0):
        return 0.0
    cap = np.maximum(alloc[chosen].astype(np.float64), 1.0)
    frac = 1.0 - usage.astype(np.float64) / cap
    return float(np.clip(frac, 0.0, 1.0).mean())


# the shared relax memos (the warm-dual planes): one LRU per torch.device,
# adopted by every LPBackend — the lp singleton, AutoBackend's inner lane
# and test-local constructions alike — so a warm hit is a hit whichever
# facade packed the job, and a CPU solve never fills the card's plane
_RELAX_PLANES: Dict[str, incremental.LRU] = {}


def relax_plane(device) -> incremental.LRU:
    """The ``lprelax`` memo of ``device`` (made on first use)."""
    key = str(resolve_device(device))
    plane = _RELAX_PLANES.get(key)
    if plane is None:
        plane = _RELAX_PLANES.setdefault(key, incremental.LRU("lprelax"))
    return plane


def export_relax_plane(device=None) -> List[tuple]:
    """(key, value) rows of ``device``'s warm-dual plane, oldest first.
    Keys are pure content — reqs digest, capacity bytes, price-table
    bytes, iteration budget, refine-stage tag — and values numpy/float
    tuples: nothing process-private."""
    plane = _RELAX_PLANES.get(str(resolve_device(device)))
    return [] if plane is None else plane.items()


def reset_for_tests() -> None:
    _RELAX_PLANES.clear()


class LPBackend(PackBackend):
    """The LP-relaxation backend behind the ``lp`` switch value."""

    name = "lp"

    def __init__(self) -> None:
        super().__init__()
        self.last_stats: dict = {}
        # per-job guard outcome of the last pack_jobs call (True where
        # the LP partition won): the solver marks those jobs' merge
        # records cost-guarded
        self.last_job_flags: List[bool] = []
        #: per-round refinement trajectory of the last pack_jobs call:
        #: [{round, bound, cost, improved, ms}] summed over the call's
        #: routed jobs — bound is monotone nondecreasing, cost monotone
        #: nonincreasing by construction
        self.last_refine_trajectory: List[dict] = []
        #: branch table of the last pack_jobs call: one row per
        #: considered branch {job, sig, count, from_t, to_t, bound,
        #: cost, outcome(pruned|explored|won)}
        self.last_branch_table: List[dict] = []
        #: dual-ascent iterations actually executed by the last
        #: pack_jobs call (0 when every relaxation hit the memo)
        self.last_ascent_iters: int = 0

    @property
    def iterations(self) -> int:
        """Dual-ascent iteration budget (a component of every relax memo
        key AND of the job token — a budget change is a different
        computation)."""
        return LP_ITERS

    @property
    def refine_rounds(self) -> int:
        """Primal-dual refinement rounds after the repair pass (0 ⇒ a
        single relax and repair)."""
        return LP_REFINE_ROUNDS

    @property
    def branch_k(self) -> int:
        """Branch width: the k most-fractional signature→type choices
        branched per job (0 disables branching)."""
        return LP_BRANCH_K

    @property
    def refine_iters(self) -> int:
        """Re-ascent budget per refinement round: warm-started ascents
        converge from a near-optimal w, so a quarter budget suffices."""
        return max(8, self.iterations // 4)

    def job_token(self, device=None) -> tuple:
        # every knob that can change this backend's partition for fixed
        # job inputs — including the Pareto weights, whose tie-break
        # participates in the guard (two weight settings must never
        # alias one skeleton stream)
        from .. import plancost

        return (
            "lp",
            int(self.iterations),
            int(self.refine_rounds),
            int(self.branch_k),
            plancost.weights_token(),
        )

    # -- relaxation memo (cross-tick, content-addressed) ----------------

    def _relax_job(
        self,
        reqs: np.ndarray,
        alloc: np.ndarray,
        prices: np.ndarray,
        iters: int,
        stats=None,
        stage: tuple = (),
        w0: Optional[np.ndarray] = None,
        device=None,
    ) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
        """Signature-level relaxation through ``device``'s ``lprelax`` memo.
        The key witnesses the dual solve's full read-set: the job's
        sorted request matrix (digest), the viable capacity table, the
        price-table fingerprint, the iteration budget, and — for
        refinement re-ascents — the stage tag carrying the warm-start
        weight digest (w0 is itself a deterministic function of keyed
        inputs, but the digest keeps the witness explicit)."""
        key = (
            incremental.job_digest(reqs),
            alloc.tobytes(),
            prices.tobytes(),
            int(iters),
        ) + tuple(stage)
        plane = relax_plane(device)
        hit = plane.get(key, stats)
        if hit is not None:
            return hit
        uniq, inv = np.unique(reqs, axis=0, return_inverse=True)
        counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        t_star_u, has_fit_u, bound, w = relax(
            uniq.astype(np.float64),
            counts,
            alloc.astype(np.float64),
            prices.astype(np.float64),
            iters,
            w0=w0,
            device=device,
        )
        self.last_ascent_iters += int(iters)
        value = (t_star_u[inv], has_fit_u[inv], bound, w)
        # analysis: allow-cache-key(reqs) — reqs rides the key as its job_digest (the read-set rule cannot see through the digest helper)
        plane.put(key, value, stats)
        return value

    # -- pack ------------------------------------------------------------

    def _repair_groups(self, ji: int, jobs, metas, t_star, has_fit):
        """Per-type repair pack jobs for one routing: [(t, pos)], [job]."""
        reqs, _frontier, mpn = jobs[ji]
        alloc = metas[ji]["alloc"]
        groups, rjobs = [], []
        for t in np.unique(t_star[has_fit]):
            pos = np.flatnonzero(has_fit & (t_star == t))
            groups.append((int(t), pos))
            rjobs.append((reqs[pos], alloc[int(t)][None, :].astype(np.int32), mpn))
        return groups, rjobs

    @staticmethod
    def _assemble(n_pods: int, parts: List[tuple]) -> Tuple[np.ndarray, int]:
        """Stitch per-type repair results into one job-wide partition;
        type-ordinal order keeps node numbering deterministic."""
        node_ids = np.full(n_pods, -1, dtype=np.int32)
        offset = 0
        for t, pos, ids, count in sorted(parts, key=lambda e: e[0]):
            assigned = ids >= 0
            node_ids[pos[assigned]] = ids[assigned] + offset
            offset += count
        return node_ids, offset

    def pack_jobs(
        self, jobs: List[tuple], metas: List[dict], device=None, stats=None, mesh=None
    ) -> List[Tuple[np.ndarray, int]]:
        from .. import plancost
        from ..pack import batch_pack

        n = len(jobs)
        refine_rounds = self.refine_rounds
        branch_k = self.branch_k
        st = {
            "jobs": n,
            "lp_won": 0,
            "ffd_kept": 0,
            "ffd_kept_cold": 0,
            "ffd_kept_refined": 0,
            "lp_bound_sum": 0.0,
            "lp_saved_per_hr": 0.0,
            "refine_rounds": 0,
            "refine_accepted": 0,
            "branches_considered": 0,
            "branches_pruned": 0,
            "branches_explored": 0,
            "branches_won": 0,
            "ascent_iters": 0,
        }
        flags = [False] * n
        self.last_refine_trajectory = []
        self.last_branch_table = []
        self.last_ascent_iters = 0
        if not n:
            self.last_stats = st
            self.last_job_flags = flags
            return []
        # the FFD candidate for every job in one batched dispatch — the
        # cost guard needs it anyway, and it is the fallback partition
        ffd_packed = batch_pack(jobs, device=device, mesh=mesh)
        t0 = time.perf_counter()
        routes: List[Optional[dict]] = []
        for job, meta in zip(jobs, metas):
            reqs = job[0]
            if reqs.shape[1] != meta["alloc"].shape[1]:
                # stateful job (appended host-port feature columns):
                # the assignment LP prices the resource axes only —
                # keep FFD's partition, whose pack enforces the port
                # columns
                routes.append(None)
                continue
            prices = np.asarray(job_prices(meta), dtype=np.float64)
            finite = np.isfinite(prices)
            if not finite.any() or reqs.shape[0] == 0:
                routes.append(None)
                continue
            mpn = int(job[2])
            r_alloc = metas_alloc = meta["alloc"]
            r_reqs = reqs
            if mpn < 2**31 - 1:
                # job-level pod cap → one synthetic capacity column
                r_alloc = np.concatenate(
                    [metas_alloc, np.full((metas_alloc.shape[0], 1), mpn, metas_alloc.dtype)],
                    axis=1,
                )
                r_reqs = np.concatenate(
                    [reqs, np.ones((reqs.shape[0], 1), reqs.dtype)], axis=1
                )
            safe_prices = np.where(finite, prices, float(_BIG))
            t_star, has_fit, bound, w = self._relax_job(
                r_reqs, r_alloc, safe_prices, self.iterations, stats, device=device
            )
            routes.append(dict(
                t_star=t_star, has_fit=has_fit, prices=prices, bound=bound,
                w=w, r_reqs=r_reqs, r_alloc=r_alloc, safe_prices=safe_prices,
            ))
        # round 0: repair the routed primal per (job, type) group
        repair_meta: List[tuple] = []  # (job index, type ordinal, positions)
        repair_jobs: List[tuple] = []
        for ji, route in enumerate(routes):
            if route is None:
                continue
            groups, rjobs = self._repair_groups(
                ji, jobs, metas, route["t_star"], route["has_fit"]
            )
            for (t, pos), rj in zip(groups, rjobs):
                repair_meta.append((ji, t, pos))
                repair_jobs.append(rj)
        repaired = batch_pack(repair_jobs, device=device, mesh=mesh) if repair_jobs else []
        lp_parts: List[list] = [[] for _ in range(n)]
        for (ji, t, pos), (ids, count) in zip(repair_meta, repaired):
            lp_parts[ji].append((t, pos, np.asarray(ids), int(count)))

        # price round 0: per job, the LP candidate vs the FFD fallback.
        # A candidate is admissible only when it schedules exactly FFD's
        # pod set (never strands a pod FFD would have scheduled); the
        # incumbent below is what refinement/branching must strictly beat
        ffd_cost: List[float] = [0.0] * n
        best: List[Optional[dict]] = [None] * n
        for ji in range(n):
            if routes[ji] is None:
                continue
            reqs = jobs[ji][0]
            alloc = metas[ji]["alloc"]
            prices = routes[ji]["prices"]
            ffd_ids = np.asarray(ffd_packed[ji][0])
            ffd_cost[ji] = _candidate_cost(
                reqs, ffd_ids, int(ffd_packed[ji][1]), alloc, prices
            )
            node_ids, count = self._assemble(reqs.shape[0], lp_parts[ji])
            cost = _candidate_cost(reqs, node_ids, count, alloc, prices)
            if np.isfinite(cost) and bool(np.array_equal(node_ids < 0, ffd_ids < 0)):
                best[ji] = {"node_ids": node_ids, "count": count, "cost": cost}
            routes[ji]["parts"] = lp_parts[ji]

        def _incumbent_cost(ji: int) -> float:
            lp_c = best[ji]["cost"] if best[ji] is not None else float("inf")
            return min(lp_c, ffd_cost[ji])

        def _traj_row(rnd: int, improved: int, t_start: float) -> dict:
            routed = [ji for ji in range(n) if routes[ji] is not None]
            return {
                "round": rnd,
                "bound": round(sum(routes[ji]["bound"] for ji in routed), 6),
                "cost": round(sum(_incumbent_cost(ji) for ji in routed), 6),
                "improved": improved,
                "ms": round((time.perf_counter() - t_start) * 1000.0, 3),
            }

        self.last_refine_trajectory.append(_traj_row(0, 0, t0))

        # primal-dual refinement: re-ascend warm-started against the
        # repaired primal's residuals, re-route, re-repair — one batched
        # repair dispatch per round; the bound only tightens (max), the
        # incumbent only improves (strict), so iterating is always safe
        for r in range(1, refine_rounds + 1):
            tr0 = time.perf_counter()
            round_meta: List[tuple] = []
            round_jobs: List[tuple] = []
            for ji, route in enumerate(routes):
                if route is None:
                    continue
                r_reqs, r_alloc = route["r_reqs"], route["r_alloc"]
                t_star, has_fit = route["t_star"], route["has_fit"]
                T = r_alloc.shape[0]
                opened = np.zeros(T, dtype=np.float64)
                for t, _pos, _ids, count in route["parts"]:
                    opened[t] = count
                demand = np.zeros(r_alloc.shape, dtype=np.float64)
                for t in np.unique(t_star[has_fit]):
                    demand[int(t)] = r_reqs[has_fit & (t_star == t)].sum(axis=0)
                # residual pressure of the REPAIRED primal: routed
                # demand per unit of the capacity repair actually
                # opened — types whose integral rounding overshot get
                # their shadow prices pushed up, re-routing the next
                # descent away from them
                util = demand / (
                    np.maximum(opened, 1.0)[:, None]
                    * np.maximum(r_alloc.astype(np.float64), 1.0)
                )
                peak = float(util.max())
                w0 = np.asarray(route["w"], dtype=np.float64) * (
                    1.0 + util / max(peak, 1e-12)
                )
                t_star2, has_fit2, bnd, w2 = self._relax_job(
                    r_reqs,
                    r_alloc,
                    route["safe_prices"],
                    self.refine_iters,
                    stats,
                    stage=("refine", r, incremental.job_digest(w0)),
                    w0=w0,
                    device=device,
                )
                route.update(t_star=t_star2, has_fit=has_fit2, w=w2)
                # dual-feasible every iterate ⇒ every round certifies;
                # keep the tightest
                route["bound"] = max(route["bound"], bnd)
                groups, rjobs = self._repair_groups(ji, jobs, metas, t_star2, has_fit2)
                for (t, pos), rj in zip(groups, rjobs):
                    round_meta.append((ji, t, pos))
                    round_jobs.append(rj)
            round_repaired = batch_pack(round_jobs, device=device, mesh=mesh) if round_jobs else []
            st["refine_rounds"] = r
            parts_r: List[list] = [[] for _ in range(n)]
            for (ji, t, pos), (ids, count) in zip(round_meta, round_repaired):
                parts_r[ji].append((t, pos, np.asarray(ids), int(count)))
            improved = 0
            for ji in range(n):
                if routes[ji] is None or not parts_r[ji]:
                    continue
                reqs = jobs[ji][0]
                routes[ji]["parts"] = parts_r[ji]
                node_ids, count = self._assemble(reqs.shape[0], parts_r[ji])
                cost = _candidate_cost(
                    reqs, node_ids, count, metas[ji]["alloc"], routes[ji]["prices"]
                )
                ffd_ids = np.asarray(ffd_packed[ji][0])
                admissible = np.isfinite(cost) and bool(
                    np.array_equal(node_ids < 0, ffd_ids < 0)
                )
                lp_c = best[ji]["cost"] if best[ji] is not None else float("inf")
                if admissible and cost < lp_c - 1e-9:
                    best[ji] = {"node_ids": node_ids, "count": count, "cost": cost}
                    improved += 1
            st["refine_accepted"] += improved
            self.last_refine_trajectory.append(_traj_row(r, improved, tr0))

        # restricted branch-and-bound over the top-k most-fractional
        # signature→type choices: each branch forces one signature onto
        # its runner-up type and re-repairs; the surviving frontier packs
        # as ONE batched dispatch, pruned branches never pack at all
        if branch_k > 0:
            frontier_meta: List[tuple] = []  # (branch row index, t, pos)
            frontier_jobs: List[tuple] = []
            branch_rows: List[dict] = []
            branch_state: List[tuple] = []  # (ji,) aligned with branch_rows
            for ji, route in enumerate(routes):
                if route is None:
                    continue
                r_reqs, r_alloc = route["r_reqs"], route["r_alloc"]
                safe_prices = route["safe_prices"]
                if r_alloc.shape[0] < 2:
                    continue
                mu = _dual_prices(route["w"], r_alloc, safe_prices)
                uniq, inv = np.unique(r_reqs, axis=0, return_inverse=True)
                counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
                cost_su = uniq @ mu.T
                fit = np.all(
                    uniq[:, None, :] <= r_alloc[None, :, :].astype(np.float64),
                    axis=-1,
                ) & (np.asarray(safe_prices) < float(_BIG))[None, :]
                cost_su = np.where(fit, cost_su, np.inf)
                order = np.argsort(cost_su, axis=1, kind="stable")
                rows_idx = np.arange(len(uniq))
                t1, t2 = order[:, 0], order[:, 1]
                c1, c2 = cost_su[rows_idx, t1], cost_su[rows_idx, t2]
                eligible = np.isfinite(c1) & np.isfinite(c2) & (counts > 0)
                if not eligible.any():
                    continue
                # fractionality score: the relative margin between
                # best and runner-up μ-cost — a near-tie is exactly
                # where continuous routing mass splits and integral
                # rounding can pick the wrong side
                margin = np.where(
                    eligible, (c2 - c1) / np.maximum(c1, 1e-12), np.inf
                )
                picks = np.argsort(margin, kind="stable")[:branch_k]
                # the branch bound's parent is the ν-objective of the
                # SAME μ the branch reprices with (weak duality for
                # the restricted LP: forcing s→t2 replaces ν_s=c1
                # with μ_t2·req_s=c2, every other term unchanged)
                nu = np.where(np.isfinite(c1), c1, 0.0)
                base = float((nu * counts).sum())
                for s in picks:
                    s = int(s)
                    if not eligible[s]:
                        continue
                    st["branches_considered"] += 1
                    bbound = float(base + counts[s] * (float(c2[s]) - float(c1[s])))
                    row = {
                        "job": ji,
                        "sig": s,
                        "count": int(counts[s]),
                        "from_t": int(t1[s]),
                        "to_t": int(t2[s]),
                        "bound": round(bbound, 6),
                        "cost": None,
                        "outcome": "pruned",
                    }
                    if bbound >= _incumbent_cost(ji) - 1e-9:
                        st["branches_pruned"] += 1
                        branch_rows.append(row)
                        continue
                    t_star_b = route["t_star"].copy()
                    t_star_b[inv == s] = np.int32(t2[s])
                    bi = len(branch_rows)
                    branch_rows.append(row)
                    branch_state.append(ji)
                    groups, rjobs = self._repair_groups(
                        ji, jobs, metas, t_star_b, route["has_fit"]
                    )
                    for (t, pos), rj in zip(groups, rjobs):
                        frontier_meta.append((bi, t, pos))
                        frontier_jobs.append(rj)
            frontier_packed = batch_pack(frontier_jobs, device=device, mesh=mesh) if frontier_jobs else []
            branch_parts: dict = {}
            for (bi, t, pos), (ids, count) in zip(frontier_meta, frontier_packed):
                branch_parts.setdefault(bi, []).append(
                    (t, pos, np.asarray(ids), int(count))
                )
            for bi, parts in sorted(branch_parts.items()):
                row = branch_rows[bi]
                ji = row["job"]
                reqs = jobs[ji][0]
                node_ids, count = self._assemble(reqs.shape[0], parts)
                cost = _candidate_cost(
                    reqs, node_ids, count, metas[ji]["alloc"], routes[ji]["prices"]
                )
                row["cost"] = round(cost, 6) if np.isfinite(cost) else None
                ffd_ids = np.asarray(ffd_packed[ji][0])
                admissible = np.isfinite(cost) and bool(
                    np.array_equal(node_ids < 0, ffd_ids < 0)
                )
                lp_c = best[ji]["cost"] if best[ji] is not None else float("inf")
                if admissible and cost < lp_c - 1e-9:
                    best[ji] = {"node_ids": node_ids, "count": count, "cost": cost}
                    row["outcome"] = "won"
                    st["branches_won"] += 1
                else:
                    row["outcome"] = "explored"
                    st["branches_explored"] += 1
            self.last_branch_table = branch_rows

        # Pareto tie-break (plancost cost_weights): price stays the
        # dominant objective — the guard below is unchanged when the
        # non-price weights are 0 — but when consolidation headroom is
        # weighted and the candidates price IDENTICALLY, prefer the
        # partition with more slack (weights ride job_token, so two
        # settings can never alias one skeleton stream)
        headroom_weight = plancost.cost_weights()["headroom"]

        results: List[Tuple[np.ndarray, int]] = []
        refined_tier = refine_rounds > 0 or branch_k > 0
        for ji in range(n):
            ffd_ids, ffd_count = ffd_packed[ji]
            ffd_ids = np.asarray(ffd_ids)
            if routes[ji] is None:
                st["ffd_kept"] += 1
                st["ffd_kept_cold"] += 1
                results.append((ffd_ids, int(ffd_count)))
                continue
            st["lp_bound_sum"] += routes[ji]["bound"]
            reqs = jobs[ji][0]
            alloc = metas[ji]["alloc"]
            prices = routes[ji]["prices"]
            cand = best[ji]
            # strict improvement only, and never at the price of a
            # stranded pod (admissibility above): on price-flat
            # catalogs the LP partition ties and FFD's (parity-
            # gated) plan stands
            win = cand is not None and cand["cost"] < ffd_cost[ji] - 1e-9
            if (
                not win
                and cand is not None
                and headroom_weight > 0.0
                and abs(cand["cost"] - ffd_cost[ji]) <= 1e-9
            ):
                lp_head = _candidate_headroom(
                    reqs, cand["node_ids"], cand["count"], alloc, prices
                )
                ffd_head = _candidate_headroom(
                    reqs, ffd_ids, int(ffd_count), alloc, prices
                )
                win = lp_head > ffd_head + 1e-12
            if win:
                st["lp_won"] += 1
                st["lp_saved_per_hr"] += max(0.0, ffd_cost[ji] - cand["cost"])
                flags[ji] = True
                results.append((cand["node_ids"], cand["count"]))
            else:
                st["ffd_kept"] += 1
                # the satellite split: a cold rejection (no
                # refinement ran) is a different signal from a plan
                # FFD still beat AFTER refinement + branching spent
                # their budgets
                st["ffd_kept_refined" if refined_tier else "ffd_kept_cold"] += 1
                results.append((ffd_ids, int(ffd_count)))
        st["ascent_iters"] = int(self.last_ascent_iters)
        st["lp_bound_sum"] = round(st["lp_bound_sum"], 6)
        st["lp_saved_per_hr"] = round(st["lp_saved_per_hr"], 6)
        self.last_stats = st
        self.last_job_flags = flags
        return results
