"""The sharded solve: D shards of one card.

Counterpart of ``karpenter_core_tpu/solver/sharding.py``. The reference
shards three axes over a ``jax.sharding.Mesh`` under ``shard_map``:

- **groups**: pack jobs split over the devices, a ``psum`` of the node
  counts (``sharded_batch_pack``);
- **types**: the compat product's type axis, padded to the mesh and
  all-gathered (``sharded_compat``, ``prepare_sharded_catalog`` and
  ``allowed_sharded``);
- **pods**: one giant job's sorted pods cut into D contiguous chunks,
  each FFD-packed on its own, node ids renumbered by an exclusive cumsum
  of the chunk counts (``sharded_pod_pack``), which is what takes one
  solve to 500,000–1,000,000 pods × 10,000 types (bench config 12,
  ``sharded_mega_solve``).

Here a mesh (``Mesh``) is **D shards that all live on one card**: each
shard's work is one job, or one row block, of a single launch of the
kernel the reference runs per device (B5's ``csrc/ffd_pack.cu`` for the
packs, B1's ``csrc/compat_allowed.cu`` for the catalog, B8's
``csrc/disrupt_screen.cu`` for the prefix screen), and each collective
is a sum over the shard axis on the card. That is the computation the
reference runs on its forced host devices, so the ``sharded`` and
``unsharded`` engines are plan-identical by construction, as there: on
one card they are one launch, and the engine is the label the stats and
the job-memo keys carry. A mesh spread over more than one card raises
``NotImplementedError``.

The reference's knobs ``KARPENTER_TPU_SHARD_ENGINE``,
``KARPENTER_TPU_SHARD_MIN_PODS`` and ``KARPENTER_TPU_SHARDED`` are the
module constants ``SHARD_ENGINE``, ``SHARD_MIN_PODS`` and ``SHARDED``,
with the same defaults (tests monkeypatch them). The solve path never
shards unless a mesh is installed (``install_mesh``: the seam tests use
where the reference's tests set ``KARPENTER_TPU_SHARDED=on`` over eight
host devices): one card is the reference's one device, and a host with
more cards runs the one-card path under ``auto``, as it did before this
module, while ``on`` there asks for a mesh across cards and raises.

Padding is never silent: the type-axis padding of the catalog and the
pod-axis padding of the chunks go into per-solve, per-thread shard
stats (``TorchScheduler.last_shard_stats``) and the
``shard_padding_waste`` gauge.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tracing import deviceplane, tracer
from . import devicetime, pack
from .backend import resolve_device

# the reference's KARPENTER_TPU_SHARD_ENGINE, _SHARD_MIN_PODS and
# _SHARDED defaults
SHARD_ENGINE = "sharded"
SHARD_MIN_PODS = 65536
SHARDED = "auto"


@dataclass(frozen=True)
class Mesh:
    """D shards on one card. ``size`` is the reference's
    ``mesh.devices.size``, ``axis_names`` its axis names."""

    size: int
    axis: str
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "groups", device=None, devices: Optional[Sequence] = None
) -> Mesh:
    """A mesh of ``n_devices`` shards (default 1) on ``device`` (None:
    the card). ``devices`` names the cards the mesh spans; more than one
    distinct card raises ``NotImplementedError``."""
    if devices is not None:
        cards = {str(torch.device(d)) for d in devices}
        if len(cards) > 1:
            raise NotImplementedError(
                f"sharding: a mesh over more than one card ({sorted(cards)}) is not ported; "
                "a mesh is D shards of one card"
            )
        if cards:
            device = next(iter(cards))
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(n, axis, resolve_device(device))


def shard_map_available() -> bool:
    """The reference asks whether its jax has ``shard_map``; the port's
    shard map is one launch over the shards, always there."""
    return True


# ---------------------------------------------------------------------------
# pod-axis mega-shard configuration


def shard_engine() -> str:
    """``sharded`` or ``unsharded``: the reference's ``shard_map`` and
    its ``vmap`` parity oracle, one launch on one card (the label the
    stats and the job-memo keys carry). Unknown values degrade to
    ``sharded``."""
    eng = str(SHARD_ENGINE).strip().lower()
    return eng if eng in ("sharded", "unsharded") else "sharded"


def shard_min_pods() -> int:
    """Pod count at which one pack job chunks across the mesh. Chunking
    changes the pod → node partition, so it is job-memo key material
    (``incremental.pack_engine_token``)."""
    try:
        return max(1, int(SHARD_MIN_PODS))
    except (TypeError, ValueError):
        return 65536


def pod_shard_token(mesh: Optional[Mesh]) -> tuple:
    """The chunk configuration a pack result depends on, for job-memo
    keys: (engine, threshold, shards) under a mesh, () without one, so
    meshless keys stay as they are."""
    if mesh is None:
        return ()
    return (shard_engine(), shard_min_pods(), int(mesh.size))


# ---------------------------------------------------------------------------
# per-solve shard padding stats, per thread: concurrent solvers (fleet
# lanes, serving threads, disruption simulations) each keep their own

_PAD_TLS = threading.local()


def _shard_acc() -> dict:
    acc = getattr(_PAD_TLS, "acc", None)
    if acc is None:
        acc = _PAD_TLS.acc = {}
    return acc


def reset_shard_stats() -> None:
    """A fresh accumulator for this thread (solve entry)."""
    _PAD_TLS.acc = {}


def record_shard_padding(axis: str, used: int, padded: int, accumulate: bool = True, **extra) -> None:
    """Record ``used`` real slots inside ``padded`` slots along ``axis``
    (``pods`` | ``types``). ``accumulate`` sums across events; False
    replaces (the type axis is the active catalog's, re-observed each
    solve). ``extra`` merges scalar context (engine, n_devices)."""
    acc = _shard_acc()
    a = acc.get(axis)
    if a is None or not accumulate:
        acc[axis] = {"used": int(used), "padded": int(padded)}
    else:
        a["used"] += int(used)
        a["padded"] += int(padded)
    for k, v in extra.items():
        acc[k] = v


def consume_shard_stats() -> dict:
    """Drain this thread's accumulator: ``{axis}_used``, ``_padded`` and
    ``_waste`` (the wasted-slot fraction, 4 places) per recorded axis,
    then the scalar context."""
    acc = _shard_acc()
    _PAD_TLS.acc = {}
    out: dict = {}
    for axis in ("pods", "types"):
        a = acc.pop(axis, None)
        if a is None:
            continue
        used, padded = a["used"], a["padded"]
        out[f"{axis}_used"] = used
        out[f"{axis}_padded"] = padded
        out[f"{axis}_waste"] = round(1.0 - used / padded, 4) if padded else 0.0
    out.update(acc)
    return out


# ---------------------------------------------------------------------------
# the mesh a solve shards over

_INSTALLED: Optional[Mesh] = None


def install_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Install (None: remove) the mesh ``active_mesh`` gives every solve
    → the mesh it replaces. The seam for tests and ``chip_smoke.py``."""
    global _INSTALLED
    prev, _INSTALLED = _INSTALLED, mesh
    return prev


def active_mesh(backend: str) -> Optional[Mesh]:
    """The mesh the solve shards over, or None for the one-device path.
    ``SHARDED``: ``off`` never shards; an installed mesh is used
    otherwise. Without one, ``auto`` is the one-device path on any host
    (the reference shards only a multi-chip TPU, and a mesh across cards
    is not ported); ``on`` counts the cards as the reference counts its
    devices: fewer than two is the one-device path, more ask for a mesh
    across cards, which raises."""
    mode = SHARDED
    if mode == "off":
        return None
    if _INSTALLED is not None:
        return _INSTALLED
    if mode != "on" or backend != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return make_mesh(n, devices=[f"cuda:{i}" for i in range(n)])


def _on(mesh: Mesh, a) -> torch.Tensor:
    """``a`` (a tensor or an array) on the mesh's card."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(mesh.device)


def _divides(mesh: Mesh, n: int, what: str) -> None:
    if n % mesh.size:
        raise ValueError(f"{what} ({n}) must divide over the mesh's {mesh.size} shards")


# ---------------------------------------------------------------------------
# groups: the batched pack over the shards


@lru_cache(maxsize=16)
def _sharded_pack_fn(mesh: Mesh):
    """The group pack over ``mesh``'s shards, cached per mesh as the
    reference caches its jitted ``shard_map``: each shard's groups are
    jobs of one B5 launch, and the fleet total is the sum of the counts
    on the card (the reference's ``psum``)."""

    def per_mesh(reqs, fronts, caps, n_pods=None):
        _divides(mesh, reqs.shape[0], "the group count")
        node_ids, counts = pack.ffd_pack_batched(reqs, fronts, caps, pack.K_OPEN, n_pods)
        return node_ids, counts, counts.sum()

    return deviceplane.wrap("sharding.sharded_batch_pack", per_mesh)


def sharded_batch_pack(
    mesh: Mesh,
    requests: torch.Tensor,  # (G, Pmax, R) int32, padded groups
    frontiers: torch.Tensor,  # (G, F, R) int32
    max_per_node: torch.Tensor,  # (G,) int32
    n_pods: Optional[torch.Tensor] = None,  # (G,) int32 real pods per group
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack G groups over the mesh's shards → (node_ids (G, Pmax),
    node_counts (G,), fleet_total ()), on the mesh's card. G divides
    over the shards, as ``shard_map`` requires."""
    return _sharded_pack_fn(mesh)(
        _on(mesh, requests), _on(mesh, frontiers), _on(mesh, max_per_node),
        None if n_pods is None else _on(mesh, n_pods),
    )


# ---------------------------------------------------------------------------
# pods: one mega job chunked over the shards


def sharded_pod_pack(
    mesh: Optional[Mesh],
    requests: np.ndarray,  # (P, R) int32, sorted descending by primary
    frontier: np.ndarray,  # (F, R) int32
    max_per_node,
    engine: Optional[str] = None,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Pod-axis chunked FFD pack of ONE mega job.

    The sorted pods cut into D contiguous chunks of Pc = ⌈P/D⌉ (each
    sorted, so each chunk's scan is a well-formed FFD); all D chunks go
    through one B5 launch at K = ``pack.K_OPEN`` as D jobs, and the
    chunks' node ids renumber into one id space by the exclusive cumsum
    of the chunk counts. The padding pods take ``fmax + 1``: they emit
    -1 without touching a scan, and the launch skips them (each chunk's
    real pod count rides ``n_pods``). ``engine`` (default
    ``shard_engine()``) is a label: on one card the reference's
    ``shard_map`` over the shards and its one-device ``vmap`` twin are
    the same launch, so both engines run it, and the engine reaches the
    stats (no mesh degrades ``sharded`` to ``unsharded`` there, as in
    the reference) and the job-memo keys (``pod_shard_token``). Runs on
    the mesh's card, or on ``device`` (None: the card) without a mesh.

    → (node_ids (P,) int32 global ids, -1 ⇒ unschedulable; node count).
    """
    if engine is None:
        engine = shard_engine()
    D = int(mesh.size) if mesh is not None else 1
    if engine == "sharded" and mesh is None:
        engine = "unsharded"  # explicit degrade, recorded in the stats
    dev = mesh.device if mesh is not None else resolve_device(device)
    P, R = requests.shape
    Pc = -(-P // D)
    fmax = frontier.max(axis=0)
    padded = np.empty((D * Pc, R), dtype=np.int32)
    padded[:P] = requests
    padded[P:] = fmax + 1  # sentinel: padding packs nowhere
    reqs = padded.reshape(D, Pc, R)
    fronts = np.repeat(np.asarray(frontier, dtype=np.int32)[None], D, axis=0)
    caps = np.full(D, min(int(max_per_node), int(pack.INT_INF)), dtype=np.int32)
    n_pods = np.clip(P - np.arange(D, dtype=np.int64) * Pc, 0, Pc).astype(np.int32)
    with tracer.span("pack.shard.dispatch", pods=P, chunks=D, chunk_len=Pc, engine=engine):
        deviceplane.record_footprint(deviceplane.nbytes_of(reqs, fronts, caps, n_pods))
        with devicetime.track(phase="shard"):
            devicetime.transfer("h2d", reqs, fronts, caps, n_pods, phase="shard")
            args = [torch.from_numpy(a).to(dev) for a in (reqs, fronts, caps, n_pods)]
            ids, counts = pack.ffd_pack_batched(args[0], args[1], args[2], pack.K_OPEN, args[3])
            # the one sync of the mega dispatch, after all chunks
            ids = ids.cpu().numpy()  # analysis: allow-host-sync(the chunks renumber on the host)
            counts = counts.cpu().numpy().astype(np.int64)  # analysis: allow-host-sync(same download)
        devicetime.transfer("d2h", ids, counts, phase="shard")
    offsets = np.zeros(D, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    gids = np.where(ids >= 0, ids + offsets[:, None].astype(np.int32), -1)
    record_shard_padding("pods", P, D * Pc, engine=engine, n_devices=D, chunks=D)
    return gids.reshape(-1)[:P].astype(np.int32), int(counts.sum())


def sharded_mega_solve(
    mesh: Optional[Mesh],
    requests: np.ndarray,  # (P, R) int32 pod requests, any order
    alloc: np.ndarray,  # (T, R) int32 allocatable per type
    prices: np.ndarray,  # (T,) f64
    sig_masks: Optional[np.ndarray] = None,  # (S, W) f32, the compat screen
    type_masks: Optional[np.ndarray] = None,  # (T, W) f32
    max_per_node: int = 2**31 - 1,
    engine: Optional[str] = None,
    trace_ctx=None,
    device=None,
) -> dict:
    """One giant-tenant solve at the tensor level (bench config 12):

    1. compat screen (with masks): the class's shared viable-type set,
       from the type-sharded overlap product (``sharded_compat``) under a
       mesh, the host matmul without one; a type is viable iff every
       signature admits it;
    2. frontier: Pareto points of the viable allocatable rows;
    3. pack: the pods in ``np.lexsort`` order through ``sharded_pod_pack``;
    4. assign: the cheapest viable type per packed node
       (``pack.assign_cheapest_types``).

    ``trace_ctx``: a calling thread's captured context, so the spans land
    under its decision. ``device`` places the pack without a mesh (None:
    the card). Plans are engine-independent. → the plan arrays, the
    stage wall times and the shard padding stats (the reference's
    result dict)."""
    reset_shard_stats()
    out: dict = {}
    with tracer.adopt(trace_ctx, "shard.mega.adopt", pods=int(requests.shape[0])):
        with tracer.span("shard.mega", pods=int(requests.shape[0])):
            t0 = time.perf_counter()
            viable = np.ones(alloc.shape[0], dtype=bool)
            if sig_masks is not None and type_masks is not None:
                with tracer.span("shard.mega.compat"):
                    if mesh is not None:
                        # the type axis padded to the mesh (zero rows:
                        # no overlap), recorded, and sliced back off
                        D = int(mesh.size)
                        T = type_masks.shape[0]
                        Tp = -(-T // D) * D
                        tm = type_masks
                        if Tp != T:
                            tm = np.concatenate([tm, np.zeros((Tp - T,) + tm.shape[1:], tm.dtype)])
                        record_shard_padding("types", T, Tp, accumulate=False, n_devices=D)
                        overlap = sharded_compat(mesh, sig_masks, tm)
                        # analysis: allow-host-sync(the one sync of the screen: the viable set is host data)
                        compat = overlap.cpu().numpy()[:, :T] > 0.0
                    else:
                        compat = (sig_masks @ type_masks.T) > 0.0
                    viable = compat.all(axis=0)
            t1 = time.perf_counter()
            viable_idx = np.flatnonzero(viable)
            if viable_idx.size == 0:
                return {
                    "nodes": 0,
                    "pods": int(requests.shape[0]),
                    "scheduled": 0,
                    "total_price": 0.0,
                    "shard": consume_shard_stats(),
                    "error": "no viable instance type",
                }
            valloc = np.ascontiguousarray(alloc[viable_idx], dtype=np.int32)
            vprices = np.asarray(prices, dtype=np.float64)[viable_idx]
            with tracer.span("shard.mega.frontier"):
                frontier = pack.pareto_frontier(valloc)
            # descending by primary then secondary axis (queue.go:76)
            order = np.lexsort((-requests[:, 1], -requests[:, 0]))
            sorted_reqs = np.ascontiguousarray(requests[order], dtype=np.int32)
            t2 = time.perf_counter()
            node_ids, node_count = sharded_pod_pack(
                mesh, sorted_reqs, frontier, np.int32(max_per_node), engine=engine, device=device
            )
            t3 = time.perf_counter()
            with tracer.span("shard.mega.assign", nodes=node_count):
                usage = pack.node_usage_from_assignment(sorted_reqs, node_ids, node_count)
                chosen = pack.assign_cheapest_types(usage, valloc, vprices)
            t4 = time.perf_counter()
            ok = chosen >= 0
            scheduled = int((node_ids >= 0).sum()) - int(np.isin(node_ids, np.flatnonzero(~ok)).sum())
            out.update(
                nodes=int(ok.sum()),
                pods=int(requests.shape[0]),
                scheduled=scheduled,
                total_price=float(vprices[chosen[ok]].sum()),
                node_ids=node_ids,
                node_order=order,
                chosen_types=viable_idx[np.maximum(chosen, 0)][ok],
                frontier_rows=int(frontier.shape[0]),
                viable_types=int(viable_idx.size),
                compat_ms=round((t1 - t0) * 1000.0, 2),
                prep_ms=round((t2 - t1) * 1000.0, 2),
                pack_ms=round((t3 - t2) * 1000.0, 2),
                assign_ms=round((t4 - t3) * 1000.0, 2),
                wall_ms=round((t4 - t0) * 1000.0, 2),
                shard=consume_shard_stats(),
            )
    return out


# ---------------------------------------------------------------------------
# the fleet's consolidation screen over candidate shards


@deviceplane.observe("sharding.sharded_prefix_screen")
def sharded_prefix_screen(
    mesh: Mesh,
    candidate_loads,  # (N, R) int32, N divisible by the mesh size
    candidate_free,  # (N, R) int32
    fleet_free_local,  # (D, R) int32: each shard's part of the fleet's free capacity
    new_node_cap,  # (R,) int32
) -> torch.Tensor:
    """B8's prefix screen over D candidate shards → (N,) bool, as
    ``prefix_screen_kernel`` on the whole candidate axis. The fleet's
    free capacity is the sum of the shards' parts (the reference's
    ``psum``); the running sums over the candidates are one pass of
    ``screen_kernels.screen_prefix`` on the card (the reference adds
    per-shard cumsums to all-gathered offsets, which agrees wherever
    every partial sum stays below 2^24)."""
    from ..disruption import screen_kernels

    loads, free = _on(mesh, candidate_loads), _on(mesh, candidate_free)
    fleet_local, cap = _on(mesh, fleet_free_local), _on(mesh, new_node_cap)
    _divides(mesh, loads.shape[0], "the candidate count")
    if fleet_local.shape[0] != mesh.size:
        raise ValueError(f"fleet_free_local has {fleet_local.shape[0]} rows for {mesh.size} shards")
    # int32 wraps as the reference's int32 psum does
    fleet = fleet_local.to(torch.int64).sum(dim=0).to(torch.int32)
    return screen_kernels.screen_prefix(loads, free, fleet, cap)


# ---------------------------------------------------------------------------
# types: the catalog over the shards


def prepare_sharded_catalog(
    mesh: Mesh,
    type_masks: Dict[str, np.ndarray],
    type_has: Dict[str, np.ndarray],
    type_neg: Dict[str, np.ndarray],
    avail: np.ndarray,
    keys: Optional[Sequence[str]] = None,
) -> tuple:
    """The catalog side of the compat kernel on the mesh's card, its type
    axis padded to a multiple of the shards → (``DeviceCatalog``, T).
    Callers cache it per catalog generation (``solver._entry_sharded``).
    Padded types have no offering, so they read as disallowed; the
    padding is recorded (the solver records the active catalog's again
    each solve). ``keys``: the requirement keys, sorted by default."""
    from .compat_kernels import catalog_to_device

    D = int(mesh.size)
    T = avail.shape[0]
    Tp = -(-T // D) * D
    record_shard_padding("types", T, Tp, accumulate=False, n_devices=D)

    def pad_t(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a)
        if a.shape[0] == Tp:
            return a
        return np.concatenate([a, np.zeros((Tp - a.shape[0],) + a.shape[1:], dtype=a.dtype)], axis=0)

    keys = tuple(sorted(type_masks)) if keys is None else tuple(keys)
    catalog = catalog_to_device(
        {k: pad_t(v) for k, v in type_masks.items()},
        {k: pad_t(v) for k, v in type_has.items()},
        {k: pad_t(v) for k, v in type_neg.items()},
        keys, pad_t(avail), mesh.device,
    )
    devicetime.transfer("h2d", catalog.planes, catalog.key_off, phase="shard")
    return catalog, T


def allowed_sharded(
    prepared: tuple,
    sig_arrays: Dict[str, np.ndarray],
    zone_ok: np.ndarray,
    ct_ok: np.ndarray,
    keys: Tuple[str, ...],
) -> torch.Tensor:
    """Compat ∧ offering against a prepared catalog: one B1 launch over
    the padded type axis (the shards' row blocks), sliced back to T →
    (S, T) bool on the mesh's card."""
    from .compat_kernels import allowed_via_kernel, signature_side

    catalog, T = prepared
    planes = signature_side(sig_arrays, zone_ok, ct_ok, catalog, keys=keys)
    return allowed_via_kernel(planes, catalog)[:, :T]


@deviceplane.observe("sharding.sharded_compat")
def sharded_compat(
    mesh: Mesh,
    sig_masks,  # (S, W) f32 0/1: flattened key masks
    type_masks,  # (T, W) f32 0/1, T divisible by the mesh size
) -> torch.Tensor:
    """The type-sharded overlap product ``q @ m.T`` → (S, T) float32 on
    the mesh's card. The reference computes it with XLA, outside any
    Pallas kernel; its sums are integers of at most W, exact in
    float32."""
    q, m = _on(mesh, sig_masks).to(torch.float32), _on(mesh, type_masks).to(torch.float32)
    _divides(mesh, m.shape[0], "the type count")
    return q @ m.T
