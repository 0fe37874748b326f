"""The sharded solve: D shards over the cards of one host.

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

Here a mesh (``Mesh``) is **D shards over an ordered tuple of
placements**, D a multiple of their number. A placement is a device: a
card (``cuda:N``) or, in the CPU tests, the CPU. Each placement holds a
contiguous block of D / placements shards, as ``P(axis)`` splits axis 0
over the reference's devices, and runs it as one launch on its own card
of the kernel the reference runs per device (B5's ``csrc/ffd_pack.cu``
for the packs, B1's ``csrc/compat_allowed.cu`` for the catalog, B8's
``csrc/disrupt_screen.cu`` for the prefix screen). Every placement's
launch is enqueued before the first host sync, so the cards run side by
side. The collectives are peer copies to the first placement
(``Mesh.device``): a sum of the counts for ``psum``, a concatenation for
``all_gather``. One process drives every card, as the reference's
single-controller ``shard_map`` does. The placements are kept as given:
``["cuda:0"] * 4`` is four launches on one card, ``["cuda:0", ...,
"cuda:3"]`` four cards, and ``make_mesh(D, device=...)`` one placement
holding all D shards (one launch). Every shard computes the same thing
wherever it runs, so the plans depend on D alone, never on the
placements, and the ``sharded`` and ``unsharded`` engines stay
plan-identical by construction.

The reference's knobs ``KARPENTER_TPU_SHARD_ENGINE``,
``KARPENTER_TPU_SHARD_MIN_PODS`` and ``KARPENTER_TPU_SHARDED`` are the
module constants ``SHARD_ENGINE``, ``SHARD_MIN_PODS`` and ``SHARDED``,
with the same defaults (tests monkeypatch them). ``active_mesh`` follows
the reference's rule with cards for devices: ``off`` never shards, an
installed mesh (``install_mesh``, the seam tests use) wins, ``on``
shards over every visible card when there are two or more, and ``auto``
does the same when the backend is ``cuda``. A solve shards only when
the mesh's first placement is its own device (``TorchScheduler._mesh``);
a solver on another card runs the one-card path.

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
from typing import Dict, List, Optional, Sequence, Tuple

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
    """D shards over ``placements``, D a multiple of their number.
    ``size`` is the reference's ``mesh.devices.size``, ``axis_names`` its
    axis names."""

    size: int
    axis: str
    placements: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def device(self) -> torch.device:
        """The first placement: where the collectives gather."""
        return self.placements[0]

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the placements, in order."""
        return tuple(dict.fromkeys(self.placements))


def _placement(d) -> torch.device:
    """``d`` as a placement: a card always carries its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "groups", device=None, devices: Optional[Sequence] = None
) -> Mesh:
    """A mesh of ``n_devices`` shards. ``devices``: its placements, kept
    as given, duplicates included (default: one placement on ``device``,
    None meaning the card); ``n_devices`` defaults to one shard a
    placement and must be a multiple of the placements."""
    placements = (_placement(device),) if devices is None else tuple(_placement(d) for d in devices)
    if not placements:
        raise ValueError("a mesh needs at least one placement")
    n = (1 if devices is None else len(placements)) if n_devices is None else int(n_devices)
    if n < 1 or n % len(placements):
        raise ValueError(f"a mesh of {len(placements)} placements needs a positive multiple of them as shards, got {n}")
    return Mesh(n, axis, placements)


def shard_map_available() -> bool:
    """The reference asks whether its jax has ``shard_map``; the port's
    shard map is a launch a placement, always there."""
    return True


# ---------------------------------------------------------------------------
# pod-axis mega-shard configuration


def shard_engine() -> str:
    """``sharded`` or ``unsharded``: the reference's ``shard_map`` and
    its ``vmap`` parity oracle, the same launches here (the label the
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


_CARDS: Dict[int, Mesh] = {}  # the mesh over every visible card, by their count


def active_mesh(backend: str) -> Optional[Mesh]:
    """The mesh the solve shards over, or None for the one-device path,
    by the reference's rule with the cards for its devices. ``SHARDED``:
    ``off`` never shards; an installed mesh is used otherwise; ``on``
    gives a mesh over every visible card (one shard a card) when there
    are two or more, and ``auto`` the same when ``backend`` is ``cuda``
    (the reference's multi-chip accelerator)."""
    mode = SHARDED
    if mode == "off":
        return None
    if _INSTALLED is not None:
        return _INSTALLED
    if mode == "auto" and backend != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    mesh = _CARDS.get(n)
    if mesh is None:
        # the cards were just counted: no availability check to repeat
        mesh = _CARDS[n] = Mesh(n, "groups", tuple(torch.device("cuda", i) for i in range(n)))
    return mesh


def _tensor(a) -> torch.Tensor:
    """``a`` (a tensor or an array) as a tensor, where it lies."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _on(dev: torch.device, a) -> torch.Tensor:
    """``a`` (a tensor or an array) on ``dev``."""
    return _tensor(a).to(dev)


def _divides(mesh: Mesh, n: int, what: str) -> None:
    if n % mesh.size:
        raise ValueError(f"{what} ({n}) must divide over the mesh's {mesh.size} shards")


def _blocks(mesh: Mesh, n: int) -> List[Tuple[torch.device, int, int]]:
    """Each placement's contiguous block [start, end) of an axis of ``n``
    (a multiple of the shards): D / placements shards each."""
    per = n // len(mesh.placements)
    return [(dev, i * per, (i + 1) * per) for i, dev in enumerate(mesh.placements)]


def _download(parts: List[torch.Tensor]) -> np.ndarray:
    """The placements' parts on the host, joined along axis 0 in
    placement order: one download for each run of parts on one card."""
    runs: List[List[torch.Tensor]] = []
    for p in parts:
        if runs and runs[-1][0].device == p.device:
            runs[-1].append(p)
        else:
            runs.append([p])
    # analysis: allow-host-sync(the shards' results are host arrays; every launch was enqueued first)
    host = [(run[0] if len(run) == 1 else torch.cat(run)).cpu().numpy() for run in runs]
    return host[0] if len(host) == 1 else np.concatenate(host)


def _gather(dst: torch.device, parts: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The all-gather: every placement's part copied to ``dst``, the
    first placement (peer copies, stream-ordered, no host sync), and
    joined along ``dim`` in placement order. The bytes that crossed cards
    are a ``peer`` transfer at the ``shard`` boundary."""
    if len(parts) == 1:
        return parts[0]
    crossed = [p for p in parts if p.device != dst]
    if crossed:
        devicetime.transfer("peer", *crossed, phase="shard")
    return torch.cat([p.to(dst) for p in parts], dim=dim)


# ---------------------------------------------------------------------------
# groups: the batched pack over the shards


@lru_cache(maxsize=16)
def _sharded_pack_fn(mesh: Mesh):
    """The group pack over ``mesh``'s placements, cached per mesh as the
    reference caches its jitted ``shard_map``: each placement's block of
    groups is the jobs of one B5 launch on its card, all enqueued first;
    the ids and counts gather on the first placement, and the fleet total
    is their sum there (the reference's ``psum``)."""

    def per_mesh(reqs, fronts, caps, n_pods=None):
        _divides(mesh, reqs.shape[0], "the group count")
        parts = []
        for dev, g0, g1 in _blocks(mesh, reqs.shape[0]):
            args = [a[g0:g1].to(dev) for a in (reqs, fronts, caps)]
            parts.append(pack.ffd_pack_batched(*args, pack.K_OPEN, None if n_pods is None else n_pods[g0:g1].to(dev)))
        node_ids = _gather(mesh.device, [ids for ids, _ in parts])
        counts = _gather(mesh.device, [c for _, c in parts])
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
    node_counts (G,), fleet_total ()), on the mesh's first placement.
    The inputs may lie on the host or on a card: each placement's block
    is copied to its own card. G divides over the shards, as
    ``shard_map`` requires."""
    return _sharded_pack_fn(mesh)(
        _tensor(requests), _tensor(frontiers), _tensor(max_per_node), None if n_pods is None else _tensor(n_pods),
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
    sorted, so each chunk's scan is a well-formed FFD); each placement's
    block of chunks goes through one B5 launch on its card at K =
    ``pack.K_OPEN`` as jobs, every placement's launch enqueued before the
    first download, then one download a card; the chunks' node ids
    renumber into one id space by the exclusive cumsum of the chunk
    counts. The padding pods take ``fmax + 1``: they emit -1 without
    touching a scan, and the launch skips them (each chunk's real pod
    count rides ``n_pods``). ``engine`` (default ``shard_engine()``) is a
    label: the reference's ``shard_map`` over the shards and its
    one-device ``vmap`` twin compute the same chunks, so both engines run
    them here, and the engine reaches the stats (no mesh degrades
    ``sharded`` to ``unsharded`` there, as in the reference) and the
    job-memo keys (``pod_shard_token``). Runs on the mesh's placements,
    or on ``device`` (None: the card) without a mesh.

    → (node_ids (P,) int32 global ids, -1 ⇒ unschedulable; node count).
    """
    if engine is None:
        engine = shard_engine()
    D = int(mesh.size) if mesh is not None else 1
    if engine == "sharded" and mesh is None:
        engine = "unsharded"  # explicit degrade, recorded in the stats
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
    blocks = _blocks(mesh, D) if mesh is not None else [(resolve_device(device), 0, D)]
    cards = mesh.cards if mesh is not None else None
    with tracer.span("pack.shard.dispatch", pods=P, chunks=D, chunk_len=Pc, engine=engine):
        deviceplane.record_footprint(deviceplane.nbytes_of(reqs, fronts, caps, n_pods))
        with devicetime.track(phase="shard", devices=cards):
            devicetime.transfer("h2d", reqs, fronts, caps, n_pods, phase="shard")
            launched = []
            for dev, d0, d1 in blocks:
                args = [torch.from_numpy(a[d0:d1]).to(dev) for a in (reqs, fronts, caps, n_pods)]
                launched.append(pack.ffd_pack_batched(args[0], args[1], args[2], pack.K_OPEN, args[3]))
            # the one sync of the mega dispatch: a download a card, after
            # every card's launch
            ids = _download([i for i, _ in launched])
            counts = _download([c for _, c in launched]).astype(np.int64)
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
    """B8's prefix screen over D candidate shards → (N,) bool on the
    first placement, as ``prefix_screen_kernel`` on the whole candidate
    axis. The fleet's free capacity is the sum of the shards' parts (the
    reference's ``psum``, int32). Each placement screens its own block of
    candidates with one ``screen_kernels.screen_prefix`` launch on its
    card, the reference's all-gathered offsets folded into that launch's
    fleet: a block's rows need

        earlier loads + running load <= fleet + later free + block free left + cap,

    so its fleet is the fleet total + the later blocks' free − the
    earlier blocks' loads, computed in int64 from the blocks' gathered
    totals (negative where the earlier loads pass the fleet). Each row
    then agrees with the one pass over all N wherever every partial sum
    stays below 2^24, as the reference's float32 sums do."""
    from ..disruption import screen_kernels

    loads, free = _tensor(candidate_loads), _tensor(candidate_free)
    fleet_local, cap = _tensor(fleet_free_local), _tensor(new_node_cap)
    _divides(mesh, loads.shape[0], "the candidate count")
    if fleet_local.shape[0] != mesh.size:
        raise ValueError(f"fleet_free_local has {fleet_local.shape[0]} rows for {mesh.size} shards")
    # int32 wraps as the reference's int32 psum does
    fleet = _on(mesh.device, fleet_local).to(torch.int64).sum(dim=0).to(torch.int32)
    parts = [(dev, loads[a:b].to(dev), free[a:b].to(dev)) for dev, a, b in _blocks(mesh, loads.shape[0])]
    load_tot = _gather(mesh.device, [l.to(torch.int64).sum(dim=0, keepdim=True) for _, l, _ in parts])  # (placements, R)
    free_tot = _gather(mesh.device, [f.to(torch.int64).sum(dim=0, keepdim=True) for _, _, f in parts])
    earlier_loads = torch.cumsum(load_tot, dim=0) - load_tot
    later_free = free_tot.sum(dim=0, keepdim=True) - torch.cumsum(free_tot, dim=0)
    folded = (fleet.to(torch.int64)[None, :] + later_free - earlier_loads).to(torch.int32)
    out = [
        screen_kernels.screen_prefix(l, f, folded[i].to(dev), _on(dev, cap))
        for i, (dev, l, f) in enumerate(parts)
    ]
    return _gather(mesh.device, out)


# ---------------------------------------------------------------------------
# types: the catalog over the shards


@dataclass(frozen=True)
class ShardedCatalog:
    """The catalog's padded type side over a mesh: each placement's
    contiguous block of types as a ``DeviceCatalog`` on its card."""

    catalogs: Tuple  # (DeviceCatalog, ...): one a placement, in order

    @property
    def n_types(self) -> int:
        """The padded type count, a multiple of the shards."""
        return sum(c.n_types for c in self.catalogs)


def prepare_sharded_catalog(
    mesh: Mesh,
    type_masks: Dict[str, np.ndarray],
    type_has: Dict[str, np.ndarray],
    type_neg: Dict[str, np.ndarray],
    avail: np.ndarray,
    keys: Optional[Sequence[str]] = None,
) -> tuple:
    """The catalog side of the compat kernel over the mesh, its type axis
    padded to a multiple of the shards, each placement's contiguous block
    packed and uploaded to its card → (``ShardedCatalog``, T). Callers
    cache it per catalog
    generation (``solver._entry_sharded``). Padded types have no
    offering, so they read as disallowed; the padding is recorded (the
    solver records the active catalog's again each solve). ``keys``: the
    requirement keys, sorted by default."""
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
    tm, th, tn = ({k: pad_t(v) for k, v in side.items()} for side in (type_masks, type_has, type_neg))
    av = pad_t(avail)
    catalogs = []
    for dev, a, b in _blocks(mesh, Tp):
        catalogs.append(catalog_to_device(
            {k: v[a:b] for k, v in tm.items()}, {k: v[a:b] for k, v in th.items()},
            {k: v[a:b] for k, v in tn.items()}, keys, av[a:b], dev,
        ))
        devicetime.transfer("h2d", catalogs[-1].planes, catalogs[-1].key_off, phase="shard")
    return ShardedCatalog(tuple(catalogs)), T


def allowed_sharded(
    prepared: tuple,
    sig_arrays: Dict[str, np.ndarray],
    zone_ok: np.ndarray,
    ct_ok: np.ndarray,
    keys: Tuple[str, ...],
) -> torch.Tensor:
    """Compat ∧ offering against a prepared catalog: one B1 launch a
    placement on its block of the padded type axis, every launch enqueued
    first, the blocks all-gathered along the type axis on the first
    placement and sliced back to T → (S, T) bool there."""
    from .compat_kernels import allowed_via_kernel, signature_side

    sharded, T = prepared
    out = [
        allowed_via_kernel(signature_side(sig_arrays, zone_ok, ct_ok, catalog, keys=keys), catalog)
        for catalog in sharded.catalogs
    ]
    return _gather(sharded.catalogs[0].device, out, dim=1)[:, :T]


@deviceplane.observe("sharding.sharded_compat")
def sharded_compat(
    mesh: Mesh,
    sig_masks,  # (S, W) f32 0/1: flattened key masks
    type_masks,  # (T, W) f32 0/1, T divisible by the mesh size
) -> torch.Tensor:
    """The type-sharded overlap product ``q @ m.T`` → (S, T) float32 on
    the first placement: each placement multiplies the signatures by its
    block of types on its card, and the blocks all-gather along the type
    axis. The reference computes it with XLA, outside any Pallas kernel;
    its sums are integers of at most W, exact in float32 in any order."""
    q, m = _tensor(sig_masks).to(torch.float32), _tensor(type_masks).to(torch.float32)
    _divides(mesh, m.shape[0], "the type count")
    return _gather(mesh.device, [_on(dev, q) @ m[a:b].to(dev).T for dev, a, b in _blocks(mesh, m.shape[0])], dim=1)
