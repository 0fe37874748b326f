"""B8: the consolidation screens (``csrc/disrupt_screen.cu``) ≡ the JAX package's.

The JAX package's three float32 screens (``prefix_screen_kernel``,
``subset_screen_kernel``, ``single_screen_kernel`` in
``karpenter_core_tpu/disruption/tpu_repack.py``, jitted on the CPU) are
held to the port's plain versions (``screen_kernels.*_reference``) and to
the g++ host build of the kernel source (``disrupt_*_host``: the same
column functions the card runs):

- on seeded inputs whose partial sums stay below 2^24, where every order
  of float32 addition is exact: all three give the same bools, exactly;
- at the sizes of bench config 4 (1,000 candidates, a family of 8,193
  subsets) and config 9 (25 candidates), below 2^24 the same;
- above 2^24 the reference's order is XLA's own, so there the plain
  version is held to the host build and to a sequential float32 sum in
  numpy, on seeded inputs and on a constructed near-tie whose verdict
  flips with the order of the additions;
- at the edges of the kernel's structure (register chunks of 8 columns,
  shared-memory tiles, blocks of subset rows, unaligned mask rows, mask
  bytes other than 0 and 1) and on ``chip_smoke.py``'s synthetic shapes,
  below 2^24 against the JAX package, above it plain version against
  host build, and the near-tie past a tile boundary and in a later chunk;
- the subset screen on prefix masks equals the prefix screen;
- the wrappers take the plain version on CPU tensors and refuse other
  devices.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from karpenter_core_tpu.disruption import tpu_repack as ref
from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch.disruption import screen_kernels as sk

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def host():
    return buildlib.host_library("disrupt_screen.cu")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_screen(lib, kind: str, loads, free, fleet, cap, masks=None) -> np.ndarray:
    """One screen through the g++ build of the kernel source."""
    N, R = loads.shape
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in (loads, free, fleet, cap)]
    if kind == "subsets":
        masks = np.ascontiguousarray(masks, dtype=np.uint8)
        out = np.zeros(masks.shape[0], dtype=np.uint8)
        rc = lib.disrupt_subsets_host(_ptr(masks), *map(_ptr, arrays), ctypes.c_int64(masks.shape[0]),
                                      ctypes.c_int64(N), ctypes.c_int64(R), _ptr(out))
    else:
        out = np.zeros(N, dtype=np.uint8)
        fn = lib.disrupt_prefix_host if kind == "prefix" else lib.disrupt_singles_host
        rc = fn(*map(_ptr, arrays), ctypes.c_int64(N), ctypes.c_int64(R), _ptr(out))
    assert rc == 0
    return out.astype(bool)


def plain_screen(kind: str, loads, free, fleet, cap, masks=None) -> np.ndarray:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    if kind == "prefix":
        return sk.screen_prefix(t(loads), t(free), t(fleet), t(cap)).numpy()
    if kind == "singles":
        return sk.screen_singles(t(loads), t(free), t(fleet), t(cap)).numpy()
    return sk.screen_subsets(t(masks.astype(np.uint8)), t(loads), t(free), t(fleet), t(cap)).numpy()


def jax_screen(kind: str, loads, free, fleet, cap, masks=None) -> np.ndarray:
    if kind == "prefix":
        return np.asarray(ref.prefix_screen_kernel(loads, free, fleet, cap))
    if kind == "singles":
        return np.asarray(ref.single_screen_kernel(loads, free, fleet, cap))
    return np.asarray(ref.subset_screen_kernel(masks.astype(np.float32), loads, free, fleet, cap))


def sequential_screen(kind: str, loads, free, fleet, cap, masks=None) -> np.ndarray:
    """The screens' formulas with every sum taken in candidate order, one
    numpy float32 add at a time (the order the kernel fixes)."""
    f32 = np.float32
    N, R = loads.shape
    lf, ff = loads.astype(f32), free.astype(f32)

    def seq(rows, select):
        acc = np.zeros(R, dtype=f32)
        for n in range(rows.shape[0]):
            acc = (acc + (rows[n] if select[n] else np.zeros(R, dtype=f32))).astype(f32)
        return acc

    total = seq(ff, np.ones(N, bool))
    rows = []
    if kind == "prefix":
        for k in range(N):
            sel = np.arange(N) <= k
            rows.append((seq(lf, sel), (total - seq(ff, sel)).astype(f32)))
    elif kind == "singles":
        for i in range(N):
            rows.append((lf[i], (total - ff[i]).astype(f32)))
    else:
        for m in masks.astype(bool):
            rows.append((seq(lf, m), seq(ff, ~m)))
    out = []
    for load, surviving in rows:
        headroom = ((fleet.astype(f32) + surviving).astype(f32) + cap.astype(f32)).astype(f32)
        out.append(bool(np.all(load <= headroom)))
    return np.array(out, dtype=bool)


def _inputs(rng, N: int, R: int, hi: int, S: int = 0, density: float = 0.4):
    """Seeded screen inputs: per-candidate loads and free capacity below
    ``hi``, the fleet's free and the largest new node near the middle of
    the range a row's load takes (so verdicts split), masks of density
    ``density``."""
    loads = rng.randint(0, hi, (N, R)).astype(np.int32)
    free = rng.randint(0, hi, (N, R)).astype(np.int32)
    mid = max(1, hi * max(1, N) // 4)
    fleet = rng.randint(0, mid, R).astype(np.int32)
    cap = rng.randint(0, mid, R).astype(np.int32)
    masks = (rng.rand(S, N) < density) if S else None
    return loads, free, fleet, cap, masks


KINDS = ("prefix", "subsets", "singles")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("N,R,S", [(1, 1, 1), (7, 3, 12), (33, 5, 70), (64, 40, 33)])
def test_below_2_24_all_three_equal(host, kind, seed, N, R, S):
    rng = np.random.RandomState(seed * 100 + N)
    # every partial sum stays below 2^24: N values below 2^24 / (2 N)
    loads, free, fleet, cap, masks = _inputs(rng, N, R, (1 << 24) // (4 * N), S)
    want = jax_screen(kind, loads, free, fleet, cap, masks)
    np.testing.assert_array_equal(plain_screen(kind, loads, free, fleet, cap, masks), want)
    np.testing.assert_array_equal(host_screen(host, kind, loads, free, fleet, cap, masks), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("config,N,R,S", [("config4", 1000, 3, 8193), ("config9", 25, 3, 97)])
def test_config_sizes_below_2_24(host, kind, config, N, R, S):
    """Bench config 4's shapes (N = MAX_PARALLEL_TPU_SCREEN, the family
    at FAMILY_MAX plus the cross-pool row) and config 9's (25 candidates
    after the 5 % budget)."""
    rng = np.random.RandomState(4 if config == "config4" else 9)
    loads, free, fleet, cap, masks = _inputs(rng, N, R, (1 << 24) // (2 * N), S, density=0.5)
    if kind == "subsets":
        # prefix rows of the canonical order, as the engine's family begins
        masks[: N - 1] = np.tril(np.ones((N, N), dtype=bool))[1:]
    if kind == "singles":
        # one candidate's load against the others' free: small free, so
        # the verdicts split
        free //= N
        fleet //= N
        cap //= N
    want = jax_screen(kind, loads, free, fleet, cap, masks)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(plain_screen(kind, loads, free, fleet, cap, masks), want)
    np.testing.assert_array_equal(host_screen(host, kind, loads, free, fleet, cap, masks), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_above_2_24_plain_equals_host_and_sequential(host, kind, seed):
    """Quantized memory columns reach 2^29 a node, so the sums pass 2^24:
    the kernel's order (candidate order, float32, one add at a time) is
    held by the plain version and the host build alike."""
    rng = np.random.RandomState(50 + seed)
    loads, free, fleet, cap, masks = _inputs(rng, 40, 4, 1 << 29, 60)
    want = sequential_screen(kind, loads, free, fleet, cap, masks)
    np.testing.assert_array_equal(plain_screen(kind, loads, free, fleet, cap, masks), want)
    np.testing.assert_array_equal(host_screen(host, kind, loads, free, fleet, cap, masks), want)


def test_near_tie_above_2_24_follows_candidate_order(host):
    """free = [2^24, 1, 1, 0]: in candidate order 2^24 + 1 rounds back to
    2^24 twice, so the surviving free of the row that removes candidate 3
    is 2^24 and its load 2^24 + 2 does not fit; summed from the other
    end it is 2^24 + 2 and would fit. Plain version and host build both
    take the candidate order."""
    loads = np.array([[0], [0], [0], [(1 << 24) + 2]], dtype=np.int32)
    free = np.array([[1 << 24], [1], [1], [0]], dtype=np.int32)
    fleet = np.zeros(1, dtype=np.int32)
    cap = np.zeros(1, dtype=np.int32)
    masks = np.array([[0, 0, 0, 1]], dtype=np.uint8)
    reversed_sum = np.float32(0)
    for v in free[::-1, 0].astype(np.float32):
        reversed_sum = np.float32(reversed_sum + v)
    assert np.float32(loads[3, 0]) <= reversed_sum  # the other order fits
    for screen in (plain_screen, lambda *a, **k: host_screen(host, *a, **k)):
        assert not screen("subsets", loads, free, fleet, cap, masks)[0]
        # single row 3: total (2^24 in order) minus 0 → the same verdict
        assert not screen("singles", loads, free, fleet, cap)[3]
        # prefix row 3 removes all four candidates: nothing survives
        assert not screen("prefix", loads, free, fleet, cap)[3]
    np.testing.assert_array_equal(
        plain_screen("subsets", loads, free, fleet, cap, masks),
        sequential_screen("subsets", loads, free, fleet, cap, masks),
    )


# The kernel's structure: the subset entry holds up to 8 columns in
# registers (R = 9 and past it walk again), a warp is 32 wide (R = 33),
# the bench's stateful screen axes reach R = 70; N up to 1,024 is one
# shared-memory tile (N = 31-33 a ragged one), past it tiles of 512
# (N = 4,097), 32 subset rows a block (S = 67 and 130 are not multiples
# of it) and odd N, so mask rows start unaligned.
EDGE_R = (1, 3, 8, 9, 33, 70)
EDGE_N = (1, 31, 32, 33, 1000, 4097)


def _edge_inputs(rng, N: int, R: int, S: int, hi: int):
    """Seeded inputs whose verdicts split at any width: three tight
    columns (the first, the middle and the last, so every register chunk
    of a wide R holds one) with loads below ``hi`` and free below 2/3 of
    it (a 40 % mask's load against the other 60 %'s free), every other
    column loose (loads below 4, the fleet's free 4 N, free below
    ``hi`` all the same, so its sums grow as large)."""
    loads = rng.randint(0, 4, (N, R)).astype(np.int32)
    free = rng.randint(0, hi, (N, R)).astype(np.int32)
    fleet = np.full(R, 4 * N, dtype=np.int32)
    cap = np.zeros(R, dtype=np.int32)
    tight = sorted({0, R // 2, R - 1})
    loads[:, tight] = rng.randint(0, hi, (N, len(tight)))
    free[:, tight] = rng.randint(0, max(1, 2 * hi // 3), (N, len(tight)))
    fleet[tight] = rng.randint(0, max(1, hi), len(tight))
    cap[tight] = rng.randint(0, max(1, hi), len(tight))
    masks = rng.rand(S, N) < 0.4
    return loads, free, fleet, cap, masks


@pytest.mark.parametrize("R", EDGE_R)
@pytest.mark.parametrize("N", EDGE_N)
@pytest.mark.parametrize("kind", ("prefix", "subsets"))
def test_structure_edges_below_2_24(host, kind, N, R):
    rng = np.random.RandomState(1000 + 7 * N + R)
    S = 67 if N % 2 else 130
    # a column's sum stays below 2^23
    loads, free, fleet, cap, masks = _edge_inputs(rng, N, R, S, max(2, (1 << 23) // N))
    want = jax_screen(kind, loads, free, fleet, cap, masks)
    if N > 1:
        assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(plain_screen(kind, loads, free, fleet, cap, masks), want)
    np.testing.assert_array_equal(host_screen(host, kind, loads, free, fleet, cap, masks), want)


@pytest.mark.parametrize("R", (3, 9, 70))
@pytest.mark.parametrize("N", (33, 1000, 4097))
@pytest.mark.parametrize("kind", ("prefix", "subsets"))
def test_structure_edges_above_2_24(host, kind, N, R):
    """Partial sums far past 2^24 at the structure's edges: the plain
    version and the host build take the same order, bit for bit."""
    rng = np.random.RandomState(2000 + 7 * N + R)
    loads, free, fleet, cap, masks = _edge_inputs(rng, N, R, 67, 1 << 29)
    assert float(free.astype(np.float64).sum(0).max()) > 2.0**24
    want = plain_screen(kind, loads, free, fleet, cap, masks)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(host_screen(host, kind, loads, free, fleet, cap, masks), want)
    if N == 33:
        np.testing.assert_array_equal(sequential_screen(kind, loads, free, fleet, cap, masks), want)


@pytest.mark.parametrize("N,R", [(33, 3), (1000, 9), (257, 8)])
def test_mask_bytes_other_than_one(host, N, R):
    """A mask byte masks its candidate when it is not 0, whatever its
    value (the plain version's ``masks.to(torch.bool)``); the kernel
    folds each byte to 0 or 1 before it selects."""
    rng = np.random.RandomState(300 + N + R)
    loads, free, fleet, cap, masks = _edge_inputs(rng, N, R, 70, 1 << 20)
    masks = (masks * rng.randint(1, 256, masks.shape)).astype(np.uint8)
    assert masks.max() > 1
    want = plain_screen("subsets", loads, free, fleet, cap, masks)
    np.testing.assert_array_equal(want, plain_screen("subsets", loads, free, fleet, cap, masks != 0))
    np.testing.assert_array_equal(host_screen(host, "subsets", loads, free, fleet, cap, masks), want)


def near_tie(N: int, R: int, at: int, col: int):
    """The near-tie of ``test_near_tie_above_2_24_follows_candidate_order``
    in column ``col`` of R, its three free values at candidates at,
    at + 1, at + 2, the load 2^24 + 2 on candidate 0: every other column
    fits with room to spare. → loads, free, fleet, cap, and one subset row
    that removes candidate 0 alone."""
    loads = np.zeros((N, R), dtype=np.int32)
    free = np.zeros((N, R), dtype=np.int32)
    loads[:, :] = 1
    loads[:, col] = 0
    loads[0, col] = (1 << 24) + 2
    free[at:at + 3, col] = [1 << 24, 1, 1]
    fleet = np.full(R, 4 * N, dtype=np.int32)
    fleet[col] = 0
    cap = np.zeros(R, dtype=np.int32)
    masks = np.zeros((1, N), dtype=np.uint8)
    masks[0, 0] = 1
    return loads, free, fleet, cap, masks


NEAR_TIES = [(4, 1, 1, 0), (1000, 3, 511, 2), (1000, 9, 600, 8), (4097, 70, 4000, 69)]


@pytest.mark.parametrize("N,R,at,col", NEAR_TIES)
def test_near_tie_at_structure_edges(host, N, R, at, col):
    """In candidate order 2^24 + 1 + 1 stays 2^24, so removing candidate 0
    (load 2^24 + 2) does not fit; summed from the other end it would. Both
    redesigned entries, the plain versions and the host build keep the
    candidate order across tiles, register chunks and warp widths."""
    loads, free, fleet, cap, masks = near_tie(N, R, at, col)
    reversed_sum = np.float32(0)
    for v in free[::-1, col].astype(np.float32):
        reversed_sum = np.float32(reversed_sum + v)
    assert np.float32(loads[0, col]) <= reversed_sum  # the other order fits
    for screen in (plain_screen, lambda *a, **k: host_screen(host, *a, **k)):
        assert not screen("subsets", loads, free, fleet, cap, masks)[0]
        # prefix rows before the free values: surviving = the whole total
        assert not screen("prefix", loads, free, fleet, cap)[:at].any()
        assert not screen("singles", loads, free, fleet, cap)[0]


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_b8", Path(__file__).resolve().parent.parent / "chip_smoke.py"
    )
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("index", range(4))
def test_chip_smoke_synthetic_screens(host, chip_smoke, index):
    """The synthetic shapes ``chip_smoke.py`` times on the card (the
    subset family at its cap, 8 columns, the long prefixes): their sums
    pass 2^24, and the host build of the kernel source equals the plain
    version on them, bit for bit."""
    kind, call = chip_smoke.synthetic_screen_calls()[index]
    assert kind == chip_smoke.SYNTHETIC_SCREENS[index][0]
    arrays = [a.numpy() for a in call]
    masks, (loads, free, fleet, cap) = (arrays[0] if kind == "subsets" else None), arrays[-4:]
    _, S, N, R = chip_smoke.SYNTHETIC_SCREENS[index]
    assert loads.shape == (N, R) and (masks is None or masks.shape == (S, N))
    assert float(free.astype(np.float64).sum(0).max()) > 2.0**24
    want = plain_screen(kind, loads, free, fleet, cap, masks)
    np.testing.assert_array_equal(host_screen(host, kind, loads, free, fleet, cap, masks), want)
    assert chip_smoke.screen_chain_adds(kind, N, R) == (N * -(-R // 8) if kind == "subsets" else N)


@pytest.mark.parametrize("seed", SEEDS)
def test_subset_generalizes_prefix(host, seed):
    """Prefix masks through the subset screen give the prefix screen's
    verdicts (the port's twin of the JAX test left out of the mirror)."""
    rng = np.random.RandomState(5 + seed)
    N, R = 6, 3
    loads = rng.randint(0, 50, (N, R)).astype(np.int32)
    free = rng.randint(0, 30, (N, R)).astype(np.int32)
    fleet = rng.randint(10, 100, (R,)).astype(np.int32)
    cap = rng.randint(20, 60, (R,)).astype(np.int32)
    masks = np.tril(np.ones((N, N), dtype=bool))
    pref = plain_screen("prefix", loads, free, fleet, cap)
    np.testing.assert_array_equal(plain_screen("subsets", loads, free, fleet, cap, masks), pref)
    np.testing.assert_array_equal(host_screen(host, "subsets", loads, free, fleet, cap, masks), pref)
    np.testing.assert_array_equal(jax_screen("prefix", loads, free, fleet, cap), pref)


def test_empty_and_zero_width():
    """No candidates, no rows, no columns: the shapes the reference
    returns (``all`` over no column is True)."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    assert sk.screen_prefix(z(0, 3), z(0, 3), z(3), z(3)).shape == (0,)
    assert sk.screen_subsets(torch.zeros((0, 4), dtype=torch.uint8), z(4, 3), z(4, 3), z(3), z(3)).shape == (0,)
    assert sk.screen_singles(z(5, 0), z(5, 0), z(0), z(0)).all()


def test_wrappers_refuse_other_devices():
    z = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    r = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sk.screen_prefix(z, z, r, r)
    with pytest.raises(ValueError):
        sk.screen_singles(z, z, r, r)
    with pytest.raises(ValueError):
        sk.screen_subsets(torch.zeros((1, 2), dtype=torch.uint8, device="meta"), z, z, r, r)


def test_cpu_calls_count_no_launch():
    before = sk.launches()
    z = torch.ones((3, 2), dtype=torch.int32)
    sk.screen_prefix(z, z, z[0], z[0])
    sk.screen_singles(z, z, z[0], z[0])
    sk.screen_subsets(torch.ones((2, 3), dtype=torch.uint8), z, z, z[0], z[0])
    assert sk.launches() == before
