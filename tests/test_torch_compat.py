"""The port's compat ∧ offering path ≡ the JAX package's kernels.

Seeded ragged random planes (widths across 32-bit word and 128-lane
boundaries, with the offering leg) go through the JAX package's
``compat_kernel`` / ``allowed_kernel`` / ``allowed_host`` /
``compat_via_pallas(interpret=True)`` and through the port's plain
PyTorch versions and its packed-layout path on the CPU. Every
comparison is exact: the outputs are booleans.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from karpenter_core_tpu.solver.kernels import allowed_host, allowed_kernel, compat_kernel
from karpenter_core_tpu.solver.pallas_kernels import compat_via_pallas
from karpenter_core_tpu.solver.pallas_kernels import pack_masks as ref_pack_masks
from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch.solver import compat_kernels as ck
from karpenter_core_tpu_torch.solver import kernels as pk
from karpenter_core_tpu_torch.solver.backend import resolve_device


def _random_inputs(rng, S, T, widths, Z=3, C=2):
    keys = tuple(f"key-{i}" for i in range(len(widths)))
    sig_arrays = {"valid": rng.rand(S) > 0.1}
    type_masks, type_has, type_neg = {}, {}, {}
    for key, vk in zip(keys, widths):
        sig_arrays[f"mask:{key}"] = rng.rand(S, vk) > 0.6
        sig_arrays[f"has:{key}"] = rng.rand(S) > 0.3
        sig_arrays[f"neg:{key}"] = rng.rand(S) > 0.7
        type_masks[key] = rng.rand(T, vk) > 0.6
        type_has[key] = rng.rand(T) > 0.3
        type_neg[key] = rng.rand(T) > 0.7
    zone_ok = rng.rand(S, Z) > 0.3
    ct_ok = rng.rand(S, C) > 0.3
    avail = rng.rand(T, Z, C) > 0.5
    return keys, sig_arrays, type_masks, type_has, type_neg, zone_ok, ct_ok, avail


def _case(seed):
    rng = np.random.RandomState(seed)
    S = int(rng.randint(1, 60))
    T = int(rng.randint(1, 80))
    widths = [int(rng.randint(1, 300)) for _ in range(int(rng.randint(1, 6)))]
    return _random_inputs(rng, S, T, widths)


def _packed_allowed(keys, sig_arrays, type_masks, type_has, type_neg, zone_ok, ct_ok, avail):
    catalog = ck.catalog_to_device(type_masks, type_has, type_neg, keys, avail, "cpu")
    sig = ck.signature_side(sig_arrays, zone_ok, ct_ok, catalog)
    return ck.allowed_via_kernel(sig, catalog).numpy()


@pytest.mark.parametrize("seed", range(6))
def test_plain_versions_match_jax_kernels(seed):
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _case(seed)
    ref_compat = np.asarray(compat_kernel(sig, tm, th, tn, keys))
    ref_allowed = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    host = allowed_host(sig, tm, th, tn, zone_ok, ct_ok, avail, keys)
    np.testing.assert_array_equal(host, ref_allowed)

    t = lambda d: pk.to_tensors(d, "cpu")  # noqa: E731
    compat = pk.compat_reference(t(sig), t(tm), t(th), t(tn), keys).numpy()
    np.testing.assert_array_equal(compat, ref_compat)
    offering = pk.offering_reference(
        torch.from_numpy(zone_ok), torch.from_numpy(ct_ok), torch.from_numpy(avail)
    ).numpy()
    np.testing.assert_array_equal(compat & offering, ref_allowed)
    got = pk.allowed(sig, tm, th, tn, zone_ok, ct_ok, avail, keys, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref_allowed)


@pytest.mark.parametrize("seed", range(6))
def test_packed_path_matches_allowed_kernel(seed):
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _case(seed)
    ref_allowed = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    got = _packed_allowed(keys, sig, tm, th, tn, zone_ok, ct_ok, avail)
    np.testing.assert_array_equal(got, ref_allowed)


@pytest.mark.parametrize("seed", range(3))
def test_compat_via_kernel_matches_pallas_interpret(seed):
    keys, sig, tm, th, tn, *_ = _case(100 + seed)
    pallas = np.asarray(compat_via_pallas(sig, tm, th, tn, keys, interpret=True))
    got = ck.compat_via_kernel(sig, tm, th, tn, keys, device="cpu").numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, np.asarray(compat_kernel(sig, tm, th, tn, keys)))


@pytest.mark.parametrize("widths", [(1,), (31,), (32,), (33,), (200,), (300,), (1, 31, 32, 33, 200, 300)])
def test_ragged_widths_single_rows(widths):
    """S = 1 and T = 1 planes at every word/lane boundary width."""
    rng = np.random.RandomState(sum(widths))
    for S, T in ((1, 1), (1, 7), (5, 1)):
        keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _random_inputs(rng, S, T, list(widths))
        ref = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
        np.testing.assert_array_equal(
            _packed_allowed(keys, sig, tm, th, tn, zone_ok, ct_ok, avail), ref
        )


def test_catalog_from_reference_roundtrip():
    """The JAX package's 128-lane packed type side, carried over as the
    port's device catalog, gives the same allowed matrix."""
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _random_inputs(
        np.random.RandomState(7), 40, 50, [3, 130, 32, 257]
    )
    tp, thp, tnp, offsets, widths = ref_pack_masks(tm, th, tn, keys)
    catalog = ck.catalog_from_reference(tp, thp, tnp, offsets, widths, avail, "cpu")
    # every 128-lane chunk became four words holding exactly the lanes,
    # and one more word holds the key's three flag bits
    bits = ck.unpack_bits(catalog.planes.T).numpy()
    for k, (off, w) in enumerate(zip(offsets, widths)):
        woff = catalog.layout.offsets[k]
        assert catalog.layout.words[k] == w // 32 + 1
        np.testing.assert_array_equal(bits[:, woff * 32 : woff * 32 + w], tp[:, off : off + w] > 0)
        flags = bits[:, woff * 32 + w : woff * 32 + w + 3]
        np.testing.assert_array_equal(flags[:, 0], True)  # U_s
        np.testing.assert_array_equal(flags[:, 1], thp[:, k] == 0)  # U_t = ¬has_t
        np.testing.assert_array_equal(flags[:, 2], tnp[:, k] > 0)  # N
    sig_side = ck.signature_side(sig, zone_ok, ct_ok, catalog, keys=keys)
    got = ck.allowed_via_kernel(sig_side, catalog).numpy()
    ref = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    np.testing.assert_array_equal(got, ref)


def test_pack_masks_layout_zero_pad_bits():
    rng = np.random.RandomState(0)
    keys = ("a", "b", "c", "d")
    vk = {"a": 3, "b": 200, "c": 32, "d": 33}
    masks = {k: rng.rand(5, v) > 0.5 for k, v in vk.items()}
    has = {k: rng.rand(5) > 0.5 for k in keys}
    neg = {k: rng.rand(5) > 0.5 for k in keys}
    for side in (ck.SIG, ck.TYP):
        words, layout = ck.pack_masks(masks, has, neg, keys, side)
        assert layout.words == (1, 7, 2, 2)  # ceil((Vk + 3) / 32)
        assert layout.offsets == (0, 1, 8, 10, 12)
        assert words.shape == (5, 12) and words.dtype == np.int32
        np.testing.assert_array_equal(layout.key_offsets(), [0, 1, 8, 10, 12])
        bits = ck.unpack_bits(torch.from_numpy(words)).numpy()
        for i, (k, off) in enumerate(zip(keys, layout.offsets)):
            lo, v = off * 32, vk[k]
            np.testing.assert_array_equal(bits[:, lo : lo + v], masks[k])
            u_s, u_t, n = bits[:, lo + v], bits[:, lo + v + 1], bits[:, lo + v + 2]
            np.testing.assert_array_equal(u_s, ~has[k] if side == ck.SIG else True)
            np.testing.assert_array_equal(u_t, True if side == ck.SIG else ~has[k])
            np.testing.assert_array_equal(n, neg[k])
            assert not bits[:, lo + v + 3 : layout.offsets[i + 1] * 32].any()  # pad bits are zero


def test_row_blocking_boundary():
    T = 70
    assert ck.compat_row_block(T, budget_bytes=T * 100) == 96  # 100 rows → tile multiple
    assert ck.compat_row_block(T, budget_bytes=1) == ck.TILE_S  # never below one tile
    assert ck.compat_row_block(2000) == (64_000_000 // 2000 // 32) * 32
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _random_inputs(
        np.random.RandomState(3), 97, T, [5, 40]
    )
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, "cpu")
    side = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    whole = ck.allowed_via_kernel(side, catalog).numpy()
    blocked = ck.allowed_via_kernel(side, catalog, budget_bytes=T * 32).numpy()  # 4 blocks
    np.testing.assert_array_equal(blocked, whole)
    ref = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    np.testing.assert_array_equal(whole, ref)


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.solver import TorchScheduler

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchScheduler([NodePool()], FakeCloudProvider(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchScheduler([NodePool()], FakeCloudProvider())
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _case(0)
    with pytest.raises(RuntimeError, match="cuda"):
        pk.allowed(sig, tm, th, tn, zone_ok, ct_ok, avail, keys, device="cuda")


_HOST_LIB = []


def _host_tile_lib():
    """The CUDA source compiled by g++ as C++: its __host__ __device__
    tile body run block by block on the CPU (compat_allowed_host)."""
    if not _HOST_LIB:
        cmd = ["g++", "-x", "c++", "-O2", "-shared", "-fPIC", "-std=c++17"]
        path, _ = buildlib.build_shared(ck.SRC, cmd, timeout=300.0)
        lib = ctypes.CDLL(path)
        lib.compat_allowed_host.restype = ctypes.c_int
        lib.compat_allowed_host.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p, ctypes.c_int]
        )
        _HOST_LIB.append(lib)
    return _HOST_LIB[0]


def _host_allowed(planes, catalog, tile, s0=0):
    """The tile body over signature rows [s0, S) of the planes, read in
    place with the planes' pitch → (S - s0, T) bool."""
    W, S = planes.shape
    T = catalog.n_types
    out = torch.full((S - s0, T), 7, dtype=torch.uint8)
    view = planes[:, s0:]
    rc = _host_tile_lib().compat_allowed_host(
        view.data_ptr(), catalog.planes.data_ptr(), catalog.key_off.data_ptr(),
        S - s0, T, W, len(catalog.layout.keys), view.stride(0), catalog.planes.stride(0),
        out.data_ptr(), tile,
    )
    assert rc == 0
    assert set(out.unique().tolist()) <= {0, 1}  # every cell written once
    return out.numpy().astype(bool)


@pytest.mark.parametrize(
    "seed,S,T,widths",
    [
        (0, 1, 1, (1,)),
        (1, 5, 37, (31, 32, 33)),
        (2, 33, 65, (1, 200, 300)),  # S and T one past a tile
        (3, 70, 40, (2001, 7, 64)),  # W spans several 16-word chunks
        (4, 64, 64, (509, 1533, 32)),  # keys end on both tiles' chunk boundaries (words 16, 64)
    ],
)
def test_kernel_tile_body_on_host_matches_reference(seed, S, T, widths):
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _random_inputs(
        np.random.RandomState(seed), S, T, list(widths)
    )
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, "cpu")
    planes = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    ref = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    for tile in (ck.TILE_SMALL, ck.TILE_LARGE):
        np.testing.assert_array_equal(_host_allowed(planes, catalog, tile), ref)


# widths: a key ending exactly on the large tile's 16-word staging chunk
# (509 + 3 bits = 16 words), the slice's 2001-value keys (the second ends
# past the small tile's first 64-word chunk), and W past both rings (the
# large tile's 48 words, the small tile's 128)
_TILE_WIDTHS = (509, 2001, 3, 2001, 4, 29)


@pytest.mark.parametrize("past", [1, 4])
@pytest.mark.parametrize("S", [1, 4, 16, 17, 65])
@pytest.mark.parametrize("tile", [ck.TILE_SMALL, ck.TILE_LARGE])
def test_tile_shapes_on_host_match_reference(tile, S, past):
    """Both tile shapes of the kernel's g++-built body, T one or four past
    the tile (a ragged or a full last 16-byte copy), bit for bit against
    the JAX kernel and the plain version."""
    T = ck.TILES[tile][1] + past
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _random_inputs(
        np.random.RandomState(1000 + S + 7 * tile + past), S, T, list(_TILE_WIDTHS)
    )
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, "cpu")
    assert catalog.layout.offsets[1] == 16 and catalog.layout.width > 128
    planes = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    ref = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    got = _host_allowed(planes, catalog, tile)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ck.allowed_packed_reference(planes, catalog.planes, catalog.layout).numpy())
    if S > 4:  # a row block read in place from the middle of the planes
        np.testing.assert_array_equal(_host_allowed(planes, catalog, tile, s0=4), ref[4:])
    assert planes.stride(0) == -(-S // 4) * 4 and catalog.planes.stride(0) == -(-T // 4) * 4


def _fold_planes(vk):
    """Every has_s/neg_s/valid × overlap pattern on the signature side
    against every has_t/neg_t × pattern on the type side, one key of vk
    values: a signature and a type overlap iff their patterns match."""
    rows_s = [(h, n, v, p) for h in (0, 1) for n in (0, 1) for v in (0, 1) for p in (0, 1)]
    rows_t = [(h, n, p) for h in (0, 1) for n in (0, 1) for p in (0, 1)]
    cols = (0, vk - 1)  # the pattern's value bit: the first or the last
    key = "key-0"
    sig = {
        "valid": np.array([v for _, _, v, _ in rows_s], dtype=bool),
        f"has:{key}": np.array([h for h, _, _, _ in rows_s], dtype=bool),
        f"neg:{key}": np.array([n for _, n, _, _ in rows_s], dtype=bool),
        f"mask:{key}": np.zeros((len(rows_s), vk), dtype=bool),
    }
    tm = {key: np.zeros((len(rows_t), vk), dtype=bool)}
    for s, (_, _, _, p) in enumerate(rows_s):
        sig[f"mask:{key}"][s, cols[p]] = True
    for t, (_, _, p) in enumerate(rows_t):
        tm[key][t, cols[p]] = True
    th = {key: np.array([h for h, _, _ in rows_t], dtype=bool)}
    tn = {key: np.array([n for _, n, _ in rows_t], dtype=bool)}
    S, T = len(rows_s), len(rows_t)
    return (key,), sig, tm, th, tn, np.ones((S, 2), bool), np.ones((S, 1), bool), np.ones((T, 2, 1), bool)


@pytest.mark.parametrize("vk", [2, 29, 30, 31, 32, 64])
def test_flag_fold_exhaustive(vk):
    """The three flag bits reproduce ¬(hs∧ht) ∨ overlap ∨ (ns∧nt) ∧ valid
    for every flag combination × overlap / no overlap, including widths
    whose flag bits spill into a new word (Vk % 32 ∈ {29, 30, 31, 0})."""
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _fold_planes(vk)
    key = keys[0]
    want = (
        sig["valid"][:, None]
        & (
            ~(sig[f"has:{key}"][:, None] & th[key][None, :])
            | (sig[f"mask:{key}"].astype(int) @ tm[key].T.astype(int) > 0)
            | (sig[f"neg:{key}"][:, None] & tn[key][None, :])
        )
    )
    assert want.any() and not want.all()
    ref = np.asarray(allowed_kernel(sig, tm, th, tn, zone_ok, ct_ok, avail, keys))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(
        np.asarray(compat_via_pallas(sig, tm, th, tn, keys, interpret=True)), want
    )
    t = lambda d: pk.to_tensors(d, "cpu")  # noqa: E731
    flag_based = pk.allowed_reference(
        t(sig), t(tm), t(th), t(tn), torch.from_numpy(zone_ok), torch.from_numpy(ct_ok),
        torch.from_numpy(avail), keys,
    ).numpy()
    np.testing.assert_array_equal(flag_based, want)

    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, "cpu")
    assert catalog.layout.words[0] == -(-(vk + 3) // 32)
    planes = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    np.testing.assert_array_equal(
        ck.allowed_packed_reference(planes, catalog.planes, catalog.layout).numpy(), want
    )
    np.testing.assert_array_equal(ck.compat_via_kernel(sig, tm, th, tn, keys, "cpu").numpy(), want)
    for tile in (ck.TILE_SMALL, ck.TILE_LARGE):
        np.testing.assert_array_equal(_host_allowed(planes, catalog, tile), want)


def test_tile_for_picks_by_rows():
    assert ck.tile_for(1) == ck.tile_for(ck.SMALL_S_MAX) == ck.TILE_SMALL
    assert ck.tile_for(ck.SMALL_S_MAX + 1) == ck.tile_for(8192) == ck.TILE_LARGE


def test_planes_pad_storage_to_four_rows():
    """Planes are views into storage padded to 4k rows with zeros, so the
    kernel's 16-byte copies never leave it; the host body refuses planes
    that break the contract."""
    words = np.arange(5 * 3, dtype=np.int32).reshape(5, 3)
    planes = ck.to_planes(words, "cpu")
    assert planes.shape == (3, 5) and planes.stride() == (8, 1)
    np.testing.assert_array_equal(planes.numpy(), words.T)
    storage = planes.as_strided((3, 8), (8, 1))
    assert not storage[:, 5:].any()
    keys, sig, tm, th, tn, zone_ok, ct_ok, avail = _random_inputs(np.random.RandomState(9), 6, 7, [3])
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, "cpu")
    side = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    out = torch.empty((5, 7), dtype=torch.uint8)
    view = side[:, 1:]  # starts 4 bytes in: not 16-byte aligned
    rc = _host_tile_lib().compat_allowed_host(
        view.data_ptr(), catalog.planes.data_ptr(), catalog.key_off.data_ptr(), 5, 7,
        side.shape[0], len(catalog.layout.keys), view.stride(0), catalog.planes.stride(0),
        out.data_ptr(), ck.TILE_SMALL,
    )
    assert rc != 0
