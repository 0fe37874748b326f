"""B8 on the card: ``csrc/disrupt_screen.cu`` against its plain versions.

The three screen entry points, built by nvcc at first use, against the
plain PyTorch versions on the same CUDA tensors, bit for bit: seeded
inputs below and far above 2^24, ragged widths (R past one warp), the
bench configs' shapes, the edges of the kernel's structure (register
chunks, shared-memory tiles, blocks of subset rows), the constructed
near-tie of ``tests/test_torch_disrupt_screen.py`` (also past a tile
boundary and in a later chunk), and no rows. They import nothing
of JAX::

    python -m pytest tests/test_torch_disrupt_cuda.py -m cuda -q

Without CUDA they skip (the kernel has no CPU mode).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch.disruption import screen_kernels as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(seed, N, R, S, hi):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    loads = t(rng.randint(0, hi, (N, R)).astype(np.int32))
    free = t(rng.randint(0, hi, (N, R)).astype(np.int32))
    mid = max(1, min(hi * max(N, 1) // 4, 2**31 - 1))
    fleet = t(rng.randint(0, mid, R).astype(np.int32))
    cap = t(rng.randint(0, mid, R).astype(np.int32))
    masks = t((rng.rand(S, N) < 0.45).astype(np.uint8))
    return masks, loads, free, fleet, cap


CASES = [
    (0, 1, 1, 1, 100), (1, 25, 3, 97, 1 << 18), (2, 25, 3, 97, 1 << 29), (3, 1000, 3, 8193, 1 << 13),
    (4, 1000, 4, 999, 1 << 29), (5, 77, 33, 40, 1 << 20), (6, 130, 70, 300, 1 << 27),
    # the kernel's structure: register chunks of 8 columns (R = 9, 33, 70),
    # N up to 1,024 one tile and past it 512-candidate tiles (N = 4,097; at
    # R = 70 N = 1,001 takes tiles too), 32 subset rows a block (S not a
    # multiple), odd N (unaligned mask rows), the prefix past one tile of
    # shared memory (R = 33 at N = 4,097, R = 70 at N = 1,001)
    (7, 31, 1, 65, 1 << 29), (8, 32, 8, 64, 1 << 20), (9, 33, 9, 129, 1 << 29), (10, 1, 9, 1, 1 << 29),
    (11, 4097, 3, 130, 1 << 29), (12, 1001, 70, 67, 1 << 27), (13, 4097, 33, 65, 1 << 20),
    # the synthetic shapes chip_smoke.py times: the S = 8,193 family cap and
    # R = 8 at config 4's N, sums past 2^24
    (14, 1000, 3, 8193, 1 << 29), (15, 1000, 8, 999, 1 << 29), (16, 4097, 3, 1, 1 << 29),
]


@pytest.mark.parametrize("seed,N,R,S,hi", CASES)
def test_screens_match_plain_versions(cuda, seed, N, R, S, hi):
    masks, loads, free, fleet, cap = (a.to(cuda) for a in _inputs(seed, N, R, S, hi))
    before = sk.launches()
    got = {
        "prefix": sk.screen_prefix(loads, free, fleet, cap),
        "subsets": sk.screen_subsets(masks, loads, free, fleet, cap),
        "singles": sk.screen_singles(loads, free, fleet, cap),
    }
    assert sk.launches() - before == 3
    want = {
        "prefix": sk.prefix_screen_reference(loads, free, fleet, cap),
        "subsets": sk.subset_screen_reference(masks, loads, free, fleet, cap),
        "singles": sk.single_screen_reference(loads, free, fleet, cap),
    }
    for kind in got:
        assert got[kind].device.type == "cuda" and got[kind].dtype == torch.bool
        assert torch.equal(got[kind], want[kind]), kind
        # the same bits as the plain version on the CPU
        cpu = {"prefix": sk.prefix_screen_reference, "singles": sk.single_screen_reference}
        if kind in cpu:
            assert torch.equal(got[kind].cpu(), cpu[kind](loads.cpu(), free.cpu(), fleet.cpu(), cap.cpu()))
    assert torch.equal(got["subsets"].cpu(), sk.subset_screen_reference(
        masks.cpu(), loads.cpu(), free.cpu(), fleet.cpu(), cap.cpu()))


def test_near_tie_follows_candidate_order(cuda):
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)  # noqa: E731
    loads, free = t([[0], [0], [0], [(1 << 24) + 2]]), t([[1 << 24], [1], [1], [0]])
    fleet, cap = t([0]), t([0])
    masks = torch.tensor([[0, 0, 0, 1]], dtype=torch.uint8, device=cuda)
    assert not sk.screen_subsets(masks, loads, free, fleet, cap)[0]
    assert not sk.screen_singles(loads, free, fleet, cap)[3]
    assert not sk.screen_prefix(loads, free, fleet, cap)[3]


@pytest.mark.parametrize("N,R,at,col", [(1000, 3, 511, 2), (1000, 9, 600, 8), (4097, 70, 4000, 69)])
def test_near_tie_at_structure_edges(cuda, N, R, at, col):
    """The near-tie in one column of R, its free values past a tile
    boundary and in the last register chunk: candidate order, so removing
    candidate 0 (load 2^24 + 2) does not fit on any entry."""
    loads = torch.ones((N, R), dtype=torch.int32)
    free = torch.zeros((N, R), dtype=torch.int32)
    loads[:, col] = 0
    loads[0, col] = (1 << 24) + 2
    free[at:at + 3, col] = torch.tensor([1 << 24, 1, 1], dtype=torch.int32)
    fleet = torch.full((R,), 4 * N, dtype=torch.int32)
    fleet[col] = 0
    cap = torch.zeros(R, dtype=torch.int32)
    masks = torch.zeros((1, N), dtype=torch.uint8)
    masks[0, 0] = 1
    loads, free, fleet, cap, masks = (a.to(cuda) for a in (loads, free, fleet, cap, masks))
    assert not sk.screen_subsets(masks, loads, free, fleet, cap)[0]
    assert not sk.screen_prefix(loads, free, fleet, cap)[:at].any()
    assert not sk.screen_singles(loads, free, fleet, cap)[0]


def test_mask_bytes_other_than_one(cuda):
    """Any byte that is not 0 masks its candidate, as in the plain version."""
    masks, loads, free, fleet, cap = (a.to(cuda) for a in _inputs(17, 1000, 9, 130, 1 << 20))
    masks = masks * torch.randint(1, 256, masks.shape, generator=torch.Generator().manual_seed(17)).to(cuda, torch.uint8)
    assert int(masks.max()) > 1
    got = sk.screen_subsets(masks, loads, free, fleet, cap)
    assert torch.equal(got, sk.subset_screen_reference(masks, loads, free, fleet, cap))
    assert torch.equal(got, sk.subset_screen_reference((masks != 0).to(torch.uint8), loads, free, fleet, cap))


def test_no_rows_and_bad_arguments(cuda):
    z = torch.zeros((0, 3), dtype=torch.int32, device=cuda)
    r = torch.zeros(3, dtype=torch.int32, device=cuda)
    before = sk.launches()
    assert sk.screen_prefix(z, z, r, r).shape == (0,)
    assert sk.screen_subsets(torch.zeros((0, 0), dtype=torch.uint8, device=cuda), z, z, r, r).shape == (0,)
    assert sk.launches() == before
    with pytest.raises(ValueError):
        sk.screen_prefix(z.to(torch.int64), z, r, r)
    with pytest.raises(ValueError):
        sk.screen_subsets(torch.zeros((1, 0), dtype=torch.float32, device=cuda), z, z, r, r)
