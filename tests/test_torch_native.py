"""The port's C++ packer ≡ the JAX package's pack scans.

Random size-sorted jobs (with sentinel padding pods that fit no frontier
point, per-node pod caps and several open-slot bounds) must give the
node assignments and counts of the JAX ``ffd_pack`` ``lax.scan`` (jitted
on the CPU, ``k_open`` static); the cheapest-type scan must equal the
JAX numpy scan, and the Pareto frontier and the usage segment-sum must
agree too. The port's library is built by ``g++`` into its own build
directory.

None of these comparisons needs the JAX package's own shared library,
whose in-place build can race between test processes and leave a
process that lost the race without it for good. Tests that do want that
library (the plan-identity files, whose JAX reference must take its
default native route) go through ``reference_native``, which reloads it
once the file is complete and fails loudly if it still does not load.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from karpenter_core_tpu import native as ref_native
from karpenter_core_tpu.solver import pack as ref_pack
from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch import native as port_native
from karpenter_core_tpu_torch.solver import pack as port_pack

# how long a test waits for another process to finish writing the JAX
# package's library before it fails
REFERENCE_LOAD_WAIT_S = 300.0


def reference_native(monkeypatch) -> None:
    """Make the JAX package's native packer load in this process, so its
    solver runs its default route (native K = 1024). A process that read
    the library while another was still writing it has latched
    ``_tried``; reset it through ``monkeypatch`` and retry until the load
    succeeds, else fail."""
    deadline = time.monotonic() + REFERENCE_LOAD_WAIT_S
    while ref_native.load() is None:
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native packer does not load; its reference route is unavailable")
        time.sleep(0.5)
        monkeypatch.setattr(ref_native, "_tried", False)
        monkeypatch.setattr(ref_native, "_lib", None)


def lose_build_race(monkeypatch) -> None:
    """The state of a process that lost the JAX library's build race."""
    monkeypatch.setattr(ref_native, "_tried", True)
    monkeypatch.setattr(ref_native, "_lib", None)
    assert not ref_native.available()


def _job(rng, P, R, F):
    reqs = rng.randint(1, 50, size=(P, R)).astype(np.int32)
    reqs = reqs[np.lexsort((-reqs[:, 1], -reqs[:, 0]))]
    frontier = port_pack.pareto_frontier(rng.randint(40, 200, size=(F, R)).astype(np.int32))
    return reqs, frontier


def _scan(reqs, frontier, cap, k_open):
    """The JAX package's device scan, jitted on the CPU."""
    ids, count = ref_pack.ffd_pack(reqs, frontier, np.int32(cap), k_open=k_open)
    return np.asarray(ids), int(count)


def _check_ffd(seed):
    rng = np.random.RandomState(seed)
    R = int(rng.randint(2, 5))
    reqs, frontier = _job(rng, int(rng.randint(1, 400)), R, int(rng.randint(1, 12)))
    # sentinel padding: pods larger than every frontier point emit -1
    padded, pfront, P = port_pack.pad_for_pack(reqs, frontier)
    ref_padded, ref_pfront, ref_P = ref_pack.pad_for_pack(reqs, frontier)
    np.testing.assert_array_equal(padded, ref_padded)
    np.testing.assert_array_equal(pfront, ref_pfront)
    assert P == ref_P
    for k_open in (1, 4, 16, 1024):
        for cap in (2**31 - 1, 3):
            ids, count = port_native.ffd_pack_native(padded, pfront, cap, k_open=k_open)
            rids, rcount = _scan(padded, pfront, cap, k_open)
            np.testing.assert_array_equal(ids, rids)
            assert count == rcount
            assert (ids[P:] == -1).all()


def _check_cheapest(seed, monkeypatch):
    rng = np.random.RandomState(100 + seed)
    R = 3
    reqs, frontier = _job(rng, 300, R, 8)
    ids, count = port_native.ffd_pack_native(reqs, frontier, 2**31 - 1, k_open=16)
    rids, rcount = _scan(reqs, frontier, 2**31 - 1, 16)
    np.testing.assert_array_equal(ids, rids)
    assert count == rcount
    usage = port_pack.node_usage_from_assignment(reqs, ids, count)
    np.testing.assert_array_equal(usage, ref_pack.node_usage_from_assignment(reqs, ids, count))
    alloc = rng.randint(20, 400, size=(30, R)).astype(np.int32)
    prices = np.round(rng.rand(30) * 10, 1)  # ties on purpose
    with monkeypatch.context() as m:
        # the JAX scan's numpy route: the one that never needs its library
        lose_build_race(m)
        ref_types = ref_pack.assign_cheapest_types(usage, alloc, prices)
    np.testing.assert_array_equal(port_native.cheapest_types_native(usage, alloc, prices), ref_types)
    np.testing.assert_array_equal(port_pack.assign_cheapest_types(usage, alloc, prices), ref_types)
    np.testing.assert_array_equal(
        port_pack.pareto_frontier(alloc), ref_pack.pareto_frontier(alloc)
    )


def _check_batch_pack():
    rng = np.random.RandomState(7)
    jobs = []
    for _ in range(5):
        reqs, frontier = _job(rng, int(rng.randint(1, 300)), 3, 6)
        jobs.append((reqs, frontier, np.int32(2**31 - 1)))
    ours = port_pack.batch_pack(jobs)
    assert len(ours) == len(jobs)
    for (ids, count), (reqs, frontier, cap) in zip(ours, jobs):
        # the K the JAX package's engine="auto" route packs with
        rids, rcount = _scan(reqs, frontier, cap, min(ref_pack.NATIVE_K_OPEN, reqs.shape[0]))
        np.testing.assert_array_equal(ids, rids)
        assert count == rcount


@pytest.mark.parametrize("seed", range(6))
def test_ffd_pack_native_matches_reference(seed):
    _check_ffd(seed)


@pytest.mark.parametrize("seed", range(4))
def test_cheapest_types_and_usage_match_reference(seed, monkeypatch):
    _check_cheapest(seed, monkeypatch)


def test_batch_pack_matches_reference_native_route():
    _check_batch_pack()


def test_native_comparisons_pass_after_lost_build_race(monkeypatch):
    """A process whose JAX library lost its build race still holds the
    port's packer against the JAX scans."""
    lose_build_race(monkeypatch)
    _check_ffd(0)
    _check_cheapest(0, monkeypatch)
    _check_batch_pack()
    assert not ref_native.available()


def test_reference_native_recovers_lost_build_race(monkeypatch):
    """``reference_native`` reloads the JAX library after a lost race, so
    the plan-identity references take their native route."""
    lose_build_race(monkeypatch)
    reference_native(monkeypatch)
    assert ref_native.available()
    rng = np.random.RandomState(3)
    reqs, frontier = _job(rng, 200, 3, 5)
    ids, count = ref_native.ffd_pack_native(reqs, frontier, 2**31 - 1, k_open=1024)
    ours = port_native.ffd_pack_native(reqs, frontier, 2**31 - 1, k_open=1024)
    np.testing.assert_array_equal(ours[0], ids)
    assert ours[1] == count


def test_library_builds_into_port_build_dir():
    path, _ = port_native.build()
    assert os.path.dirname(path) == buildlib.BUILD_DIR
    assert path == buildlib.library_path(port_native.SRC, port_native.GXX_CMD)
    assert os.path.exists(path)
    # never next to the source (clear of the JAX package's stale-build glob)
    assert not any(n.endswith(".so") for n in os.listdir(os.path.dirname(port_native.SRC)))
