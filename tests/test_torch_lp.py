"""The port's pack backends and LP relaxation ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch.solver.backends`` (``ffd | lp | auto``,
``KARPENTER_TORCH_PACK_BACKEND``), ``backends/lp.py`` with its dual
ascent (``csrc/dual_ascent.cu`` on the card, ``dual_ascent_reference``
here), ``plancost.py``, ``calibrate.py``'s LP routing and the solver's
cost guard, held to the JAX package on the same inputs:

- ``dual_ascent_reference`` against ``_dual_ascent_kernel`` on seeded and
  bench config 10 inputs: t* and has_fit equal, w within ``W_RTOL``; the
  kernel's step functions (``dual_ascent.cu`` built by g++) equal to the
  plain version bit for bit;
- ``relax`` bounds within ``BOUND_RTOL``;
- all eleven config 10 shapes under ``ffd``, ``lp`` and ``auto`` (the
  routing threshold pinned): plan stream digest, node count, $/hr and pod
  errors identical to ``TPUScheduler``, ``last_pack_stats`` equal (floats
  within ``BOUND_RTOL``), the refinement trajectory and the branch table
  equal, and each shape's $/hr equal to the reference values
  ``chip_smoke.py`` holds;
- the merge's cost guard on a two-record case, plancost, backend
  selection, job tokens and the typo fallback;
- the scenarios of ``tests/test_backends.py`` and ``tests/test_lp_optim.py``
  that touch only what the port has, run from their own source with the
  package name and the knob prefix swapped (their own assertions then
  hold the port).

Tolerances, and why: the route's sums run in axis order on both sides,
but XLA fuses the JAX step's elementwise chain (FMA contraction) and
picks its own order for ``route.T @ reqs``, so after 160 multiplicative
steps the weights differ by about 2e-6 relative on these inputs: ``W_RTOL
= 1e-5``. The host re-certifies the bound from w in float64, so bounds
inherit that: ``BOUND_RTOL = 1e-5``. Plans, t* and has_fit are compared
exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import inspect
import json
import os
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_core_tpu.solver import TPUScheduler
from karpenter_core_tpu.solver import backends as ref_backends
from karpenter_core_tpu.solver.backends import lp as ref_lp
from karpenter_core_tpu_torch import buildlib
from karpenter_core_tpu_torch.solver import TorchScheduler
from karpenter_core_tpu_torch.solver import backends as port_backends
from karpenter_core_tpu_torch.solver import calibrate as port_calibrate
from karpenter_core_tpu_torch.solver import incremental as port_incremental
from karpenter_core_tpu_torch.solver import pack as port_pack
from karpenter_core_tpu_torch.solver import plancost as port_plancost
from karpenter_core_tpu_torch.solver.backends import lp as port_lp
from test_torch_existing import errors_by_index, plan_stream
from test_torch_native import reference_native

W_RTOL = 1e-5
BOUND_RTOL = 1e-5
REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
PORT = "karpenter_core_tpu_torch"


def _smoke(package: str):
    src = (REPO / "chip_smoke.py").read_text()
    if package != PORT:
        src = src.replace(PORT, package)
    module = importlib.util.module_from_spec(importlib.util.spec_from_loader(f"smoke_{package}", loader=None))
    exec(compile(src, str(REPO / "chip_smoke.py"), "exec"), module.__dict__)
    return module


SMOKE = _smoke(PORT)
REF_SMOKE = _smoke("karpenter_core_tpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions step through many small ops: one intra-op
    thread runs them as fast and leaves the other test workers their
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_planes(monkeypatch):
    """Both packages' relax memos and backend singletons dropped, the
    reference's job memo off, the port's calibration cleared."""
    monkeypatch.setenv("KARPENTER_TPU_INCREMENTAL", "0")
    ref_backends.reset_for_tests()
    port_backends.reset_for_tests()
    port_calibrate.reset_for_tests()
    yield
    ref_backends.reset_for_tests()
    port_backends.reset_for_tests()
    port_calibrate.reset_for_tests()


# -- the dual ascent --------------------------------------------------------------

_HOST = []


def _host():
    if not _HOST:
        lib = buildlib.host_library("dual_ascent.cu")
        lib.dual_ascent_host.restype = ctypes.c_int
        lib.dual_ascent_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 3
        lib.dual_ascent_plan.restype = ctypes.c_int
        lib.dual_ascent_plan.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        _HOST.append(lib)
    return _HOST[0]


def _pow2(n):
    return max(8, 1 << max(0, n - 1).bit_length())


def _seeded(seed):
    """Padded inputs as ``relax`` pads them (S, T to powers of two ≥ 8)."""
    rng = np.random.RandomState(100 + seed)
    S, T, R = int(rng.randint(1, 40)), int(rng.randint(1, 300)), int(rng.randint(1, 6))
    Sp, Tp = _pow2(S), _pow2(T)
    reqs = np.zeros((Sp, R), np.float32)
    reqs[:S] = rng.randint(1, 200, size=(S, R))
    counts = np.zeros(Sp, np.float32)
    counts[:S] = rng.randint(1, 50, size=S)
    alloc = np.zeros((Tp, R), np.float32)
    alloc[:T] = rng.randint(100, 4000, size=(T, R))
    prices = np.full(Tp, np.float32(1e12), np.float32)
    prices[:T] = rng.rand(T) * 10 + 0.5
    valid = np.zeros(Tp, bool)
    valid[:T] = rng.rand(T) < 0.9
    w0 = (1.0 / np.maximum(alloc, 1.0)).astype(np.float32)
    return reqs, counts, alloc, prices, valid, w0


def _config10_inputs():
    """Every relax call of the config 10 lp solves: the padded inputs the
    port hands ``dual_ascent``, with their iteration budgets."""
    calls = []
    real = port_lp.dual_ascent

    def spy(*args):
        calls.append(tuple(a.numpy().copy() for a in args[:6]) + (args[6],))
        return real(*args)

    port_lp.dual_ascent = spy
    try:
        os.environ["KARPENTER_TORCH_PACK_BACKEND"] = "lp"
        for _, catalog, pods in SMOKE.config10_shapes():
            provider, pool = _provider(SMOKE, catalog)
            TorchScheduler([pool], provider, device="cpu").solve(pods)
    finally:
        port_lp.dual_ascent = real
        os.environ.pop("KARPENTER_TORCH_PACK_BACKEND", None)
    return calls


def _compare_ascent(args, iters, against_jax=True):
    pw, pt, ph = (t.numpy() for t in port_lp.dual_ascent_reference(*map(torch.from_numpy, args), iters))
    if against_jax:
        rw, rt, rh = map(np.asarray, ref_lp._dual_ascent_kernel(*map(jnp.asarray, args), iters))
        assert np.array_equal(pt, rt) and np.array_equal(ph, rh)
        np.testing.assert_allclose(pw, rw, rtol=W_RTOL, atol=0)
    got = _host_ascent(args, iters)
    assert all(np.array_equal(a, b) for a, b in zip(got, (pw, pt, ph)))
    return pw, pt, ph


def _host_ascent(args, iters):
    """The kernel's g++-built steps → (w, t*, has_fit)."""
    Sp, R = args[0].shape
    Tp = args[2].shape[0]
    hw, ht, hh = np.empty((Tp, R), np.float32), np.empty(Sp, np.int32), np.empty(Sp, np.uint8)
    # the inputs as the C function reads them, held here while it runs
    held = [np.ascontiguousarray(a, dtype=np.uint8 if i == 4 else np.float32) for i, a in enumerate(args[:6])]
    rc = _host().dual_ascent_host(
        *(a.ctypes.data for a in held), Sp, Tp, R, iters, hw.ctypes.data, ht.ctypes.data, hh.ctypes.data,
    )
    assert rc == 0
    return hw, ht, hh.astype(bool)


@pytest.mark.parametrize("seed", range(12))
def test_dual_ascent_matches_reference_on_seeded_inputs(seed):
    _compare_ascent(_seeded(seed), 160)


def test_dual_ascent_matches_reference_on_config10_inputs():
    calls = _config10_inputs()
    assert len(calls) == 33  # 11 shapes x (1 relax + 2 refinement re-ascents)
    assert sorted({c[6] for c in calls}) == [40, 160]
    for *args, iters in calls:
        _compare_ascent(tuple(args), iters)


def _edge_inputs(seed, S, T, R, tied=False, no_fit=False):
    """Unpadded inputs built to break a parallel argmin. ``tied`` repeats
    three type rows (allocatable and price) over the catalog, so costs
    tie exactly between types that different threads and warps own, and
    the lowest index must win; ``no_fit`` gives one signature a row above
    every type and another one that fits only an invalid type."""
    rng = np.random.RandomState(300 + seed)
    reqs = rng.randint(1, 200, size=(S, R)).astype(np.float32)
    counts = rng.randint(1, 50, size=S).astype(np.float32)
    alloc = rng.randint(100, 4000, size=(T, R)).astype(np.float32)
    prices = (rng.rand(T) * 10 + 0.5).astype(np.float32)
    valid = rng.rand(T) < 0.9
    if tied:
        kinds = rng.randint(0, 3, size=T)
        alloc, prices = alloc[kinds], prices[kinds]
    if no_fit:
        reqs[S // 2] = 5000.0
        reqs[S // 3] = 4500.0
        alloc[T - 1], valid[T - 1] = 6000.0, False
    w0 = (1.0 / np.maximum(alloc, 1.0)).astype(np.float32)
    return reqs, counts, alloc, prices, valid, w0


# (seed, S, T, R, iters, options): exact ties across threads and warps;
# fit bits in more than one word (33, 64) and past the register
# path (100); T not a multiple of the thread count; one and sixteen
# axes; signatures that fit nothing; no iteration; a work area past
# shared memory. The 100-signature tie is held port against port only:
# at its iteration 34 two types of different rows cost the same to
# within float32 rounding, and XLA's dot (its own summation order) routes
# one signature to the other of the two (ROADMAP.md, C).
DUAL_EDGE_CASES = {
    "tied-rows-2048": (0, 16, 2048, 3, 160, dict(tied=True)),
    "tied-rows-1500": (1, 12, 1500, 2, 160, dict(tied=True)),
    "tied-rows-100-signatures": (2, 100, 256, 3, 40, dict(tied=True, against_jax=False)),
    "signatures-33": (3, 33, 300, 3, 160, {}),
    "signatures-64": (4, 64, 700, 4, 160, {}),
    "types-1000": (5, 9, 1000, 3, 160, {}),
    "axes-1": (6, 20, 500, 1, 160, {}),
    "axes-16": (7, 24, 300, 16, 160, {}),
    "fits-nothing": (8, 10, 200, 3, 160, dict(no_fit=True)),
    "iters-0": (9, 16, 2048, 3, 0, {}),
    "work-area-in-device-memory": (10, 64, 2048, 12, 40, {}),
}


@pytest.mark.parametrize("case", sorted(DUAL_EDGE_CASES))
def test_dual_ascent_edge_cases(case):
    """The JAX kernel, the plain version and the kernel's host build on
    inputs built to break a parallel argmin: routes equal, w within
    W_RTOL of JAX and bit-equal between the port's two."""
    seed, S, T, R, iters, options = DUAL_EDGE_CASES[case]
    args = _edge_inputs(seed, S, T, R, tied=options.get("tied", False), no_fit=options.get("no_fit", False))
    pw, pt, ph = _compare_ascent(args, iters, against_jax=options.get("against_jax", True))
    reqs, counts, alloc, prices, valid, w0 = args
    if options.get("tied"):
        # some route's winner has a valid twin at a higher index: a tie
        # broken by index, not a unique minimum
        twins = [
            ((alloc == alloc[t]).all(1) & (prices == prices[t]) & (pw == pw[t]).all(1) & valid)[t + 1 :].any()
            for t in pt[ph]
        ]
        assert any(twins)
    if options.get("no_fit"):
        assert not ph[S // 2] and not ph[S // 3] and pt[S // 2] == 0 and ph.sum() == S - 2
    if iters == 0:
        assert np.array_equal(pw, w0)
    plan = port_lp.dual_ascent_plan(S, T, R, lib=_host())
    assert plan["global"] == (case == "work-area-in-device-memory")
    assert plan["regs"] == (R <= 4 and S <= 64 and plan["types"] <= 2)


@pytest.mark.parametrize("seed", range(4))
def test_relax_bound_matches_reference(seed):
    rng = np.random.RandomState(seed)
    S, T, R = 6 + seed, 30 + 7 * seed, 3
    reqs = rng.randint(1, 100, size=(S, R)).astype(np.float64)
    counts = rng.randint(1, 20, size=S).astype(np.float64)
    alloc = rng.randint(200, 2000, size=(T, R)).astype(np.float64)
    prices = rng.rand(T) * 5 + 0.1
    prices[::5] = float(port_lp._BIG)  # unavailable types
    w0 = None if seed % 2 == 0 else rng.rand(T, R) + 0.5
    rt, rh, rb, rw = ref_lp.relax(reqs, counts, alloc, prices, 160, w0=w0)
    pt, ph, pb, pw = port_lp.relax(reqs, counts, alloc, prices, 160, w0=w0, device="cpu")
    assert np.array_equal(pt, rt) and np.array_equal(ph, rh)
    assert pb == pytest.approx(rb, rel=BOUND_RTOL)
    np.testing.assert_allclose(pw, rw, rtol=W_RTOL)
    reqs_rows = np.repeat(reqs, counts.astype(int), axis=0)
    assert port_lp.dual_bound(reqs_rows, alloc, prices, device="cpu") == pytest.approx(
        ref_lp.dual_bound(reqs_rows, alloc, prices), rel=BOUND_RTOL
    )


def test_dual_ascent_kernel_refuses_bad_arguments():
    args = _seeded(0)
    Sp, R = args[0].shape
    Tp = args[2].shape[0]
    hw, ht, hh = np.empty((Tp, R), np.float32), np.empty(Sp, np.int32), np.empty(Sp, np.uint8)
    for S, T, RR, iters in ((0, Tp, R, 8), (Sp, 0, R, 8), (Sp, Tp, 17, 8), (Sp, Tp, R, -1)):
        assert _host().dual_ascent_host(
            *(a.ctypes.data for a in args[:4]), args[4].astype(np.uint8).ctypes.data, args[5].ctypes.data,
            S, T, RR, iters, hw.ctypes.data, ht.ctypes.data, hh.ctypes.data,
        ) != 0
    with pytest.raises(RuntimeError, match="cuda"):
        port_lp.relax(np.ones((2, 2)), np.ones(2), np.ones((3, 2)) * 4, np.ones(3), 8)


# -- bench config 10 whole, both packages ----------------------------------------------


def _provider(module, catalog):
    pkg = "karpenter_core_tpu_torch" if module is SMOKE else "karpenter_core_tpu"
    fake = importlib.import_module(f"{pkg}.cloudprovider.fake")
    NodePool = importlib.import_module(f"{pkg}.apis.nodepool").NodePool
    provider = fake.FakeCloudProvider()
    provider.instance_types = list(catalog)
    pool = NodePool()
    pool.metadata.name = "default"
    return provider, pool


def plan_sha256(res) -> str:
    return hashlib.sha256(json.dumps(plan_stream(res)).encode()).hexdigest()


def _strip_ms(rows):
    return [{k: v for k, v in r.items() if k != "ms"} for r in rows]


def _same_rows(rows, ref_rows):
    assert len(rows) == len(ref_rows)
    for a, b in zip(rows, ref_rows):
        assert a.keys() == b.keys()
        for k in a:
            if k == "bound":
                assert a[k] == pytest.approx(b[k], rel=BOUND_RTOL)
            else:
                assert a[k] == b[k], (k, a, b)


SHAPES = [name for name, _, _ in SMOKE.config10_shapes()]


@pytest.mark.parametrize("backend", ["ffd", "lp", "auto"])
def test_config10_matches_reference(monkeypatch, backend):
    reference_native(monkeypatch)
    monkeypatch.setenv("KARPENTER_TPU_PACK_BACKEND", backend)
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", backend)
    monkeypatch.setenv("KARPENTER_TPU_LP_MIN_WORK", "1")
    monkeypatch.setenv("KARPENTER_TORCH_LP_MIN_WORK", "1")
    saved = {}
    for (name, ref_cat, ref_pods), (pname, cat, pods) in zip(REF_SMOKE.config10_shapes(), SMOKE.config10_shapes()):
        assert name == pname
        provider, pool = _provider(REF_SMOKE, ref_cat)
        ref_solver = TPUScheduler([pool], provider)
        ref = ref_solver.solve(ref_pods)
        provider, pool = _provider(SMOKE, cat)
        solver = TorchScheduler([pool], provider, device="cpu")
        res = solver.solve(pods)
        assert plan_sha256(res) == plan_sha256(ref), name
        assert (res.node_count, res.pods_scheduled, res.total_price) == (
            ref.node_count, ref.pods_scheduled, ref.total_price
        ), name
        assert errors_by_index(res, pods) == errors_by_index(ref, ref_pods)
        got, want = dict(solver.last_pack_stats), dict(ref_solver.last_pack_stats)
        assert got.keys() == want.keys(), name
        for k in got:
            if isinstance(want[k], float):
                assert got[k] == pytest.approx(want[k], rel=BOUND_RTOL), (name, k)
            else:
                assert got[k] == want[k], (name, k)
        if backend != "ffd":
            lp = port_backends.get_backend(backend)
            ref_lp_backend = ref_backends.get_backend(backend)
            if backend == "auto":
                lp, ref_lp_backend = lp._lp, ref_lp_backend._lp
            _same_rows(_strip_ms(lp.last_refine_trajectory), _strip_ms(ref_lp_backend.last_refine_trajectory))
            _same_rows(lp.last_branch_table, ref_lp_backend.last_branch_table)
            assert got["ascent_iters"] == 240 and got["refine_rounds"] == 2
        saved[name] = round(res.total_price, 4)
    column = 0 if backend == "ffd" else 1
    assert saved == {k: v[column] for k, v in SMOKE.CONFIG10_REFERENCE.items()}
    if backend == "lp":
        ffd = sum(v[0] for k, v in SMOKE.CONFIG10_REFERENCE.items() if k != "linear-control")
        lp = sum(v[1] for k, v in SMOKE.CONFIG10_REFERENCE.items() if k != "linear-control")
        assert round((ffd - lp) / ffd * 100.0, 1) == SMOKE.CONFIG10_SAVING_PCT


def test_config10_checks_hold_and_refuse(monkeypatch):
    """chip_smoke's phase-12 check on the port's own config 10 rows, and
    its refusal of rows that break lp <= ffd, bound <= cost and the
    reference values."""
    rows = SMOKE.config10_rows("cpu")
    SMOKE.check_config10(rows)
    for fault in ("lp-above-ffd", "bound-above-cost", "price-drift", "pods-differ"):
        broken = [dict(r) for r in rows]
        r = broken[0]
        if fault == "lp-above-ffd":
            r["lp"] = r["ffd"] + 1.0
        elif fault == "bound-above-cost":
            r["bound"] = r["lp"] + 1.0
        elif fault == "price-drift":
            r["ffd"] = r["ffd"] + 0.01
        else:
            r["lp_pods"] = r["ffd_pods"] - 1
        with pytest.raises(SystemExit):
            SMOKE.check_config10(broken)


# -- the merge's cost guard -------------------------------------------------------------


def test_merge_cost_guard_on_two_records():
    """Two one-pod nodes of two signature groups, each cheapest on the
    small type: the node-count-driven merge folds them onto the big type
    ($10 for $2); once either record is an LP-chosen partition's the
    guard refuses that merge and leaves the record untouched."""
    fake = importlib.import_module(f"{PORT}.cloudprovider.fake")
    from karpenter_core_tpu_torch.cloudprovider.types import Offering

    provider, pool = _provider(
        SMOKE,
        [
            fake.new_instance_type("big", {"cpu": "8", "memory": "16Gi", "pods": "110"},
                                   offerings=[Offering("on-demand", "test-zone-1", 10.0)]),
            fake.new_instance_type("small", {"cpu": "4", "memory": "8Gi", "pods": "110"},
                                   offerings=[Offering("on-demand", "test-zone-1", 1.0)]),
        ],
    )
    pods = [SMOKE.pending_pod(f"p-{i}", "3", "6Gi") for i in range(2)]
    pods[1].spec.node_selector = {"topology.kubernetes.io/zone": "test-zone-1"}
    solver = TorchScheduler([pool], provider, device="cpu")
    captured = []
    real = solver._merge_and_emit

    def spy(records, pods_, result):
        captured.extend(dict(r, members=list(r["members"])) for r in records)
        return real(records, pods_, result)

    solver._merge_and_emit = spy
    res = solver.solve(pods)
    assert [p.instance_type.name for p in res.node_plans] == ["big"]  # unguarded: merged
    assert len(captured) == 2
    m, r = captured
    assert solver._record_price(dict(m)) == solver._record_price(dict(r)) == 1.0
    assert solver._merge_pair_exact(dict(m, members=list(m["members"])), dict(r), pods)
    for side in ("m", "r"):
        a, b = dict(m, members=list(m["members"])), dict(r)
        (a if side == "m" else b)["_cost_guard"] = True
        assert not solver._merge_pair_exact(a, b, pods)
        assert a["members"] == m["members"] and "_price" in a  # refused: untouched but priced


# -- plancost, selection, tokens -----------------------------------------------------------


def test_plancost_functions(monkeypatch):
    from karpenter_core_tpu.solver import plancost as ref_plancost

    assert port_plancost.optimality_gap(110.0, 100.0) == pytest.approx(0.1)
    assert port_plancost.optimality_gap(90.0, 100.0) == 0.0
    assert port_plancost.optimality_gap(1.0, 0.0) is None
    for raw in ("", "price=1,headroom=0.5,disruption=0.25", "price=-3,bogus,spread=x"):
        monkeypatch.setenv("KARPENTER_TPU_COST_WEIGHTS", raw)
        monkeypatch.setattr(port_plancost, "COST_WEIGHTS", raw)
        assert port_plancost.cost_weights() == ref_plancost.cost_weights()
        assert port_plancost.weights_token() == ref_plancost.weights_token()
        assert port_plancost.weights_active() == ref_plancost.weights_active()
    monkeypatch.setattr(port_plancost, "COST_WEIGHTS", "")
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", "lp")
    _, catalog, pods = SMOKE.config10_shapes()[0]
    provider, pool = _provider(SMOKE, catalog)
    solver = TorchScheduler([pool], provider, device="cpu")
    res = solver.solve(pods)
    assert port_plancost.fleet_cost(res.node_plans) == pytest.approx(res.total_price)
    block = port_plancost.cost_block(res, catalog, device="cpu")
    assert block["lp_bound_per_hr"] <= block["plan_cost_per_hr"]
    assert block["opt_gap_pct"] is not None and block["opt_gap_pct"] >= 0
    report = port_plancost.pareto_report(res.node_plans)
    assert report == solver.last_pareto and report["price_per_hr"] == round(res.total_price, 4)
    pod = pods[0]
    pod.metadata.annotations["controller.kubernetes.io/pod-deletion-cost"] = "20"
    pod.metadata.resource_version = "7"
    pod.spec.priority = 1000
    assert port_plancost.pod_eviction_cost(pod) == pytest.approx(1.0 + 2.0 + 0.001)


def test_backend_selection_tokens_and_typo_fallback(monkeypatch):
    assert [port_backends.get_backend(n).name for n in ("ffd", "lp", "auto")] == ["ffd", "lp", "auto"]
    with pytest.raises(ValueError):
        port_backends.get_backend("nope")
    monkeypatch.delenv("KARPENTER_TORCH_PACK_BACKEND", raising=False)
    assert port_backends.active_backend().name == "ffd"
    for raw, want in (("lp", "lp"), (" AUTO ", "auto"), ("typo", "ffd"), ("", "ffd")):
        monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", raw)
        assert port_backends.active_backend().name == want
    lp = port_backends.get_backend("lp")
    assert lp.job_token() == ("lp", 160, 2, 2, (1.0, 0.0, 0.0, 0.0))
    assert port_backends.get_backend("ffd").job_token() == ref_backends.get_backend("ffd").job_token()
    assert lp.job_token() == ref_backends.get_backend("lp").job_token()
    assert (port_lp.LP_ITERS, port_lp.LP_REFINE_ROUNDS, port_lp.LP_BRANCH_K) == (160, 2, 2)
    assert port_incremental.cache_cap("lprelax") == 512
    for knob, value, field in (("LP_ITERS", 32, 1), ("LP_REFINE_ROUNDS", 4, 2), ("LP_BRANCH_K", 0, 3)):
        with monkeypatch.context() as m:
            m.setattr(port_lp, knob, value)
            assert lp.job_token()[field] == value
    monkeypatch.setenv("KARPENTER_TORCH_LP_MIN_WORK", "4096")
    assert port_backends.get_backend("auto").job_token(device="cpu")[:2] == ("auto", 4096)
    monkeypatch.setenv("KARPENTER_TORCH_LP_MIN_WORK", "oops")  # falls through to the calibration
    cal = port_calibrate.lp_calibration("cpu")
    assert port_calibrate.lp_min_job_work("cpu") == cal["lp_min_job_work"]
    assert port_calibrate._LP_MIN_CLAMP[0] <= cal["lp_min_job_work"] <= port_calibrate._LP_MIN_CLAMP[1]
    assert cal["device"] == "cpu" and cal["lp_relax_floor_ms"] > 0 and cal["pack_ns_per_unit"] > 0


def test_calibration_raises_on_a_kernel_failure(monkeypatch):
    """A failed build or launch inside the calibration raises, and
    nothing is cached: ``auto`` never routes on a threshold measured
    around a broken kernel."""

    def broken(*_a, **_kw):
        raise RuntimeError("dual_ascent: launch failed")

    monkeypatch.setattr(port_lp, "relax", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        port_calibrate.lp_calibration("cpu")
    assert "cpu" not in port_calibrate._LP_CAL
    monkeypatch.delenv("KARPENTER_TORCH_LP_MIN_WORK", raising=False)
    with pytest.raises(RuntimeError, match="launch failed"):
        port_backends.get_backend("auto").job_token(device="cpu")


def test_relax_planes_are_per_device(monkeypatch):
    """A CPU solve fills the CPU plane only: the card's plane stays empty,
    so a card solve after it still runs its own ascent."""
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", "lp")
    # the cold pipeline: the warm state would replay the second solve
    # whole instead of packing it through the relaxation memo
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    _, catalog, pods = SMOKE.config10_shapes()[0]
    provider, pool = _provider(SMOKE, catalog)
    solver = TorchScheduler([pool], provider, device="cpu")
    solver.solve(pods)
    assert len(port_lp.export_relax_plane("cpu")) == 3
    assert port_lp._RELAX_PLANES.keys() == {"cpu"}
    solver.solve(pods)
    assert solver.last_pack_stats["ascent_iters"] == 0
    assert solver.last_cache_stats["hits"]["lprelax"] == 3
    plane = port_lp.relax_plane("cpu")
    assert port_lp.relax_plane(torch.device("cpu")) is plane


def test_stateful_jobs_stay_on_ffd(monkeypatch):
    """Jobs whose width is not the alloc width (port columns) keep FFD's
    partition under lp and auto, as the reference's backends do."""
    monkeypatch.setenv("KARPENTER_TORCH_LP_MIN_WORK", "1")
    reqs = np.array([[2, 2, 1], [2, 2, 1], [1, 1, 0]], np.int32)
    frontier = np.array([[8, 8, 1]], np.int32)
    meta = {"alloc": np.array([[8, 8]], np.int32), "viable_idx": np.array([0])}
    for name in ("lp", "auto"):
        backend = port_backends.get_backend(name)
        (ids, n), = backend.pack_jobs([(reqs, frontier, np.int32(110))], [meta], device="cpu")
        (fids, fn), = port_pack.batch_pack([(reqs, frontier, np.int32(110))])
        assert np.array_equal(ids, fids) and n == fn == 2
        assert backend.last_job_flags == [False]


# -- the JAX tests' own scenarios, against the port ---------------------------------------

MIRRORED = {
    "test_backends.py": [
        ("TestBackendSeam", "test_registry_and_env_switch", {}),
        ("TestBackendSeam", "test_job_tokens_distinct_and_config_sensitive", {}),
        *[("TestPlanCostAccounting", t, {"seed": s, "backend": b})
          for t in ("test_fleet_cost_equals_sum_of_offering_prices", "test_relaxation_bound_never_exceeds_plan_cost")
          for s in (0, 7, 42) for b in ("ffd", "lp")],
        ("TestPlanCostAccounting", "test_optimality_gap", {}),
        *[("TestGreedyOracleParity", "test_randomized_parity", {"seed": s, "backend": b})
          for s in (0, 7, 42) for b in ("ffd", "lp")],
        *[("TestGreedyOracleParity", "test_lp_never_prices_above_ffd", {"seed": s}) for s in (0, 7, 42)],
        ("TestLPQuality", "test_lp_beats_ffd_on_price_adversarial_catalog", {}),
        ("TestLPQuality", "test_auto_routes_by_job_size", {}),
        ("TestLPQuality", "test_relax_memo_hits_across_solves", {}),
        ("TestLPQuality", "test_dual_bound_matches_known_optimum", {}),
        ("TestLPQuality", "test_relax_handles_unschedulable_signature", {}),
    ],
    "test_lp_optim.py": [
        *[("TestRefinementMonotonicity", t, {"seed": s})
          for t in ("test_bound_tightens_cost_never_worsens", "test_refined_plan_never_prices_above_ffd")
          for s in (0, 7, 42)],
        *[("TestBranchFrontierEquivalence", t, {"seed": s})
          for t in ("test_coalesced_frontier_matches_scalar_brancher",
                    "test_branch_bounds_are_sound_and_incumbent_optimal")
          for s in (0, 7, 42)],
        *[("TestParetoWeights", t, {"seed": s})
          for t in ("test_weights_ride_job_token_no_memo_aliasing", "test_pareto_report_deterministic_per_content")
          for s in (0, 7, 42)],
    ],
}

_MIRRORS: dict = {}


def _mirror(file: str):
    """The JAX test file's module over the port: package and knob prefix
    swapped, ``TPUScheduler`` the port's scheduler on the CPU, helpers over
    the port's classes, fixtures plain functions, the pack seam's
    ``device`` beside its ``mesh`` arguments."""
    if file not in _MIRRORS:
        from test_torch_oracle import _port_helpers

        _port_helpers()
        src = (TESTS / file).read_text()
        src = re.sub(r"@pytest\.fixture(\(autouse=True\))?\n", "", src)
        src = re.sub(r"\bkarpenter_core_tpu\b", PORT, src)
        # the knobs the port keeps as module constants: set the constant
        src = re.sub(r'monkeypatch\.setenv\(\s*"KARPENTER_TPU_(LP_ITERS|LP_REFINE_ROUNDS|LP_BRANCH_K|COST_WEIGHTS)",',
                     r'_set_constant(monkeypatch, "\1",', src)
        src = src.replace("KARPENTER_TPU_", "KARPENTER_TORCH_")
        src = src.replace("from helpers import", "from _port_helpers import")
        src = src.replace(", warmstore\n", "\n")
        src = src.replace("mesh=None", "device=None, mesh=None").replace("mesh=mesh", "device=device, mesh=mesh")
        src = re.sub(r"\bTPUScheduler\b", "TorchScheduler", src)
        mod = types.ModuleType(f"_lp_mirror_{file[:-3]}")
        mod.__file__ = str(TESTS / file)
        mod._set_constant = _set_constant
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        mod.TorchScheduler = lambda *a, **kw: TorchScheduler(*a, device="cpu", **kw)
        _MIRRORS[file] = mod
    return _MIRRORS[file]


def _set_constant(monkeypatch, name: str, raw: str) -> None:
    """A reference scenario's ``setenv`` of a knob the port keeps as a
    module constant: the constant, parsed as the reference parses it."""
    if name == "COST_WEIGHTS":
        monkeypatch.setattr(port_plancost, name, raw)
    else:
        monkeypatch.setattr(port_lp, name, int(raw))


def _cpu_default(device=None):
    return torch.device("cpu" if device is None else device)


@pytest.mark.parametrize(
    "file,cls,test,kwargs",
    [(f, c, t, kw) for f, cases in MIRRORED.items() for c, t, kw in cases],
    ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()) or "-",
)
def test_reference_scenarios_hold_the_port(monkeypatch, file, cls, test, kwargs):
    mod = _mirror(file)
    # the scenarios call the seam without a device: the CPU stands in
    # for the card
    for module in (port_lp, port_pack, port_calibrate):
        monkeypatch.setattr(module, "resolve_device", _cpu_default)
    fn = getattr(getattr(mod, cls)(), test)
    if "monkeypatch" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, monkeypatch=monkeypatch)
    fn(**kwargs)
