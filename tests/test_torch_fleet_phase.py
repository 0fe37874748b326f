"""``chip_smoke.py``'s phase 19 (the fleet), cut down, on the CPU.

The card runs phase 19 at bench config 11's size ({8, 32, 128} tenants ×
{200, 1,000} pods, 3 rounds); here its runners run on ``device="cpu"``
with 2 and 4 tenants of 40 pods over 2 rounds, so the phase's own checks
are exercised: 19a's curve and identity runs (batched plans equal solo
plans cell by cell, no library built in a steady round, the dispatch
stats), 19c's native-off and ``lp`` legs (plans equal across legs, a
scan launch carrying two tenants' jobs in the recorded flushes) and
19d's ``trafficgen --fleet`` processes (one plan hash, decisions
monotonic, no orphaned span). Each check fails the phase through
``chip_smoke.fail`` (``SystemExit``). Tolerance: exact plan equality.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase19", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_phase_cut_down(chip_smoke, monkeypatch):
    for env in ("KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_FLEET_ENGINE", "KARPENTER_TORCH_CATALOG_CACHE_MAX"):
        monkeypatch.delenv(env, raising=False)
    out = chip_smoke.run_fleet_phase("cpu", tenants=(2, 4), pods=(40,), rounds=2, identity=(4, 40), tg=(2, 60))
    c11 = out["config11"]
    assert [(c["tenants"], c["pods_each"]) for c in c11["curve"]] == [(2, 40), (4, 40)]
    assert [c["identical"] for c in c11["curve"]] == ["4/4", "8/8"] and c11["plan_identity"] == "8/8"
    assert c11["steady_round_builds"] == 0
    for cell in c11["curve"]:
        d = cell["dispatch"]
        assert d["pack_calls"] >= cell["tenants"] and d["flushes"] <= d["pack_calls"]
        assert 2 <= d["max_occupancy"] <= 4 and all(0.0 <= w < 1.0 for w in d["padding_waste"])
        # on the CPU the wrappers take their plain versions: nothing launches
        assert cell["compat_launches"] == {"solo": 0, "batched": 0}
    assert c11["identity"]["solo"]["dispatch"]["flushes"] == 0
    assert c11["identity"]["batched"]["pods_decided"] == 4 * (40 + 4)
    assert "cpu_identity" not in out  # no CPU twin of a CPU run
    k = out["kernels"]
    assert set(k["legs"]) == {"ffd-batched-cpu", "ffd-solo-cpu", "lp-batched-cpu", "lp-solo-cpu"}
    assert k["ffd_equal_to_19a"] == "8/8"
    scan = k["scan"]["ffd-batched-cpu"]
    assert scan["multi_tenant_launches"] >= 1 and scan["max_jobs_per_launch"] >= 2
    assert scan["flushes"] == k["legs"]["ffd-batched-cpu"]["dispatch"]["flushes"]
    assert k["launches"] == {} and k["cases"] == {}
    assert k["captured_calls"] == {"compat_allowed": 0, "ffd_pack": 0, "dual_ascent": 0}  # card legs only
    tg = out["trafficgen"]
    assert set(tg["runs"]) == {"batched-cpu", "solo-cpu"}
    assert tg["runs"]["batched-cpu"]["dispatch"]["flushes"] > 0 and tg["runs"]["solo-cpu"]["dispatch"]["flushes"] == 0
    assert set(out["sections_s"]) == {"19a", "19c", "19d"}
    for env in ("KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_FLEET_ENGINE", "KARPENTER_TORCH_CATALOG_CACHE_MAX"):
        assert os.environ.get(env) is None


def test_identity_check_fails_the_phase(chip_smoke):
    """A cell whose batched plans differ from its solo plans, or a run with
    no cells, fails the phase."""
    plans = {(0, "t0"): (("default", "a"),), (0, "t1"): (("default", "b"),)}
    assert chip_smoke.check_identity("same", plans, dict(plans)) == "2/2"
    with pytest.raises(SystemExit):
        chip_smoke.check_identity("differs", plans, {**plans, (0, "t1"): (("default", "c"),)})
    with pytest.raises(SystemExit):
        chip_smoke.check_identity("empty", {}, {})


def test_scan_launches_count_classes_of_a_flush(chip_smoke):
    """The recorded flushes' (pad class, width) classes are the scan's
    launches; a class holding two lanes' jobs carries two tenants'."""
    rec = chip_smoke.record_flushes()
    rec.flushes = [
        [[(32, 4)], [(32, 4), (64, 4)]],  # lanes 0 and 1 share class (32, 4)
        [[(128, 5)]],
    ]
    assert rec.scan_launches() == {
        "flushes": 2, "launches": 3, "launches_per_flush": 1.5, "max_launches_per_flush": 2,
        "jobs_per_launch": 1.333, "max_jobs_per_launch": 2, "multi_tenant_launches": 1,
    }


def test_fleet_phase_fails_without_a_mixed_launch(chip_smoke, monkeypatch):
    """With one worker no flush holds two tenants' jobs: 19c fails."""
    from karpenter_core_tpu_torch.fleet import megasolve

    monkeypatch.setattr(megasolve, "FLEET_WORKERS", 1)
    with pytest.raises(SystemExit):
        chip_smoke.run_fleet_kernels("cpu", identity=(2, 40), rounds=1)
