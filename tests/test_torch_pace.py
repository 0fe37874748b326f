"""``chip_smoke.py``'s lanes and depth plan on the CPU.

Phases 4-23 run in four lanes side by side, the first in the script's
process; the predicted script is phases 1-3 and the longest lane, each
phase as the calibration host took it (``PHASE_FULL_S``), times the
host's pace. The plan keeps full depth while that fits
``SCRIPT_BUDGET_S``, and else cuts phases 4-16's repetitions (warm
solves, profiles, kernel-case reps, config 7's ticks, 16b's seeds),
never a check. Phases 1-23 fit the budget, and so the script's 1,200 s
limit, on the calibration host and on one 1.5 times slower."""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_pace", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lanes_run_phases_4_to_22_once_each(cs):
    phases = [n for lane in cs.LANES for n in lane]
    assert sorted(phases) == list(range(4, 24))
    assert cs.LANES[0] == tuple(range(4, 12))  # the phases main runs with phase 3's worlds in hand
    assert set(cs.PHASE_RUNNERS) == set(phases) - set(cs.LANES[0])
    assert set(cs.SELECTABLE_PHASES) <= set(cs.PHASE_RUNNERS)
    assert set(cs.PHASE_FULL_S) == set(range(1, 24))
    # phase 20 reads its process's device plane after 12 and 13 moved bytes
    lane20 = next(lane for lane in cs.LANES if 20 in lane)
    assert lane20.index(12) < lane20.index(20) and lane20.index(13) < lane20.index(20)


def test_the_cut_cuts_repetitions_only(cs):
    full, cut = cs.DEPTH_FULL, cs.DEPTH_CUT
    assert set(cut) == set(full)
    assert all(cut[k] <= full[k] for k in full) and any(cut[k] < full[k] for k in full)
    # every path keeps a warm solve, config 7 a mutating tick and a
    # device-engine pass, 16b its first seed, every timing three reps
    assert cut["warm"] >= 1 and cut["config7_ticks"] > cs.CONFIG7_MUTATE_EVERY
    assert cut["config7_native_off_ticks"] >= 3 and cut["config14_seeds"] >= 1
    assert cs.cut_reps(1) == 3


@pytest.mark.parametrize("pace", [1.0, 1.5])
def test_phases_1_to_22_fit_the_budget_at_pace(cs, pace):
    plan = cs.depth_plan(pace)
    assert plan["pace"] == pace and plan["predicted_s"] == pytest.approx(pace * cs.predicted_s(1.0))
    assert plan["predicted_s"] <= cs.SCRIPT_BUDGET_S < 1200.0
    assert not plan["cut"] and {k: plan[k] for k in cs.DEPTH_FULL} == cs.DEPTH_FULL


def test_a_host_too_slow_for_the_budget_cuts_phases_4_to_16_only(cs):
    slow = 1.01 * cs.SCRIPT_BUDGET_S / cs.predicted_s(1.0)
    plan = cs.depth_plan(slow)
    assert plan["cut"] and {k: plan[k] for k in cs.DEPTH_CUT} == cs.DEPTH_CUT
    cs.DEPTH_PLAN.clear()
    cs.DEPTH_PLAN.update(plan)
    try:
        assert [cs.phase_depth(n) == cs.DEPTH_CUT for n in (3, 4, 16, 17, 22)] == [False, True, True, False, False]
    finally:
        cs.DEPTH_PLAN.clear()
    assert cs.phase_depth(4) == cs.DEPTH_FULL  # --phases runs at full depth


def test_a_lanes_phase_seconds_follow_its_marks(cs, monkeypatch):
    """A lane runs its phases out of number order (18 before 14): each
    phase's seconds run from its mark to the next mark in time."""
    monkeypatch.setattr(cs, "PHASE_T", {18: 0.0, 14: 5.0, 19: 7.0})
    assert cs.phase_seconds(10.0) == {18: 5.0, 14: 2.0, 19: 3.0}


def test_the_lanes_parts_merge_into_one_kernels_line(cs):
    parts = [
        {"pack_launches": {"a": {"ffd_pack": 1}}, "pack_cases": {"ffd_pack": [{"kernel_ms": 1.0}]},
         "compat_paths": {"a": 2}, "compat_err": [0], "relax_splits": {"config5": {}}},
        {"pack_launches": {"b": {"ffd_pack": 3}}, "pack_cases": {"ffd_pack": [{"kernel_ms": 2.0}]},
         "screen_launches": {"b": {"disrupt_screen.prefix": 1}}, "screen_cases": [{"entry": "prefix"}],
         "compat_captured": {"serving_captured": [{"max_abs_err": 0}]}, "config12": [{"pods": 1}]},
    ]
    k = cs.kernels_parts(parts)
    assert k["pack_launches"] == {"a": {"ffd_pack": 1}, "b": {"ffd_pack": 3}}
    assert [r["kernel_ms"] for r in k["pack_cases"]["ffd_pack"]] == [1.0, 2.0]
    assert k["pack_cases"]["pack_existing"] == [] and k["compat_paths"] == {"a": 2} and k["compat_err"] == [0]
    assert k["screen_cases"] == [{"entry": "prefix"}] and set(k["compat_captured"]) == {"serving_captured"}
    assert k["relax_splits"] == {"config5": {}} and k["config12"] == [{"pods": 1}]


def test_probe_is_host_only_and_positive(cs):
    assert cs.pace_probe_once() > 0.0
