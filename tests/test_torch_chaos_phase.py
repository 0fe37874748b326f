"""``chip_smoke.py``'s phase 17 (the chaos pack), cut down, on the CPU.

The card runs phase 17 at bench config 15's size (``rollout`` at scale
240, seed 7); here its runners run on ``device="cpu"`` at scale 60, so
the phase's own checks are exercised: 17a's ``trafficgen --chaos``
subprocesses (the five faults and the clean twin: every faulted hash
equal to the clean twin's, no stale plan, one writer, a held tick under
each holding fault, no serving-logger fault) and 17b's in-process
``run_chaos`` legs with native packing off, in config 15's world and in
the world with its joined nodes labeled (every compat, FFD and
first-fit wrapper called). Each check fails the phase through
``chip_smoke.fail`` (``SystemExit``). Also the script's phase selector.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase17", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_phase_cut_down(chip_smoke, monkeypatch):
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE", raising=False)
    out = chip_smoke.run_chaos_phase("cpu", 60)
    runs = out["config15"]["runs"]
    assert set(runs) == {"none", *chip_smoke.CONFIG15_FAULTS}  # no CPU twin of a CPU run
    clean = out["config15"]["clean_sha256"]
    for fault, row in runs.items():
        assert row["plan_sha256"] == clean and row["stale_plans_emitted"] == 0 and row["single_writer_ok"]
        assert row["serving_log_faults"] == [] and row["process_s"] > 0
        assert bool(row["fault_steps"]) == (fault != "none")
    assert runs["watch_flap"]["held_ticks"]["stale"] >= 1 and runs["failover"]["held_ticks"]["leader"] >= 1
    kernels = out["kernels"]
    assert set(kernels["runs"]) == {"config15-none", "config15-failover", "labeled-none", "labeled-failover"}
    assert kernels["clean_sha256"]["config15"] == clean
    assert kernels["runs"]["labeled-failover"]["plan_sha256"] == kernels["clean_sha256"]["labeled"] != clean
    calls = kernels["captured_calls"]
    assert calls["compat_allowed"] and calls["ffd_pack"] and calls["pack_existing"]
    # on the CPU the wrappers take their plain versions: nothing launches
    assert all(n == 0 for run in kernels["launches"].values() for n in run.values())
    assert kernels["cases"] == {}
    assert os.environ.get("KARPENTER_TORCH_NATIVE") is None


def test_config15_world_never_reaches_the_first_fit(chip_smoke, monkeypatch):
    """Config 15's pods select a team label the harness's joined nodes
    lack, so no tick has an existing node to fill: the labeled world is
    what takes 17b's first-fit."""
    from karpenter_core_tpu_torch.solver import pack

    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    with chip_smoke.capture(pack, "pack_existing") as unlabeled:
        chip_smoke.chaos_kernel_run("cpu", "none", 60, 7, labeled=False)
    with chip_smoke.capture(pack, "pack_existing") as labeled:
        chip_smoke.chaos_kernel_run("cpu", "none", 60, 7, labeled=True)
    assert not unlabeled.calls and labeled.calls


def _run(clean: str, **changes) -> dict:
    row = {"fault": "failover", "plan_sha256": clean, "pods_decided": 4, "pods_injected": 4, "pod_errors": 0,
           "stale_plans_emitted": 0, "single_writer_ok": True, "monotonic_decision_order": True,
           "fault_steps": [2], "held_ticks": {"stale": 0, "leader": 1}, "serving_log_faults": []}
    row.update(changes)
    return row


@pytest.mark.parametrize("changes", [
    {"plan_sha256": "other"}, {"pods_decided": 3}, {"pod_errors": 1}, {"stale_plans_emitted": 1},
    {"single_writer_ok": False}, {"monotonic_decision_order": False}, {"fault_steps": []},
    {"held_ticks": {"stale": 0, "leader": 0}}, {"serving_log_faults": ["ERROR: serving tick 3 failed"]},
    {"fault": "watch_hang", "held_ticks": {"stale": 0, "leader": 0}},
], ids=lambda c: ",".join(c))
def test_each_gate_fails_the_phase(chip_smoke, changes):
    chip_smoke.check_chaos_run("17a", _run("h"), "h")
    with pytest.raises(SystemExit):
        chip_smoke.check_chaos_run("17a", _run("h", **changes), "h")


def test_phase_fails_on_a_faulted_stream_difference(chip_smoke, monkeypatch):
    real = chip_smoke.trafficgen

    def run(args, timeout=600.0):
        out = real(args, timeout)
        if "failover" in args:
            out["plan_sha256"] = "0" * 64
        return out

    monkeypatch.setattr(chip_smoke, "trafficgen", run)
    with pytest.raises(SystemExit):
        chip_smoke.run_config15_phase("cpu", 30, 7, ("failover",), 2)


def test_phase_selector(chip_smoke):
    """``--phases`` takes only the selectable phases, and like the whole
    script it fails without a card, before it prints anything."""
    import torch

    assert sorted(chip_smoke.SELECTABLE_PHASES) == [14, 15, 16, 17, 18, 19, 20, 21, 22, 23]
    script = os.path.join(REPO, "chip_smoke.py")
    bad = subprocess.run([sys.executable, script, "--phases", "3,17"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1 and "--phases takes" in bad.stderr and bad.stdout == ""
    if not torch.cuda.is_available():
        nocard = subprocess.run([sys.executable, script, "--phases", "16,17"], cwd=REPO, capture_output=True,
                                text=True, timeout=120)
        assert nocard.returncode == 1 and "is_available() is False" in nocard.stderr and nocard.stdout == ""
