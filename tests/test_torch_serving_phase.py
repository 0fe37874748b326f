"""``chip_smoke.py``'s phase 16 (the serving pipeline), cut down, on the CPU.

The card runs phase 16 at bench scale; here its runners run on
``device="cpu"`` at the JAX tests' scales, so the phase's own checks are
exercised: 16c's lockstep legs (``rollout`` and ``cascade`` with native
packing off and a ``DisruptionController`` every second tick, the
pipeline against the sequential loop: plan streams, disruption passes
and stores equal, no serving-logger fault, every compat, FFD, first-fit
and screen wrapper called), and 16a on one scenario (lockstep pipeline
against sequential in ``trafficgen`` subprocesses, the free run's
latency row). Each check fails the phase through ``chip_smoke.fail``
(``SystemExit``).
"""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase16", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_kernels_leg_cut_down(chip_smoke, monkeypatch):
    monkeypatch.delenv("KARPENTER_TORCH_NATIVE", raising=False)
    out = chip_smoke.run_serving_kernels_phase("cpu", 40)
    assert set(out["scenarios"]) == {"rollout", "cascade"}
    for row in out["scenarios"].values():
        assert row["plans"] >= 4 and any(executed for _, executed in row["passes"])
    calls = out["captured_calls"]
    assert calls["compat_allowed"] and calls["ffd_pack"] and calls["pack_existing"]
    assert calls["disrupt_screen.prefix"] and calls["disrupt_screen.subsets"] and calls["disrupt_screen.singles"]
    # on the CPU the wrappers take their plain versions: nothing launches
    assert all(n["tick"] == n["prewarm"] == 0 for mode in out["launches"].values() for n in mode.values())
    assert out["cases"] == {}
    assert os.environ.get("KARPENTER_TORCH_NATIVE") is None


def test_serving_phase_config8_cut_down(chip_smoke):
    out = chip_smoke.run_config8_phase("cpu", 40, 0.01, ("churn10x",))
    row = out["scenarios"]["churn10x"]
    assert row["plan_identical"] and row["monotonic_decision_order"] and row["orphan_spans"] == 0
    assert row["pods_decided"] > 0 and row["steady_decision_latency_ms"]["p99"] > 0
    assert row["steady_p99_ratio_sequential_over_pipeline"] is not None
    assert set(row["queue_stats"]) == {"solve", "telemetry"}


def test_phase_fails_on_a_stream_difference(chip_smoke, monkeypatch):
    """The identity check is live: a sequential leg whose plan stream
    differs fails the phase."""
    real = chip_smoke.serving_kernel_leg

    def leg(device, mode, scale, scenario="rollout"):
        out = real(device, mode, scale, scenario)
        if mode == "sequential":
            out["stream"] = out["stream"][:-1]
        return out

    monkeypatch.setattr(chip_smoke, "serving_kernel_leg", leg)
    with pytest.raises(SystemExit):
        chip_smoke.run_serving_kernels_phase("cpu", 20, scenarios=("rollout",))
