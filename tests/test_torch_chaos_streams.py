"""The port's chaos run ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch.serving.trafficgen.run_chaos`` drives a
scenario in lockstep through the serving pipeline with one fault kind
injected from a seeded schedule. On ``rollout`` at scale 60, seeds 7
and 11, for the clean twin (``"none"``) and each of the five faults,
from the same start in both packages (``same_start``, ``reset_both``):

- the plan hash, the fault steps, the schedule, the plans emitted, the
  stale plans emitted and the single-writer witness equal the JAX
  package's;
- in the port, every faulted plan hash equals the clean twin's;
- each holding fault (``watch_flap``, ``watch_hang``: the stale-world
  guard; ``failover``: the leader gate) held at least one tick in both
  packages. The counts themselves depend on timing, so they are held
  as at least 1, not as equal.

A ``python -m karpenter_core_tpu_torch.serving.trafficgen --chaos``
subprocess on the CPU prints the same hash as the JAX package's run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from test_torch_incremental import reset_both
from test_torch_kube_client import PORT, REF
from test_torch_native import reference_native
from test_torch_oracle import same_start
from test_torch_serving_streams import tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("watch_flap", "watch_hang", "latency_spike", "failover", "clock_skew")
SAME = ("plan_sha256", "fault_steps", "schedule", "plans_emitted", "stale_plans_emitted", "single_writer_ok",
        "steps", "pods_injected", "pods_decided", "pod_errors", "monotonic_decision_order")

_CLEAN: dict = {}  # seed → the port's clean twin


def chaos(pkg: str, fault: str, seed: int, monkeypatch) -> dict:
    reset_both()
    same_start(monkeypatch)
    kw = {"device": "cpu"} if pkg == PORT else {}
    return tg(pkg).run_chaos("rollout", fault, scale=60, seed=seed, **kw)


def test_faults_cover_run_chaos():
    assert tg(PORT).CHAOS_FAULTS == FAULTS


@pytest.mark.parametrize("fault", ("none",) + FAULTS)
@pytest.mark.parametrize("seed", [7, 11])
def test_chaos_run_equals_reference(monkeypatch, seed, fault):
    reference_native(monkeypatch)
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_INCREMENTAL", raising=False)
    got = chaos(PORT, fault, seed, monkeypatch)
    want = chaos(REF, fault, seed, monkeypatch)
    assert {k: got[k] for k in SAME} == {k: want[k] for k in SAME}
    assert got["device"] == "cpu" and got["fault"] == fault and got["plans_emitted"] >= 4
    assert got["stale_plans_emitted"] == 0 and got["single_writer_ok"] and got["monotonic_decision_order"]
    assert got["pods_decided"] == got["pods_injected"] and got["pod_errors"] == 0
    if fault == "none":
        _CLEAN[seed] = got
        assert got["schedule"] is None and got["fault_steps"] == []
        return
    clean = _CLEAN.get(seed) or chaos(PORT, "none", seed, monkeypatch)
    assert got["plan_sha256"] == clean["plan_sha256"]
    assert got["fault_steps"] and got["schedule"]["events"][0]["kind"] == fault
    counter = tg(PORT)._HOLDING_FAULTS.get(fault)
    for run in (got, want):
        if counter is None:
            assert run["held_ticks"] == {"stale": 0, "leader": 0}
        else:
            assert run["held_ticks"][counter] >= 1, run["held_ticks"]


def test_chaos_cli_equals_reference(monkeypatch):
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_core_tpu_torch.serving.trafficgen", "--scenario", "rollout",
         "--chaos", "clock_skew", "--scale", "60", "--seed", "11", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["serving_log_faults"] == [] and out["fault"] == "clock_skew" and out["device"] == "cpu"
    reference_native(monkeypatch)
    want = chaos(REF, "clock_skew", 11, monkeypatch)
    assert {k: out[k] for k in SAME} == {k: want[k] for k in SAME}
