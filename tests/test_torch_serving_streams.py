"""The port's serving plan streams ≡ the JAX package's, on the CPU.

Plan streams compare across packages only from the same start: both
packages' generated names, claim hostnames and uids restart before each
run (``same_start``), and each run's warm state and catalog cache start
empty (``reset_both``). Held:

- lockstep, every scenario of the traffic generator at scale 60 and two
  seeds, in both modes: the port's canonical plan bytes equal the JAX
  package's; the port's pipeline equals its sequential loop, with
  decisions monotonic in tick order;
- kill-the-process-mid-stream on ``restart_wave`` at scale 60 over 48
  types: the port's kill phase, its warm resume (snapshot restored
  before the first tick) and its cold resume concatenate to the stream
  of the port's unkilled reference run, whose hash equals the JAX
  package's reference run's; every phase runs in this process with a
  simulated process death between phases and the name sequence
  restarted, as a fresh interpreter would have it;
- one ``python -m karpenter_core_tpu_torch.serving.trafficgen --device
  cpu`` subprocess: its plan hash equals the JAX package's run of the
  same scenario.
"""

from __future__ import annotations

import hashlib
import importlib
import itertools
import json
import os
import subprocess
import sys

import pytest

from test_torch_incremental import reset_both
from test_torch_kube_client import PORT, REF
from test_torch_native import reference_native
from test_torch_oracle import same_start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("cascade", "churn10x", "diurnal", "restart_wave", "rollout", "spot_storm")


def tg(pkg: str):
    return importlib.import_module(f"{pkg}.serving.trafficgen")


def lockstep(pkg: str, name: str, mode: str, seed: int, monkeypatch, scale: int = 60):
    reset_both()
    same_start(monkeypatch)
    sc = tg(pkg).build_scenario(name, scale=scale, seed=seed)
    kw = {"device": "cpu"} if pkg == PORT else {}
    return tg(pkg).run_lockstep(sc, mode=mode, **kw), sc


def test_scenarios_cover_the_generator():
    assert sorted(tg(PORT).SCENARIOS) == sorted(SCENARIOS)


@pytest.mark.parametrize("seed", [5, 11])
@pytest.mark.parametrize("mode", ["sequential", "pipeline"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_lockstep_plan_bytes_equal_reference(monkeypatch, name, mode, seed):
    reference_native(monkeypatch)
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_INCREMENTAL", raising=False)
    got, sc = lockstep(PORT, name, mode, seed, monkeypatch)
    want, _ = lockstep(REF, name, mode, seed, monkeypatch)
    assert got.plan_bytes() == want.plan_bytes()
    assert got.plan_stream, "the scenario emitted no plan"
    assert got.pods_decided == want.pods_decided and got.errors == want.errors
    assert got.decisions == want.decisions
    assert tg(PORT).monotonic_decision_order(got)
    if mode == "pipeline":
        seq, _ = lockstep(PORT, name, "sequential", seed, monkeypatch)
        assert got.plan_bytes() == seq.plan_bytes()
        assert got.stage_stats["prewarm"]["runs"] >= 1


def restart_names() -> None:
    """Both packages' generated names and claim hostnames from 1 (a fresh
    interpreter's start); uids keep counting, as random uids never
    collide."""
    for pkg in (REF, PORT):
        importlib.import_module(f"{pkg}.scheduler.nodeclaim")._hostname_counter = itertools.count(1)
        importlib.import_module(f"{pkg}.kube.objects")._sequence = itertools.count(1)


def process_death() -> None:
    reset_both()
    importlib.import_module(f"{PORT}.solver.warmstore").simulate_process_death()
    restart_names()


def test_kill_and_resumes_equal_unkilled_reference(monkeypatch, tmp_path):
    reference_native(monkeypatch)
    monkeypatch.delenv("KARPENTER_TORCH_INCREMENTAL", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_INCREMENTAL", raising=False)
    same_start(monkeypatch)
    port = tg(PORT)
    kw = dict(scale=60, seed=7, n_types=48, device="cpu")
    process_death()
    kill = port.run_restart_kill("restart_wave", 6, str(tmp_path), **kw)
    assert kill["snapshot_path"] and os.path.exists(kill["handoff_path"])
    resumes = {}
    for mode in ("warm", "cold"):
        process_death()
        resumes[mode] = port.run_restart_resume(kill["handoff_path"], restore=mode == "warm", device="cpu")
    process_death()
    ref_port = port.run_restart_reference("restart_wave", **kw)
    process_death()
    ref_jax = tg(REF).run_restart_reference("restart_wave", scale=60, seed=7, n_types=48)
    assert ref_port["plan_sha256"] == ref_jax["plan_sha256"]
    assert ref_port["plans_emitted"] == ref_jax["plans_emitted"] >= 6
    for mode, out in resumes.items():
        assert out["mode"] == mode and out["device"] == out["snapshot_device"] == "cpu"
        assert out["plan_sha256"] == ref_port["plan_sha256"], mode
        assert out["plans_emitted"] == ref_port["plans_emitted"]
        assert out["first_solve_compiles"] == 0  # the device plane's: no library loaded on the CPU
    warm, cold = resumes["warm"], resumes["cold"]
    assert warm["restored"] and warm["warmstore"]["restored"].get("catalog") == 1
    assert warm["prewarm"]["status"] == "ok" and warm["prewarm"]["device"] == "cpu"
    assert not cold["restored"] and cold["warmstore"] is None and cold["prewarm"] is None
    process_death()


def test_cli_subprocess_equals_reference(monkeypatch):
    reference_native(monkeypatch)
    monkeypatch.delenv("KARPENTER_TPU_INCREMENTAL", raising=False)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KARPENTER_")}
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_core_tpu_torch.serving.trafficgen", "--scenario", "cascade",
         "--mode", "pipeline", "--drive", "lockstep", "--scale", "60", "--seed", "7", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want, sc = lockstep(REF, "cascade", "sequential", 7, monkeypatch)
    assert out["plan_sha256"] == hashlib.sha256(want.plan_bytes()).hexdigest()
    assert out["device"] == "cpu" and out["pods_injected"] == sc.total_creates
    assert out["monotonic_decision_order"] and out["orphan_spans"] == 0
    assert out["serving_log_faults"] == []
    assert out["flightrec"]["coverage"] == 1.0
