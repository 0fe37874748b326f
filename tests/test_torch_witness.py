"""The port's lock and knob witnesses, installed for real in a fresh
interpreter (the reference's witnesses are installed in every test
process by ``tests/conftest.py``, so the port's run in one of their
own).

``python -m karpenter_core_tpu_torch.analysis --witness --device cpu``
starts ``python -m karpenter_core_tpu_torch.witness``: both witnesses
install before any other module of the package is imported, the fixed
threaded workload runs (serving with prewarm and disruption, the batched
fleet, an ``Operator.start()``, a warm-store restore), and the gate holds
observed ⊆ static for both, with every required lock acquired. Then the
knob witness's own cases (``tests/test_configprov.py``'s
``TestKnobWitness``, on the port's prefix) in a fresh interpreter.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "karpenter_core_tpu_torch"


def _run(args, timeout=240, env=None):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_witnessed_run_passes_with_a_nonempty_observation():
    proc = _run(["-m", f"{PORT}.analysis", "--witness", "--device", "cpu", "--format", "json"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert got["ok"] and got["installed"] == {"lock": True, "knob": True}
    assert got["lock_edges"] and got["unexplained_edges"] == [] and got["missing_locks"] == []
    assert got["knobs"] and got["unexplained_knobs"] == []
    assert {f"{PORT}/state/cluster.py::Cluster._mu", f"{PORT}/kube/client.py::KubeClient._lock"} <= set(got["locks"])
    work = got["workload"]
    assert work["serving"]["ticks"] > 0 and work["serving"]["disruption_passes"] > 0
    assert work["fleet"]["pods_decided"] > 0 and work["operator"]["nodeclaims_created"] > 0
    assert work["warmstore"]["restored"]


@pytest.mark.parametrize("off", [("lock",), ("knob",), ("lock", "knob")])
def test_witnessed_run_without_witnesses_fails(off):
    """A witness switched off fails the gate, whichever it is: no switch
    yields a passing run with a witness skipped."""
    switches = {"lock": "KARPENTER_TORCH_LOCK_WITNESS", "knob": "KARPENTER_TORCH_KNOB_WITNESS"}
    env = dict(os.environ, **{switches[w]: "0" for w in off})
    proc = _run(["-m", f"{PORT}.witness", "--device", "cpu", "--json"], env=env)
    assert proc.returncode == 1
    got = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert [p for p in got["problems"] if "switched off" in p] == [
        f"the {w} witness is switched off ({switches[w]})" for w in ("lock", "knob") if w in off]


KNOB_CASES = r'''
import json, os
from karpenter_core_tpu_torch.analysis import knobwitness
knobwitness.install()
assert knobwitness.installed()
out = {}
os.environ.get("KARPENTER_TORCH_PACK_BACKEND")
"KARPENTER_TORCH_NATIVE" in os.environ
observed, unexplained = knobwitness.verify_against_static()
out["subset"] = ["KARPENTER_TORCH_PACK_BACKEND" in observed, "KARPENTER_TORCH_NATIVE" in observed, unexplained]
os.environ.get("KARPENTER_TORCH_PHANTOM_FIXTURE_KNOB")
out["phantom"] = knobwitness.verify_against_static()[1]
os.environ["KARPENTER_TORCH_SNAPSHOT_ONLY_KNOB"] = "1"
dict(os.environ)
os.environ.copy()
out["bulk"] = "KARPENTER_TORCH_SNAPSHOT_ONLY_KNOB" in knobwitness.observed_names()
os.environ.get("KARPENTER_TPU_CONSTRAINT_ENGINE")
out["other_prefix"] = "KARPENTER_TPU_CONSTRAINT_ENGINE" in knobwitness.observed_names()
print(json.dumps(out))
'''


def test_knob_witness_cases_in_a_fresh_interpreter():
    proc = _run(["-c", KNOB_CASES], timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["subset"] == [True, True, []]
    assert got["phantom"] == ["KARPENTER_TORCH_PHANTOM_FIXTURE_KNOB"]
    assert got["bulk"] is False and got["other_prefix"] is False
