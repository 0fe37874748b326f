"""``chip_smoke.py``'s phase 23 (the mesh across cards), cut down, on the CPU.

The card runs 23a on its one card (bench config 12's 125,000 × 10,000
cell with its D = 4 shards as four placements of the card) and, under
``--phases 23 --cards N``, 23b across N cards. Here both run on CPU
placements through the kernels' plain versions, at 2,000–3,000 pods ×
300 types: the phase's own checks run (every pod scheduled and within
its type, the placements' ids, allowed matrix and prefix screen equal to
one placement's, the dryrun's sequence held to the JAX package's numbers
on four devices, the 8-shard solve over four placements, no launch off
the card). ``DRYRUN_REFERENCE`` is checked against the JAX package
itself, and ``--cards`` takes only phase 23. Each check fails the phase
through ``chip_smoke.fail`` (``SystemExit``). Tolerance: exact equality.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import karpenter_core_tpu.solver.sharding as ref_sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase23", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cards_phase_cut_down(chip_smoke, monkeypatch):
    from karpenter_core_tpu_torch.solver import sharding

    for env in ("KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    out = chip_smoke.run_cards_phase("cpu", cell=(3000, 300, 4), reps=2)
    row = out["cell"]
    assert (row["pods"], row["types"], row["n_devices"], row["reps"]) == (3000, 300, 4, 2)
    assert row["placements"] == ["cpu"] * 4 and row["scheduled"] == 3000 and row["shard"]["chunks"] == 4
    assert out["one_placement_equal"]
    # the path's own B5 launch, the first placement's, held to its plain version
    (path,) = out["held"]["rows"]["b5"]
    assert (path["launch"], path["card"], path["P"], path["max_abs_err"]) == ("path", "cpu", 750, 0)
    assert 0 < out["screen_true_rows"] < 4 * chip_smoke.CARDS_SCREEN[0] and out["allowed_true"] > 0
    assert not any(out["launches"].values())
    assert sharding.active_mesh("cpu") is None


def test_cards_across_rehearsal(chip_smoke):
    cells = ((2000, 300, 2, 2), (2000, 300, 4, 4), (3000, 300, 8, 4), (2000, 300, 8, 8))
    out = chip_smoke.run_cards_across(4, cells=cells, reps=2, solve=(300, 30, 64), devices=["cpu"] * 4)
    # the 8-card cell is left out: four placements were given
    assert [(r["pods"], r["n_devices"], len(r["placements"])) for r in out["curve"]] == [
        (2000, 2, 2), (2000, 4, 4), (3000, 8, 4)]
    assert all(r["one_card_equal"] and r["scheduled"] == r["pods"] for r in out["curve"])
    assert out["dryrun"]["reference_held"] and out["dryrun"]["n_devices"] == 4
    assert {k: out["dryrun"][k] for k in chip_smoke.DRYRUN_REFERENCE[4]} == chip_smoke.DRYRUN_REFERENCE[4]
    leg = out["solve"]["legs"]["cpu-sharded"]
    assert leg["mega_packs"] >= 1 and leg["shard"]["n_devices"] == 8
    assert out["other_card"] is None and out["auto"] is None and out["held"]["gather"] is None
    # the first cell over the four placements holds the second one's own B5 launch
    (path,) = out["held"]["rows"]["b5"]
    assert (path["launch"], path["P"], path["max_abs_err"]) == ("path", 500, 0)
    assert not any(n for counts in out["launches"].values() for n in counts.values())


def test_auto_mesh_solves_rehearsal(chip_smoke, monkeypatch):
    """23b's default-mesh leg over four CPU placements standing in for
    the cards: ``active_mesh`` gives them unless ``SHARDED`` is off, the
    plans equal the one-device path's, and the mode and the installed
    mesh are restored after."""
    from karpenter_core_tpu_torch.solver import sharding

    for env in ("KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    mesh = sharding.make_mesh(4, devices=["cpu"] * 4)
    monkeypatch.setattr(sharding, "active_mesh", lambda backend: None if sharding.SHARDED == "off" else mesh)
    out = chip_smoke.auto_mesh_solves(4, reps=1, sizes={"serving": (60, 24), "cluster": (300, 60, 20)},
                                      device="cpu")
    assert out["plans_equal"] and set(out["legs"]) == {
        f"{world}-memo-{memo}@{mode}" for world in ("serving", "cluster") for memo in ("on", "off")
        for mode in ("off", "auto")}
    assert all(len(leg["warm_ms_runs"]) == 1 and leg["nodes"] > 0 for leg in out["legs"].values())
    assert sharding.SHARDED == "auto" and sharding.install_mesh(None) is None


def test_across_cards_needs_the_cards(chip_smoke):
    import torch

    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(SystemExit):
        chip_smoke.run_cards_across(2)


@pytest.mark.parametrize("D", [4, 8])
def test_dryrun_reference_is_the_jax_package(chip_smoke, D):
    """``DRYRUN_REFERENCE`` is what ``__graft_entry__.dryrun_multichip``'s
    sequence gives on the JAX package's D host devices."""
    mesh = ref_sharding.make_mesh(D)
    rng = np.random.RandomState(0)
    G, P, R, F = 2 * D, 64, 4, 4
    requests = rng.randint(1, 1000, size=(G, P, R)).astype(np.int32)
    requests[..., 2] = 1
    frontiers = np.broadcast_to(np.array([[4000, 4000, 16, 4000]] * F, dtype=np.int32), (G, F, R)).copy()
    caps = np.full(G, 1 << 30, dtype=np.int32)
    ids, _, fleet_total = ref_sharding.sharded_batch_pack(
        mesh, jnp.asarray(requests), jnp.asarray(frontiers), jnp.asarray(caps))
    sig = (rng.rand(16, 128) > 0.5).astype(np.float32)
    typ = (rng.rand(64, 128) > 0.5).astype(np.float32)
    overlap = np.asarray(ref_sharding.sharded_compat(mesh, jnp.asarray(sig), jnp.asarray(typ)))
    N = D * 8
    loads = rng.randint(1, 50, size=(N, R)).astype(np.int32)
    free = rng.randint(0, 40, size=(N, R)).astype(np.int32)
    fleet_local = rng.randint(0, 100, size=(D, R)).astype(np.int32)
    cap = np.array([200, 200, 16, 200], dtype=np.int32)
    feasible = np.asarray(ref_sharding.sharded_prefix_screen(
        mesh, *(jnp.asarray(a) for a in (loads, free, fleet_local, cap))))
    assert chip_smoke.DRYRUN_REFERENCE[D] == {
        "fleet_total": int(fleet_total), "overlap_sum": int(overlap.sum()), "feasible": int(feasible.sum()),
        "ids_sha256": hashlib.sha256(np.asarray(ids).astype(np.int32).tobytes()).hexdigest()[:16]}


@pytest.mark.parametrize("args", [["--phases", "22", "--cards", "4"], ["--phases", "23", "--cards", "1"],
                                  ["--cards", "4"]])
def test_cards_takes_phase_23_alone(args):
    """``--cards`` fails before it prints anything unless it comes with
    ``--phases 23`` alone and two or more cards."""
    run = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"), *args], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 1 and "--cards" in run.stderr and run.stdout == ""


def test_launch_roles_passes_the_card_on(chip_smoke):
    """Phases 16c and 17b count each kernel's launches by thread through
    a spy on ``CudaKernel.launch``; the spy hands the launch its card
    (``device=``), as every wrapper now names it."""
    from karpenter_core_tpu_torch.buildlib import CudaKernel

    class Kernel(CudaKernel):
        def __init__(self):
            self.seen = []

        def launch(self, *args, device=None):
            self.seen.append((args, device))

    kernel = Kernel()
    with chip_smoke.launch_roles({"k": kernel}) as roles:
        kernel.launch(1, 2, device="cuda:1")
        kernel.launch(3)
    assert kernel.seen == [((1, 2), "cuda:1"), ((3,), None)]
    assert roles.counts == {"k": {"tick": 2, "prewarm": 0}}
    assert "launch" not in vars(kernel)
