"""``chip_smoke.py``'s phase 21 (bench config 12, the sharded mega-solve),
cut down, on the CPU.

The card runs phase 21 at shardbench's size (500,000–1,000,000 pods ×
10,000 types, D ∈ {1, 2, 4, 8}); here ``run_shard_phase`` runs on
``device="cpu"`` (the kernels' plain versions) with cells of 2,000 and
3,000 pods × 300 types, so the phase's own checks run: every pod
scheduled and every node within its chosen type, bytes across the shard
boundary, the unchunked node ratio, the largest cell's chunked pack
against D solo packs, the solve on an 8-shard mesh (the stats and the
gauge set), the dryrun's sequence, and no launch off the card. Each check fails the phase through
``chip_smoke.fail`` (``SystemExit``). Tolerance: exact equality.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase21", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shard_phase_cut_down(chip_smoke, monkeypatch):
    from karpenter_core_tpu_torch.solver import sharding

    for env in ("KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_INCREMENTAL"):
        monkeypatch.delenv(env, raising=False)
    cells = ((2000, 300, 1), (2000, 300, 8), (3000, 300, 8), (2000, 120, 8))
    out = chip_smoke.run_shard_phase("cpu", cells=cells, keep=((2000, 300, 8),), reps=2,
                                     ratio=(600, 300, 2, 8), solve=(300, 30, 64))
    assert [(r["pods"], r["types"], r["n_devices"]) for r in out["curve"]] == list(cells)
    for r in out["curve"]:
        assert r["scheduled"] == r["pods"] and r["reps"] == 2 and r["b5_ms"] is None
        assert r["shard"]["pods_used"] == r["pods"] and r["shard"]["n_devices"] == r["n_devices"]
        assert r["shard"]["types_used"] == r["types"] and r["shard_bytes"]["h2d"] > 0
    assert out["cuts"] == []
    assert (out["unchunked"]["n_devices"], out["unchunked"]["seeds"]) == (8, 2)
    assert 0.0 < out["unchunked"]["unchunked_node_ratio_min"] <= 1.0
    assert out["chunk_identity"] == {"pods": 3000, "n_devices": 8, "chunk_len": 375,
                                     "nodes": out["chunk_identity"]["nodes"], "solo_launches": 8, "identical": True}
    assert set(out["solve"]["legs"]) == {"cpu-sharded"}
    assert all(leg["mega_packs"] >= 1 for leg in out["solve"]["legs"].values())
    assert out["dryrun"]["fleet_total"] > 0
    assert out["cases"] == {}
    assert not any(n for counts in out["launches"].values() for n in counts.values())
    # the seam and the constants are back as they were
    assert sharding.active_mesh("cpu") is None
    assert (sharding.SHARD_ENGINE, sharding.SHARD_MIN_PODS) == ("sharded", 65536)


def test_shard_phase_cuts_late_cells(chip_smoke, monkeypatch):
    """Past 60 % of the budget a cell outside ``keep`` runs once, without
    its warm run, and the phase says so."""
    cells = ((1000, 100, 8), (1200, 100, 8))
    out = chip_smoke.run_shard_phase("cpu", cells=cells, keep=((1000, 100, 8),), reps=2,
                                     ratio=(200, 100, 1, 8), solve=(100, 20, 64), budget_s=0.0)
    assert [(r["reps"], r["warm"]) for r in out["curve"]] == [(2, True), (1, False)]
    assert out["cuts"] == ["1200x100 D=8: 1 measured run, no warm run"]


def test_config12_worlds_are_shardbench(chip_smoke):
    import numpy as np

    import shardbench

    for a, b in ((chip_smoke.shard_catalog(500, 4, 12), shardbench.build_catalog(500, 4, 12)),
                 ((chip_smoke.shard_pods(700, 4, 13),), (shardbench.build_pods(700, 4, 13),)),
                 (chip_smoke.shard_masks(8, 500, 14), shardbench.build_masks(8, 500, 14))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
