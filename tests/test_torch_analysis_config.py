"""The config-provenance family (knob inventory, knob docs,
config-provenance, determinism) of the port's analyzer against the JAX
package's, on the CPU.

``tests/test_configprov.py`` runs as a mirror in the port's own terms:
its package directory and knob prefix are the port's
(``KARPENTER_TORCH_*``), so its assertions hold the port's analyzer on its
own config, and every fixture run is held equal to the reference's over
a copy of the fixture tree translated back to the reference's names
(``test_torch_analysis.dual_in_port_terms``; line numbers hold, names are
the one stated difference). One fixture knob differs: the reference's
``MERGE_ENGINE`` is not a knob of the port, so its semantic-knob fixtures
read ``PACK_BACKEND``, semantic in both. Its mutation harness runs on the
port's sources, one case a mutant, each killed.

Not mirrored: ``TestKnobWitness`` (it installs the witness in the test
process, where the reference's is installed: ``test_torch_witness.py``
runs the port's in a fresh interpreter) and the wall-clock budget test
(ROADMAP C5: such a test fails under six workers; the warm run's shared
parse cache is held instead, below).
"""

from __future__ import annotations

import pytest

from test_torch_analysis import (
    PORT,
    case_id,
    dual_in_port_terms,
    mirror,
    mirror_cases,
    mutant_ids,
    mutant_killed,
    port_harness,
    run_case,
)

FILE = "test_configprov.py"
CASES = [c for c in mirror_cases(FILE)
         if c[0] != "TestKnobWitness" and c[1] not in ("test_mutation_kill_rate", "test_warm_full_analysis_fits_budget")]
REPLACE = (("KARPENTER_TPU_", "KARPENTER_TORCH_"), ("KARPENTER_TORCH_MERGE_ENGINE", "KARPENTER_TORCH_PACK_BACKEND"))
HARNESS, MUTANTS = port_harness(FILE)


def config_mirror():
    mod = mirror(FILE, PORT, replace=REPLACE)
    mod.analyze_paths = dual_in_port_terms
    return mod


def test_mirror_covers_the_file():
    assert len(CASES) == 32 and len(MUTANTS) == 8


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_configprov_case_holds_the_port(case, tmp_path):
    root = tmp_path / "t"
    root.mkdir()
    run_case(config_mirror(), case, root)


@pytest.mark.parametrize("mutant", MUTANTS, ids=mutant_ids(MUTANTS))
def test_configprov_mutant_is_killed(mutant, tmp_path):
    mutant_killed(HARNESS, mutant, str(tmp_path))


def test_semantic_knobs_are_the_ports_engine_and_backend_switches():
    """The port's semantic knobs are the knobs it reads that change a
    plan (each in the registry); the reference's are its own."""
    from karpenter_core_tpu.analysis.configprov import SEMANTIC_KNOBS as REF
    from karpenter_core_tpu_torch.analysis.configprov import SEMANTIC_KNOBS, repo_registry, semantic_knobs
    from test_torch_analysis import reference_config

    assert SEMANTIC_KNOBS <= set(repo_registry())
    assert {"KARPENTER_TORCH_PACK_BACKEND", "KARPENTER_TORCH_NATIVE"} <= SEMANTIC_KNOBS
    assert semantic_knobs(reference_config()) == REF


def test_reference_registry_rows_are_the_reference_analyzers():
    """Given the reference's paths and prefix, the port's analyzer builds
    the reference's knob registry, row for row, and its witness side."""
    from karpenter_core_tpu.analysis import configprov as ref
    from karpenter_core_tpu_torch.analysis import configprov as port
    from test_torch_analysis import reference_config

    cfg = reference_config()
    port_reg = port.repo_registry(config=cfg)
    ref_reg = ref.repo_registry()
    assert port.knob_rows(port_reg, cfg.package) == ref.knob_rows(ref_reg)
    assert port.knob_table_lines(port_reg, cfg.package) == ref.knob_table_lines(ref_reg)
    names, patterns = port.static_knob_names(config=cfg)
    ref_names, ref_patterns = ref.static_knob_names()
    assert names == ref_names and [p.pattern for p in patterns] == [p.pattern for p in ref_patterns]


def test_warm_run_reuses_the_shared_parse_cache():
    """In place of a wall-clock budget: a second full run parses no file
    again (every module's tree is the shared parse cache's, unchanged)."""
    from karpenter_core_tpu_torch.analysis import analyze_repo, engine

    analyze_repo(use_baseline=False)
    before = {path: id(entry[2]) for path, entry in engine._PARSE_CACHE.items()}
    report = analyze_repo(use_baseline=False)
    after = {path: id(entry[2]) for path, entry in engine._PARSE_CACHE.items()}
    assert report.files_scanned > 120 and len(before) >= report.files_scanned
    assert {p: after[p] for p in before} == before


def test_knob_inventory_is_the_boundary_tests():
    """One inventory: ``tests/test_torch_boundary.py``'s ``KNOBS`` is the
    analyzer's static knob names."""
    from karpenter_core_tpu_torch.analysis.configprov import static_knob_names
    from test_torch_boundary import KNOBS

    names, patterns = static_knob_names()
    assert set(KNOBS) == names and not patterns
