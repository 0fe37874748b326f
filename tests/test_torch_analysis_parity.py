"""The slice as a whole: the port's analyzer, given the reference's
paths and knob prefix (``test_torch_analysis.reference_config``), over
the unmodified ``karpenter_core_tpu/`` gives exactly the reference
analyzer's findings for every rule this slice ports — same order, same
fields, in every disposition — and its runtime-witness surfaces (the
lock-order graph, the lock inventory, the knob registry) row for row.
That includes ``host-sync``, given the reference's sync vocabulary
(``reference_config``). The control-plane import rule is named
``torch-host-only`` in the port (``jnp-host-only`` in the reference).
The reference's two jax-construct rules (``JAX_RULES``) are left out:
their port counterparts read the port's own constructs."""

from __future__ import annotations

import os

import pytest

from test_torch_analysis import JAX_RULES, REPO, RULE_NAMES, _row, reference_config

REF_PKG = os.path.join(REPO, "karpenter_core_tpu")


@pytest.fixture(scope="module")
def reports():
    from karpenter_core_tpu.analysis import analyze_paths as ref_analyze
    from karpenter_core_tpu.analysis import registered_rules as ref_rules
    from karpenter_core_tpu_torch.analysis import analyze_paths, registered_rules

    port_rules = sorted(r for r in registered_rules() if RULE_NAMES.get(r, r) not in JAX_RULES)
    ref_names = sorted(r for r in ref_rules() if r not in JAX_RULES)
    assert sorted(RULE_NAMES.get(r, r) for r in port_rules) == ref_names
    port = analyze_paths([REF_PKG], root=REPO, config=reference_config(), rules=port_rules)
    ref = ref_analyze([REF_PKG], root=REPO, rules=ref_names)
    return port, ref


def test_files_and_errors_are_the_references(reports):
    port, ref = reports
    assert port.files_scanned == ref.files_scanned > 100
    assert port.parse_errors == ref.parse_errors == []


@pytest.mark.parametrize("part", ["findings", "suppressed", "baselined"])
def test_every_disposition_is_the_references(reports, part):
    port, ref = reports
    assert [_row(f) for f in getattr(port, part)] == [_row(f) for f in getattr(ref, part)]


def test_the_reference_tree_is_held_to_its_own_baseline_by_the_port():
    """With the reference's own baseline the port's analyzer finds the
    reference's tree clean, as the reference's does."""
    from karpenter_core_tpu.analysis import Baseline
    from karpenter_core_tpu.analysis.engine import default_baseline_path
    from karpenter_core_tpu_torch.analysis import Baseline as PortBaseline
    from karpenter_core_tpu_torch.analysis import analyze_paths, registered_rules

    entries = Baseline.load(default_baseline_path()).entries
    report = analyze_paths([REF_PKG], root=REPO, config=reference_config(),
                           baseline=PortBaseline([dict(e) for e in entries]), rules=sorted(registered_rules()))
    assert report.findings == [] and report.stale_baseline == [] and len(report.baselined) == len(entries) == 2


def test_host_sync_is_the_references(reports):
    """``host-sync`` over the reference's tree, as its own analyzer reads
    it: its twelve marked syncs suppressed, nothing active or baselined."""
    port, ref = reports
    rows = {part: [_row(f) for f in getattr(port, part) if f.rule == "host-sync"]
            for part in ("findings", "suppressed", "baselined")}
    assert {part: len(r) for part, r in rows.items()} == {"findings": 0, "suppressed": 12, "baselined": 0}
    assert rows["suppressed"] == [_row(f) for f in ref.suppressed if f.rule == "host-sync"]
