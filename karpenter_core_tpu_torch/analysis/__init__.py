"""Repo-native static analysis of the port's host Python.

AST rule families guard the invariants the test suite can only catch by
luck — lock discipline and order in the controller state, waits under a
lock, memo keys that witness their read-sets, knob provenance, clock
discipline, iteration-order determinism, pipeline sharing and general
hygiene. Two runtime witnesses (``lockwitness``, ``knobwitness``) check
the static lock-order graph and knob inventory against a threaded run.

Run ``python -m karpenter_core_tpu_torch.analysis`` (stdlib only: it
imports neither torch nor the package it reads), or ``--witness
--device cpu|cuda`` for the witnessed run. The tier-1 gates are
``tests/test_torch_analysis*.py`` and ``tests/test_torch_witness.py``.
Rule catalog: ``RULES.md`` next to this file; per-line suppression is
``# analysis: allow-<rule>``; grandfathered findings live in
``baseline.json``.
"""

from .engine import (  # noqa: F401
    PACKAGE,
    AnalysisConfig,
    DEFAULT_CONFIG,
    Report,
    analyze_paths,
    analyze_repo,
    default_baseline_path,
    registered_rules,
    repo_root,
)
from .findings import Baseline, Finding, SEV_ERROR, SEV_WARNING  # noqa: F401
