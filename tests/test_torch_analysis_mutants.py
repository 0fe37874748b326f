"""``tests/test_cachesound.py``'s mutation harness on the port's sources,
first half: each mutant (a dropped key component, a deleted generation
bump, a salted or unordered fingerprint, a blind restore) seeded into a
copy of the port's modules must be killed by the port's analyzer — a new
finding of the expected rule. The second half, and the concurrency and
configprov harnesses, are in ``test_torch_analysis_mutants_b.py``,
``test_torch_analysis_concurrency.py`` and ``test_torch_analysis_config.py``
(split for time, not cut: see ``test_torch_analysis.port_harness``)."""

from __future__ import annotations

import pytest

from test_torch_analysis import mutant_ids, mutant_killed, port_harness

MOD, MUTANTS = port_harness("test_cachesound.py")
HALF = len(MUTANTS) // 2


def test_the_harness_seeds_every_reference_mutant_with_a_counterpart():
    names = [m[0] for m in MOD._MUTANTS]
    assert len(names) == len(set(names)) == 35
    assert "route-key-drop-enginetoken" not in names


@pytest.mark.parametrize("mutant", MUTANTS[:HALF], ids=mutant_ids(MUTANTS[:HALF]))
def test_mutant_is_killed(mutant, tmp_path):
    mutant_killed(MOD, mutant, str(tmp_path))
