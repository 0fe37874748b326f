"""``tests/test_cachesound.py``'s mutation harness on the port's sources,
second half (see ``test_torch_analysis_mutants.py``)."""

from __future__ import annotations

import pytest

from test_torch_analysis_mutants import HALF, MOD, MUTANTS
from test_torch_analysis import mutant_ids, mutant_killed


@pytest.mark.parametrize("mutant", MUTANTS[HALF:], ids=mutant_ids(MUTANTS[HALF:]))
def test_mutant_is_killed(mutant, tmp_path):
    mutant_killed(MOD, mutant, str(tmp_path))
