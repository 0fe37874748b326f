"""The cache-soundness family of the port's analyzer
(``karpenter_core_tpu_torch/analysis/cachesound.py``) against the JAX
package's: ``tests/test_cachesound.py``'s fixture and full-repo cases as
mirrors on the port (``test_torch_analysis.dual``: every fixture run
equal to the reference's), its mutation harness seeded into the port's
sources (``test_torch_analysis_mutants*.py``), and the port's own
container factory (a per-device ``LRU`` made by a module function).

Not mirrored: the tracer-safety ``static_argnums`` cases (the next
slice's rule) and the mutation harness's single kill-rate test, replaced
by one case a mutant. The reference's CLI smoke also requires its
``hack/analyze.sh``; the port adds no script there, so that line is not
mirrored.
"""

from __future__ import annotations

import textwrap

import pytest

from test_torch_analysis import PORT, analysis_mirror, case_id, mirror_cases, run_case

FILE = "test_cachesound.py"
SKIP = ("test_mutation_kill_rate", "test_static_argnums")
CASES = [c for c in mirror_cases(FILE) if not c[1].startswith(SKIP)]
REPLACE = (('    assert os.access(os.path.join(REPO, "hack", "analyze.sh"), os.X_OK)\n', ""),)


def test_mirror_covers_the_file():
    assert len(CASES) == 28


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_cachesound_case_holds_the_port(case, tmp_path):
    run_case(analysis_mirror(FILE, REPLACE), case, tmp_path)


FACTORY = """
    from incremental import LRU

    _PLANES = {}

    def plane_for(device):
        plane = _PLANES.get(device)
        if plane is None:
            plane = _PLANES.setdefault(device, LRU("lprelax"))
        return plane

    def relax(reqs, prices, iters, device, stats):
        key = (reqs.tobytes(), __KEY__)
        plane = plane_for(device)
        hit = plane.get(key, stats)
        if hit is not None:
            return hit
        value = reqs.sum() * prices.sum() * iters
        plane.put(key, value, stats)
        return value
"""


@pytest.mark.parametrize("key,unwitnessed", [
    ("prices.tobytes(), int(iters)", []),
    ("prices.tobytes()", ["iters"]),
    ("int(iters)", ["prices"]),
])
def test_container_factory_sites_are_held(tmp_path, key, unwitnessed):
    """The port's ``lprelax`` memo lives in a per-device plane a module
    function makes (``backends/lp.py::relax_plane``): a local assigned from
    such a factory is that container, so its memo sites are held to their
    read-set like any other."""
    from karpenter_core_tpu_torch.analysis import analyze_paths

    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(FACTORY.replace("__KEY__", key)))
    report = analyze_paths([str(p)], root=str(tmp_path), rules=["cache-key"])
    got = sorted(f.message.split("input '")[1].split("'")[0] for f in report.findings)
    assert got == unwitnessed, [f.format() for f in report.findings]


def test_the_port_lprelax_memo_is_a_detected_site():
    from karpenter_core_tpu_torch.analysis.cachesound import _shared_analyzer, _shared_sites
    from karpenter_core_tpu_torch.analysis.engine import DEFAULT_CONFIG, ProjectContext, repo_root

    an = _shared_analyzer(ProjectContext([], repo_root(), DEFAULT_CONFIG))
    sites = {(site.fn.ctx.relpath, site.spec.name) for site in _shared_sites(an).values()}
    assert (f"{PORT}/solver/backends/lp.py", "lprelax") in sites
    assert "relax_plane" in an.registry.factories
