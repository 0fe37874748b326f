"""The concurrency and pipeline-safety families of the port's analyzer,
and its lock witness, against the JAX package's on the CPU.

``tests/test_concurrency.py`` and ``tests/test_pipelinesafety.py`` run as
mirrors on the port (``test_torch_analysis.dual``: every fixture run
equal to the reference's); the concurrency mutation harness is seeded
into the port's sources, one case a mutant (``port_harness``), each
killed. ``tests/test_lockwitness.py`` needs the witness installed in the
test process, which the reference's witness already patches; the port's
witness is exercised here on its own objects (wrappers, edge recording,
the verify gate, the inventory and the static graph) and installed for
real in a fresh interpreter by ``test_torch_witness.py``.
"""

from __future__ import annotations

import threading

import pytest

from test_torch_analysis import (
    PORT,
    analysis_mirror,
    case_id,
    mirror_cases,
    mutant_ids,
    mutant_killed,
    port_harness,
    run_case,
)

FILE = "test_concurrency.py"
CASES = [c for c in mirror_cases(FILE) if c[1] != "test_mutation_kill_rate"]
HARNESS, MUTANTS = port_harness(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 15 and len(MUTANTS) == 7


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_concurrency_case_holds_the_port(case, tmp_path):
    run_case(HARNESS, case, tmp_path)


@pytest.mark.parametrize("mutant", MUTANTS, ids=mutant_ids(MUTANTS))
def test_concurrency_mutant_is_killed(mutant, tmp_path):
    mutant_killed(HARNESS, mutant, str(tmp_path))


PS_FILE = "test_pipelinesafety.py"
PS_CASES = mirror_cases(PS_FILE)


@pytest.mark.parametrize("case", PS_CASES, ids=[case_id(c) for c in PS_CASES])
def test_pipelinesafety_case_holds_the_port(case, tmp_path):
    run_case(analysis_mirror(PS_FILE), case, tmp_path)


# -- the port's static lock-order graph -----------------------------------------

L = f"{PORT}/"


def test_static_graph_holds_the_kernel_launch_edges():
    """A kernel launch takes its ``CudaKernel``'s lock (the launch count),
    reached through module-level kernel instances and ``super().launch``:
    under the pack backend's lock (every pack) and under the catalog lock
    (the compat launch reads the entry's device planes) — the edges the
    witness observed on the card."""
    from karpenter_core_tpu_torch.analysis.concurrency import static_order_graph

    graph = static_order_graph()
    for src in ("solver/backends/__init__.py::PackBackend.lock", "solver/solver.py::_CATALOG_LOCK"):
        assert (L + src, L + "buildlib.py::CudaKernel._lock") in graph
    assert (L + "buildlib.py::CudaKernel._lock", L + "buildlib.py::_LIBS_LOCK") in graph


def test_static_graph_is_acyclic():
    from karpenter_core_tpu_torch.analysis.concurrency import static_order_graph

    adj: dict = {}
    for src, dst in static_order_graph():
        adj.setdefault(src, set()).add(dst)
    state: dict = {}

    def visit(node, stack):
        state[node] = 1
        for nxt in adj.get(node, ()):
            assert state.get(nxt) != 1, f"lock-order cycle: {stack + [nxt]}"
            if state.get(nxt) != 2:
                visit(nxt, stack + [nxt])
        state[node] = 2

    for node in list(adj):
        if state.get(node) != 2:
            visit(node, [node])


def test_inventory_instruments_coordination_locks_only():
    from karpenter_core_tpu_torch.analysis.concurrency import lock_inventory, witness_inventory

    sinks = {d.lock_id for d in lock_inventory() if d.sink}
    instrumented = {lock_id for lock_id, _kind in witness_inventory().values()}
    assert len(instrumented) >= 15 and not (instrumented & sinks)
    for lock in ("buildlib.py::_LIBS_LOCK", "buildlib.py::CudaKernel._lock", "solver/backend.py::_MANIFEST_LOCK",
                 "fleet/megasolve.py::_MegaDispatcher._cv", "state/cluster.py::Cluster._mu"):
        assert L + lock in instrumented


def test_reference_graph_is_the_reference_analyzers():
    """Given the reference's paths, the port's analyzer builds the
    reference's lock-order graph and inventory, row for row."""
    from karpenter_core_tpu.analysis.concurrency import lock_inventory as ref_inventory
    from karpenter_core_tpu.analysis.concurrency import static_order_graph as ref_graph
    from karpenter_core_tpu_torch.analysis.concurrency import lock_inventory, static_order_graph
    from test_torch_analysis import reference_config

    cfg = reference_config()
    assert static_order_graph(config=cfg) == ref_graph()
    assert [(d.lock_id, d.kind, d.relpath, d.line, d.sink) for d in lock_inventory(config=cfg)] == [
        (d.lock_id, d.kind, d.relpath, d.line, d.sink) for d in ref_inventory()]


# -- the port's lock witness, on its own objects ----------------------------------


@pytest.fixture
def edges():
    from karpenter_core_tpu_torch.analysis import lockwitness

    with lockwitness._edges_mu:
        saved = (set(lockwitness._edges), set(lockwitness._acquired))
    yield lockwitness
    with lockwitness._edges_mu:
        lockwitness._edges.clear()
        lockwitness._edges.update(saved[0])
        lockwitness._acquired.clear()
        lockwitness._acquired.update(saved[1])


def test_nested_acquisition_records_one_edge(edges):
    lw = edges
    outer = lw._WitnessLock(lw._REAL_LOCK(), "t::outer")
    inner = lw._WitnessLock(lw._REAL_RLOCK(), "t::inner")
    with outer:
        with inner:
            with inner:  # reentrant: no self edge
                pass
    assert ("t::outer", "t::inner") in lw.observed_edges()
    assert ("t::inner", "t::inner") not in lw.observed_edges()
    assert {"t::outer", "t::inner"} <= lw.observed_locks()


def test_condition_wait_does_not_invent_edges(edges):
    lw = edges
    outer = lw._WitnessLock(lw._REAL_LOCK(), "t::outer")
    cond = lw._WitnessCondition(lw._REAL_CONDITION(), "t::cond")
    with outer:
        with cond:
            cond.wait(timeout=0.01)
    assert ("t::outer", "t::cond") in lw.observed_edges()
    assert ("t::cond", "t::outer") not in lw.observed_edges()


def test_edges_are_per_thread(edges):
    lw = edges
    a = lw._WitnessLock(lw._REAL_LOCK(), "t::a")
    b = lw._WitnessLock(lw._REAL_LOCK(), "t::b")
    with a:
        t = threading.Thread(target=lambda: b.acquire() and b.release())
        t.start()
        t.join(timeout=5)
    assert ("t::a", "t::b") not in lw.observed_edges()


def test_verify_gate_flags_an_unpredicted_edge(edges):
    lw = edges
    bogus = (L + "kube/client.py::KubeClient._lock", L + "state/cluster.py::Cluster._mu")
    with lw._edges_mu:
        lw._edges.add(bogus)
    observed, unexplained = lw.verify_against_static()
    assert bogus in observed and bogus in unexplained


def test_witness_lock_protocol_delegates(edges):
    lw = edges
    lock = lw._WitnessLock(lw._REAL_LOCK(), "t::proto")
    assert lock.acquire(blocking=False) and lock.locked()
    lock.release()
    assert not lock.locked() and "t::proto" in repr(lock)
