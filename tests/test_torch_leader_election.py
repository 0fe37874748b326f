"""The port's leader election ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/operator/leaderelection.py`` is the port's
copy of the JAX package's ``LeaderElector``, over the port's
``KubeClient`` and ``Lease``. Held:

- ``TestLeaderElector`` of ``tests/test_leader_election.py`` runs from
  its own source on the port (``mirror``): acquire, renew, expiry and
  transition, release and hand-off, a superseded release, callbacks.
- seeded sequences of election steps, releases and clock moves by three
  candidates on one store, in both packages: every step's outcome, each
  candidate's leadership, its callbacks and the stored lease are equal;
- ``TestOperatorElection`` and ``TestOperationalServer`` run from their
  own source on the port's ``Operator`` (on the CPU): only the leader's
  controllers reconcile, a follower takes over after a release, a
  stopped and restarted operator serves and reconciles again, and the
  served surface answers ``/metrics``, the probes and the pprof pair;
- the same over the port's REST adapter against the port's stub
  apiserver: the lease round-trips the codec and the outcomes equal the
  in-memory store's.
"""

from __future__ import annotations

import importlib
import random

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_operator import operator_mirror
from test_torch_restclient import restclient_mirror

FILE = "test_leader_election.py"
CASES = mirror_cases(FILE, ("TestLeaderElector",))


def election_mirror():
    return mirror(FILE, PORT, replace=(("from {pkg}.operator import Operator, Options\n", ""),))


def test_mirror_covers_the_class():
    assert len(CASES) == 6


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_leader_election_case_holds_the_port(case):
    run_mirrored(election_mirror(), *case)


def test_operator_package_exports_the_elector():
    from karpenter_core_tpu_torch import operator
    from karpenter_core_tpu_torch.operator.leaderelection import LeaderElector

    assert operator.LeaderElector is LeaderElector
    assert operator.LEASE_NAME == importlib.import_module(f"{REF}.operator.leaderelection").LEASE_NAME
    ref = importlib.import_module(f"{REF}.operator")
    for name in ("Operator", "Options", "SingletonController"):
        assert getattr(operator, name).__name__ == getattr(ref, name).__name__
    assert not hasattr(operator, "_NOT_PORTED")


# -- the operator's election and served surface, on the port ----------------------

OPERATOR_CLASSES = ("TestOperatorElection", "TestOperationalServer")
OPERATOR_CASES = mirror_cases(FILE, OPERATOR_CLASSES)


def operator_election_mirror():
    return operator_mirror(FILE, replace=(('    @pytest.fixture(scope="class")\n', ""),))


def test_operator_mirror_covers_the_classes():
    assert len(OPERATOR_CASES) == 9
    assert {c[0] for c in OPERATOR_CASES} == set(OPERATOR_CLASSES)


@pytest.fixture(scope="module")
def served_operator():
    """``TestOperationalServer``'s class fixture on the port: one started
    operator (ephemeral ports, profiling on) for the class's cases."""
    mod = operator_election_mirror()
    gen = mod.TestOperationalServer().op()
    op = next(gen)
    yield op
    for _ in gen:
        pass


@pytest.mark.parametrize("case", OPERATOR_CASES, ids=[case_id(c) for c in OPERATOR_CASES])
def test_operator_election_case_holds_the_port(request, case):
    extra = {"op": request.getfixturevalue("served_operator")} if case[0] == "TestOperationalServer" else None
    run_mirrored(operator_election_mirror(), *case, extra=extra)


def election_steps(pkg: str, seed: int, kube=None) -> list:
    """Three candidates on one store (``kube``; None: ``pkg``'s in-memory
    store) driven by ``random.Random(seed)`` → per step the action, its
    outcome, every candidate's leadership and the stored lease."""
    le = importlib.import_module(f"{pkg}.operator.leaderelection")
    if kube is None:
        kube = importlib.import_module(f"{pkg}.kube.client").KubeClient()
    now = [1000.0]
    events: list = []
    electors = [
        le.LeaderElector(kube, holder_id=h, clock=lambda: now[0], lease_duration=15.0,
                         on_started_leading=lambda h=h: events.append(("started", h)),
                         on_stopped_leading=lambda h=h: events.append(("stopped", h)))
        for h in ("a", "b", "c")
    ]
    rng = random.Random(seed)
    log = []
    for _ in range(60):
        action = rng.choice(("step", "step", "step", "release", "advance"))
        who = rng.randrange(3)
        if action == "step":
            outcome = electors[who].try_acquire_or_renew()
        elif action == "release":
            outcome = electors[who].release()
        else:
            now[0] += rng.choice((1.0, 5.0, 16.0))
            outcome = now[0]
        lease = kube.get("Lease", le.LEASE_NAME, namespace="default")
        stored = None if lease is None else (
            lease.holder, lease.lease_duration_seconds, lease.acquire_time, lease.renew_time,
            lease.lease_transitions)
        log.append((action, who, outcome, [e.is_leader() for e in electors], stored))
    return log + [("events", events)]


@pytest.mark.parametrize("seed", range(8))
def test_election_steps_equal_reference(seed):
    assert election_steps(PORT, seed) == election_steps(REF, seed)


def test_election_over_the_rest_adapter_equals_the_store():
    """The lease's times cross the wire as RFC 3339 with microseconds, so
    the whole-second clock of these steps round-trips exactly."""
    from karpenter_core_tpu_torch.kube.restclient import RestKubeClient

    stub = restclient_mirror()._StubApiServer()
    kube = RestKubeClient(stub.url)
    try:
        assert election_steps(PORT, 3, kube=kube) == election_steps(PORT, 3)
    finally:
        kube.close()
        stub.stop()
