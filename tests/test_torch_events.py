"""The port's event recorder and event builders ≡ the JAX package's.

- every test of ``tests/test_events.py`` runs from its own source twice,
  once as written and once on the port (its own assertions then hold
  the port: the builders' reasons, the dedupe window and its override,
  per-entity keys, the per-minute rate limit);
- a seeded stream of every builder's events, with time advanced between
  publishes on one fixed clock per recorder, gives the same published
  events (type, reason, message, dedupe key, involved object) and the
  same dedupe and rate-limit drops on both recorders, exactly, and the
  recorder stamps the open trace's id in both packages alike.
"""

from __future__ import annotations

import importlib
import random

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_oracle import same_start

FILE = "test_events.py"
CASES = mirror_cases(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 6


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_events_case_on_both_recorders(monkeypatch, case):
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        run_mirrored(mirror(FILE, pkg), *case)


def _objects(pkg: str):
    ob = importlib.import_module(f"{pkg}.kube.objects")
    nc = importlib.import_module(f"{pkg}.apis.nodeclaim")
    pods, nodes, claims = [], [], []
    for i in range(4):
        p = ob.Pod()
        p.metadata.name, p.metadata.namespace = f"pod-{i}", "default"
        pods.append(p)
        n = ob.Node()
        n.metadata.name = f"node-{i}"
        nodes.append(n)
        c = nc.NodeClaim()
        c.metadata.name = f"claim-{i}"
        claims.append(c)
    return pods, nodes, claims


def publish_stream(pkg: str, seed: int) -> list:
    """Every builder, in a seeded order, under one fixed clock that
    advances by seeded steps → the published events by content."""
    events = importlib.import_module(f"{pkg}.events.events")
    recorder = importlib.import_module(f"{pkg}.events.recorder")
    now = [10_000.0]
    rec = recorder.Recorder(clock=lambda: now[0], capacity=50)
    pods, nodes, claims = _objects(pkg)
    rng = random.Random(seed)
    builders = [
        lambda: events.pod_failed_to_schedule(rng.choice(pods), rng.choice(["no capacity", "taint"])),
        lambda: events.nominate_pod(rng.choice(pods), rng.choice(nodes).name),
        lambda: events.disrupt_node(rng.choice(nodes), rng.choice(["Drift", "Emptiness"]), "r"),
        lambda: events.blocked(rng.choice(nodes), "pdb", "blocked by pdb"),
        lambda: events.evict(rng.choice(pods)),
        lambda: events.node_failed_to_drain(rng.choice(nodes), RuntimeError("stuck")),
        lambda: events.insufficient_capacity(rng.choice(claims), "ice"),
        lambda: events.consistency_check_failed(rng.choice(nodes), "mismatch"),
        lambda: recorder.Event(
            reason="Chatty", message="m", dedupe_values=(str(rng.randrange(40)),),
            rate_limit_per_minute=5,
        ),
    ]
    for _ in range(300):
        rec.publish(rng.choice(builders)())
        now[0] += rng.choice([0.0, 0.5, 7.0, 40.0, 130.0])
    return [
        (e.type, e.reason, e.message, e.dedupe_key(), e.dedupe_timeout,
         getattr(e.involved_object, "name", None), e.trace_id)
        for e in rec.events
    ]


@pytest.mark.parametrize("seed", range(4))
def test_published_stream_matches_reference(seed):
    """Exact: the same events survive dedupe, rate limit and the ring."""
    ref = publish_stream(REF, seed)
    port = publish_stream(PORT, seed)
    assert len(ref) == 50  # the ring wrapped
    assert {e[1] for e in ref} >= {"Nominated", "FailedScheduling", "Chatty"}
    assert port == ref


def test_trace_id_stamped_alike():
    """Inside a trace both recorders stamp its id, outside they stamp
    the empty string; trace ids of both tracers have one form."""
    out = {}
    for pkg in (REF, PORT):
        tracer = importlib.import_module(f"{pkg}.tracing.tracer")
        recorder = importlib.import_module(f"{pkg}.events.recorder")
        rec = recorder.Recorder(clock=lambda: 1.0)
        with tracer.trace_root("root") as tr:
            rec.publish(recorder.Event(reason="In", message="m"))
        rec.publish(recorder.Event(reason="Out", message="m"))
        assert rec.events[0].trace_id == tr.trace_id
        out[pkg] = [(e.reason, e.trace_id.split("-")[1] if e.trace_id else "") for e in rec.events]
    assert out[PORT] == out[REF]
