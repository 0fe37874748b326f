"""The port's metrics registry and scrapers ≡ the JAX package's.

- every test of ``tests/test_metrics_store.py`` runs from its own
  source twice, once as written and once on the port (series created on
  scrape, replaced on change, deleted with their object);
- ``Metrics`` has the same families in the same order, with the same
  names, help texts, label names and buckets, and after the same seeded
  observations on every family (counters, gauges, histograms, labelled
  and not, values escaped) ``Registry.expose()`` is byte-equal;
- the orphan-span collector reads each package's own tracer, and the
  latency buckets follow the constant that stands for the reference's
  environment knob;
- ``MetricsStore`` scrapes of the same cluster (nodes with bound and
  daemonset pods, a deleted node, pools with limits and usage, pods in
  every phase) give byte-equal text.

Every comparison here is exact.
"""

from __future__ import annotations

import importlib
import random

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_oracle import _port_helpers, same_start

FILE = "test_metrics_store.py"
CASES = mirror_cases(FILE)


def test_mirror_covers_the_file():
    assert len(CASES) == 6


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_metrics_store_case_on_both_packages(monkeypatch, case):
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        run_mirrored(mirror(FILE, pkg), *case)


def registry(pkg: str):
    return importlib.import_module(f"{pkg}.metrics.registry")


def fresh_metrics(pkg: str):
    """``Metrics`` of ``pkg`` with its tracer's orphan counter at 0: the
    orphan-span line reads each package's process-wide counter, which
    other tests in the same process move."""
    importlib.import_module(f"{pkg}.tracing.tracer").reset_orphans()
    return registry(pkg).Metrics()


def families(m) -> list:
    return [x for x in m.registry.metrics if hasattr(x, "label_names")]


def describe(m) -> list:
    return [
        (type(x).__name__, x.name, x.help, x.label_names, tuple(getattr(x, "buckets", ()) or ()))
        for x in families(m)
    ]


def test_same_families():
    ref, port = registry(REF).Metrics(), registry(PORT).Metrics()
    assert len(families(ref)) == 60
    assert describe(port) == describe(ref)
    assert [type(x).__name__ for x in port.registry.metrics] == [
        type(x).__name__ for x in ref.registry.metrics
    ]


def observe_all(m, seed: int) -> None:
    """Seeded observations on every family of ``m``: 1–3 label sets,
    values from each metric type's domain, a label value that needs
    escaping, histogram values across the buckets and past the last."""
    rng = random.Random(seed)
    for x in families(m):
        for _ in range(rng.randint(1, 3)):
            labels = {
                n: rng.choice(["a", "b", 'q"uo\\te', "new\nline"]) for n in x.label_names
            }
            kind = type(x).__name__
            for _ in range(rng.randint(1, 4)):
                v = rng.choice([0.0, 0.003, 0.04, 0.7, 3.0, 42.0, 900.0, rng.random() * 100])
                if kind == "Counter":
                    x.inc(v, **labels)
                elif kind == "Gauge":
                    x.set(v, **labels)
                else:
                    x.observe(v, **labels)


@pytest.mark.parametrize("seed", range(3))
def test_exposition_byte_equal(seed):
    texts = {}
    for pkg in (REF, PORT):
        m = fresh_metrics(pkg)
        observe_all(m, seed)
        texts[pkg] = m.registry.expose()
    assert texts[REF].count("\n") > 400
    assert texts[PORT] == texts[REF]


def test_orphan_collector_reads_own_tracer():
    texts = {}
    for pkg in (REF, PORT):
        tracer = importlib.import_module(f"{pkg}.tracing.tracer")
        tracer.reset_orphans()
        for name in ("x", "y", "z"):
            with tracer.span(name):
                pass
        texts[pkg] = registry(pkg).Metrics().registry.expose()
        assert "karpenter_tpu_tracer_orphan_spans_total 3.0" in texts[pkg]
        tracer.reset_orphans()
    assert texts[PORT] == texts[REF]


@pytest.mark.parametrize("raw", ["", "1,5,10,50,100,500,1000", "250, 2.5 ,40", "oops", "-1,5"])
def test_latency_buckets_follow_the_constant(monkeypatch, raw):
    """The reference reads KARPENTER_TPU_LATENCY_BUCKETS_MS when Metrics
    is built; the port reads LATENCY_BUCKETS_MS: equal text for equal
    values, invalid lists falling back alike."""
    monkeypatch.setenv("KARPENTER_TPU_LATENCY_BUCKETS_MS", raw)
    monkeypatch.setattr(registry(PORT), "LATENCY_BUCKETS_MS", raw)
    texts = {}
    for pkg in (REF, PORT):
        m = fresh_metrics(pkg)
        for v in (0.0004, 0.003, 0.02, 0.3, 7.0):
            m.serving_decision_latency.observe(v)
            m.fleet_decision_latency.observe(v)
        texts[pkg] = m.registry.expose()
    assert texts[PORT] == texts[REF]


def scraped_world(pkg: str) -> str:
    """One cluster, scraped twice with changes between: → the text of
    the second scrape."""
    h = importlib.import_module("helpers") if pkg == REF else _port_helpers()
    client = importlib.import_module(f"{pkg}.kube.client")
    cluster_mod = importlib.import_module(f"{pkg}.state.cluster")
    informers = importlib.import_module(f"{pkg}.state.informers")
    pq = importlib.import_module(f"{pkg}.kube.quantity").parse_quantity
    store_mod = importlib.import_module(f"{pkg}.metrics.store")
    kube = client.KubeClient(clock=lambda: 500.0)
    cluster = cluster_mod.Cluster(kube, None, clock=lambda: 500.0)
    inf = informers.Informers(kube, cluster)
    inf.start()
    m = fresh_metrics(pkg)
    store = store_mod.MetricsStore(m)
    nodes = []
    for i in range(4):
        node = h.make_node(
            name=f"node-{i}", capacity={"cpu": str(4 + i), "memory": f"{8 + i}Gi", "pods": "20"},
            provider_id=f"fake:///n{i}",
        )
        node.status.allocatable = {"cpu": pq(f"{3 + i}"), "memory": pq(f"{7 + i}Gi"), "pods": pq("20")}
        kube.create(node)
        nodes.append(node)
        for j in range(i + 1):
            kube.create(h.make_pod(
                name=f"app-{i}-{j}", requests={"cpu": "250m", "memory": "128Mi"},
                limits={"cpu": "500m"}, node_name=node.name, phase="Running",
                pending_unschedulable=False,
            ))
        kube.create(h.make_pod(
            name=f"ds-{i}", requests={"cpu": "100m"}, node_name=node.name, owner_kind="DaemonSet",
            phase="Running", pending_unschedulable=False,
        ))
    for i, phase in enumerate(("Pending", "Succeeded", "Failed")):
        pod = h.make_pod(name=f"other-{i}", phase=phase)
        pod.metadata.creation_timestamp = 100.0
        kube.create(pod)
    for i in range(2):
        pool = h.make_nodepool(f"pool-{i}", limits={"cpu": str(100 * (i + 1))})
        pool.status.resources = {"cpu": pq(str(10 * i)), "memory": pq("1Gi")}
        kube.create(pool)
    store.scrape_nodes(cluster)
    store.scrape_nodepools(kube)
    store.scrape_pods(kube)
    kube.delete(nodes[0])
    kube.delete("NodePool", "pool-0")
    started = kube.get("Pod", "other-0", namespace="default")
    started.status.phase = "Running"
    started.status.start_time = 103.5
    kube.apply(started)
    store.scrape_nodes(cluster)
    store.scrape_nodepools(kube)
    store.scrape_pods(kube)
    inf.stop()
    return m.registry.expose()


def test_scrapes_byte_equal(monkeypatch):
    texts = {}
    for pkg in (REF, PORT):
        same_start(monkeypatch)
        texts[pkg] = scraped_world(pkg)
    assert 'karpenter_nodes_total_daemon_requests{node="node-3",resource="cpu"} 0.1' in texts[REF]
    assert 'node="node-0"' not in texts[REF]
    assert "karpenter_pods_startup_time_seconds_count 1" in texts[REF]
    assert texts[PORT] == texts[REF]
