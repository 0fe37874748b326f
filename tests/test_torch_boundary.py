"""The port stands alone: no ``jax`` and nothing of ``karpenter_core_tpu``.

An AST scan of every module of ``karpenter_core_tpu_torch`` and of
``chip_smoke.py`` finds no such import, and no environment read but of
the port's knobs (``KNOBS``, never the JAX package's
``KARPENTER_TPU_*``; its other defaults are module constants) and, in
``operator/options.py`` alone, of the upstream operator's deployment
flags (``OPERATOR_ENV``), each by its literal name; no other file of the
port names those flags. Only ``chip_smoke.py`` sets knobs (for its
phases).
A port solve against a live cluster (existing node, daemonset, NodePool
limit), whose batch also reaches the greedy fallback (soft pod
anti-affinity) and a preference-relaxation round (an impossible
preferred zone), then the same batch through the ``auto`` pack backend
with the native packer off (LP routing, the dual ascent's plain version,
the device scans' plain versions) and the LP routing calibration, and a
``Provisioner.reconcile`` through the port's whole stack (``KubeClient``,
``Informers`` into ``Cluster``, ``Recorder``, ``Metrics``, the tracer)
on its batched and its greedy path, and a disruption pass (the markers,
``DisruptionController.reconcile`` under both engines, the orchestration
queue), and an ``Operator`` started, stopped and driven through one
``reconcile_all_once``, runs in a fresh interpreter under a
meta-path hook that raises on importing either; so does the serving CLI
(``python -m karpenter_core_tpu_torch.serving.trafficgen``: a free
pipeline run, a kill and a warm resume with its boot prewarm, and a
chaos run under ``failover``), and a batched fleet round (``fleet/``:
registry, mega-solve engine, scheduler) runs in the hooked solve's
interpreter. The port's static analyzer (``analysis/``) imports the standard library
only, and ``KNOBS`` is its static knob inventory, the two witness
switches among them (read in ``witness.py`` alone). The JAX package's environment knobs of
that stack, the serving pipeline's, the flight recorder's, the boot
prewarm's, the REST adapter's watch backoff and the fleet's included,
are module constants of the port with the reference's defaults, but the
fleet engine switch and the catalog cache cap, which are knobs. No
``NotImplementedError`` names the fleet: the CLI's ``--fleet`` runs. The
operator's ``Operator``, ``Options`` and ``SingletonController`` are
ported.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "karpenter_core_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "karpenter_core_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT_DIR):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        out.extend(os.path.join(root, f) for f in sorted(files) if f.endswith(".py"))
    return out


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_sources_found():
    srcs = _sources()
    assert os.path.join(PORT_DIR, "solver", "solver.py") in srcs
    for module in ("scheduler.py", "builder.py", "nodeclaim.py", "existingnode.py", "queue.py",
                   "preferences.py", "topology.py"):
        assert os.path.join(PORT_DIR, "scheduler", module) in srcs
    assert os.path.join(PORT_DIR, "solver", "oracle_bridge.py") in srcs
    for module in ("pack.py", "plancost.py", "incremental.py", "warmstore.py", "calibrate.py",
                   os.path.join("backends", "__init__.py"), os.path.join("backends", "lp.py")):
        assert os.path.join(PORT_DIR, "solver", module) in srcs
    assert os.path.join(PORT_DIR, "native", "__init__.py") in srcs
    for module in (
        ("kube", "client.py"), ("events", "recorder.py"), ("events", "events.py"),
        ("utils", "pretty.py"), ("tracing", "tracer.py"), ("metrics", "registry.py"),
        ("metrics", "store.py"), ("state", "cluster.py"), ("state", "informers.py"),
        ("provisioning", "batcher.py"), ("provisioning", "provisioner.py"),
        ("serving", "__init__.py"), ("serving", "queues.py"), ("serving", "latency.py"),
        ("serving", "pipeline.py"), ("serving", "trafficgen.py"), ("tracing", "flightrec.py"),
        ("solver", "stats.py"), ("solver", "prewarm.py"),
        ("kube", "faults.py"), ("kube", "codec.py"), ("kube", "restclient.py"),
        ("operator", "__init__.py"), ("operator", "leaderelection.py"),
        ("operator", "options.py"), ("operator", "logging.py"), ("operator", "controller.py"),
        ("operator", "server.py"), ("operator", "operator.py"), ("lifecycle", "__init__.py"),
        ("lifecycle", "nodeclaim_lifecycle.py"), ("lifecycle", "nodeclaim_termination.py"),
        ("lifecycle", "nodeclaim_gc.py"), ("lifecycle", "node_termination.py"), ("lifecycle", "consistency.py"),
        ("lifecycle", "lease_gc.py"), ("apis", "validation.py"), ("apis", "duration.py"),
        ("cloudprovider", "metrics.py"), ("tracing", "export.py"), ("metrics", "textcheck.py"),
        ("fleet", "__init__.py"), ("fleet", "registry.py"), ("fleet", "megasolve.py"), ("fleet", "scheduler.py"),
    ):
        assert os.path.join(PORT_DIR, *module) in srcs
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    assert len(srcs) > 20


# the port's environment knobs: the pack backend, the native packer's
# switch, the auto backend's threshold override, the warm state's kill
# switch, the disruption engine, the fleet engine and the catalog cache cap;
# and the two witness switches, read by the witnessed run's entry point
# (``witness.py``) where the JAX package reads their twins (its
# ``tests/conftest.py``). The port's analyzer inventories the same names
# (``test_knobs_are_the_analyzers_inventory``).
KNOBS = (
    "KARPENTER_TORCH_PACK_BACKEND", "KARPENTER_TORCH_NATIVE", "KARPENTER_TORCH_LP_MIN_WORK",
    "KARPENTER_TORCH_INCREMENTAL", "KARPENTER_TORCH_DISRUPT_ENGINE", "KARPENTER_TORCH_FLEET_ENGINE",
    "KARPENTER_TORCH_CATALOG_CACHE_MAX", "KARPENTER_TORCH_LOCK_WITNESS", "KARPENTER_TORCH_KNOB_WITNESS",
)
WITNESS_SWITCHES = {"KARPENTER_TORCH_LOCK_WITNESS", "KARPENTER_TORCH_KNOB_WITNESS"}
WITNESS_ENTRY = os.path.join(PORT_DIR, "witness.py")

# the upstream operator's deployment flags, read with the reference's names
# and defaults by ``Options.from_env`` and by no other file of the port
OPERATOR_ENV = (
    "SYSTEM_NAME", "SYSTEM_NAMESPACE", "METRICS_PORT", "HEALTH_PROBE_PORT", "KUBE_CLIENT_QPS",
    "KUBE_CLIENT_BURST", "ENABLE_PROFILING", "LEADER_ELECT", "LOG_LEVEL", "BATCH_MAX_DURATION",
    "BATCH_IDLE_DURATION", "FEATURE_GATES", "DISABLE_WEBHOOK", "USE_TPU_SOLVER", "TPU_CONSOLIDATION_SCREEN",
    "USE_SERVING_PIPELINE",
)
OPERATOR_ENV_FILE = os.path.join(PORT_DIR, "operator", "options.py")


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def _is_environ(node) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "environ"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_or_env_read(path):
    """No forbidden import; every knob-like literal or keyword is one of
    ``KNOBS``, environment reads name one by a literal (chip_smoke.py's
    knob setter reads back the keywords it was given); only
    chip_smoke.py writes the environment; the ``OPERATOR_ENV`` flags are
    named, and read, in ``operator/options.py`` only."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    docs = _docstrings(tree)
    script = os.path.basename(path) == "chip_smoke.py"
    options = path == OPERATOR_ENV_FILE
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _forbidden(node.module or ""), f"{path}:{node.lineno} imports {node.module}"
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            # a literal ending in "_" is a knob prefix (the analyzer's), not a knob
            if (node.value.startswith("KARPENTER_") and node.value.replace("_", "").isalnum()
                    and not node.value.endswith("_")):
                assert node.value in KNOBS, f"{path}:{node.lineno} names {node.value}"
            if node.value in OPERATOR_ENV:
                assert options, f"{path}:{node.lineno} names the operator flag {node.value}"
        elif isinstance(node, ast.keyword) and (node.arg or "").startswith("KARPENTER_"):
            assert node.arg in KNOBS, f"{path}:{node.lineno} sets {node.arg}"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "getenv":
                pytest.fail(f"{path}:{node.lineno} reads the environment through getenv")
            if _is_environ(node.func.value):
                if node.func.attr in ("pop", "setdefault", "update", "clear"):
                    assert script, f"{path}:{node.lineno} writes the environment"
                elif node.args and isinstance(node.args[0], ast.Constant):
                    key = node.args[0].value
                    assert key in KNOBS or (options and key in OPERATOR_ENV), f"{path}:{node.lineno} reads {key}"
                    assert key not in WITNESS_SWITCHES or path == WITNESS_ENTRY, f"{path}:{node.lineno} reads {key}"
                else:
                    assert script, f"{path}:{node.lineno} reads the environment by a variable"
        elif isinstance(node, ast.Subscript) and _is_environ(node.value):
            assert script, f"{path}:{node.lineno} indexes the environment"


def test_reference_knobs_are_constants():
    """Where the JAX package reads an environment knob on the provisioning
    stack, the port has a constant named for it, with its default."""
    from karpenter_core_tpu_torch.metrics import registry
    from karpenter_core_tpu_torch.provisioning import Provisioner
    from karpenter_core_tpu_torch.tracing import tracer

    assert Provisioner.PARITY_SAMPLE_EVERY == 16  # KARPENTER_TPU_PARITY_SAMPLE
    assert registry.LATENCY_BUCKETS_MS == ""  # KARPENTER_TPU_LATENCY_BUCKETS_MS
    assert tracer.TRACE is True  # KARPENTER_TPU_TRACE
    assert tracer.TRACE_BUFFER == 32  # KARPENTER_TPU_TRACE_BUFFER
    from karpenter_core_tpu_torch.serving import PipelineConfig, queues
    from karpenter_core_tpu_torch.solver import prewarm
    from karpenter_core_tpu_torch.tracing import flightrec

    assert queues.SOLVE_CAP == 1  # KARPENTER_TPU_SERVING_SOLVE_CAP
    assert queues.TELEMETRY_CAP == 1024  # KARPENTER_TPU_SERVING_TELEMETRY_CAP
    cfg = PipelineConfig()  # KARPENTER_TPU_SERVING_{IDLE_S,MAX_S,PREWARM,DISRUPT_EVERY,MAX_STALENESS_S}
    assert (cfg.idle_seconds, cfg.max_seconds, cfg.prewarm, cfg.disrupt_every, cfg.max_staleness_s) == (
        1.0, 10.0, True, 0, 0.0)
    assert cfg.warmstore_dir is None and cfg.warmstore_restore is None  # KARPENTER_TPU_WARMSTORE_{DIR,RESTORE}
    assert flightrec.SLO_TARGET_MS == 500.0  # KARPENTER_TPU_SLO_TARGET_MS
    assert flightrec.FLIGHTREC_KEEP == 256  # KARPENTER_TPU_FLIGHTREC_KEEP
    assert flightrec.SLO_BREACH_DUMP_MS is None  # KARPENTER_TPU_SLO_BREACH_DUMP_MS
    assert prewarm.PREWARM is True  # KARPENTER_TPU_PREWARM
    from karpenter_core_tpu_torch.kube import restclient

    assert restclient.WATCH_BACKOFF_BASE_MS == 200.0  # KARPENTER_TPU_WATCH_BACKOFF_BASE_MS
    assert restclient.WATCH_BACKOFF_MAX_MS == 5000.0  # KARPENTER_TPU_WATCH_BACKOFF_MAX_MS
    from karpenter_core_tpu_torch.fleet import megasolve, scheduler

    assert megasolve.FLEET_WORKERS == 4  # KARPENTER_TPU_FLEET_WORKERS
    assert megasolve.FLEET_JOIN_TIMEOUT_S == 300  # KARPENTER_TPU_FLEET_JOIN_TIMEOUT_S
    assert megasolve.FLEET_TENANT_LABELS == 64  # KARPENTER_TPU_FLEET_TENANT_LABELS
    assert scheduler.FLEET_QUANTUM == 1000  # KARPENTER_TPU_FLEET_QUANTUM
    assert scheduler.FLEET_WINDOW_MS == 2.0  # KARPENTER_TPU_FLEET_WINDOW_MS
    assert scheduler.FLEET_ADMIT_CAP == 10_000  # KARPENTER_TPU_FLEET_ADMIT_CAP


_SCRIPT = r"""
import importlib.abc, json, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "karpenter_core_tpu"):
            raise ImportError(f"boundary: {name} imported")
        return None

sys.meta_path.insert(0, Refuse())
try:
    import jax  # noqa: F401
    raise SystemExit("the hook did not refuse jax")
except ImportError:
    pass

from karpenter_core_tpu_torch.apis import labels as wk
from karpenter_core_tpu_torch.apis.nodepool import NodePool
from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_core_tpu_torch.kube.objects import (
    Affinity, Container, LabelSelector, NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, Pod,
    PodAffinityTerm, PodAntiAffinity, PodCondition, PodSpec, PreferredSchedulingTerm, ResourceRequirements, Toleration,
    WeightedPodAffinityTerm,
)
from karpenter_core_tpu_torch.kube.quantity import parse_quantity
from karpenter_core_tpu_torch.solver import TorchScheduler

provider = FakeCloudProvider()
provider.instance_types = instance_types(40)
pool = NodePool()
pool.metadata.name = "default"
pods = []
for i in range(90):
    p = Pod()
    p.metadata.name = f"p{i}"
    p.spec = PodSpec(containers=[Container(name="main", resources=ResourceRequirements(
        requests={"cpu": parse_quantity("500m"), "memory": parse_quantity("256Mi")}))])
    if i % 9 < 3:
        p.spec.node_selector = {wk.CAPACITY_TYPE_LABEL_KEY: ["spot", "on-demand"][i % 2]}
    elif i % 9 < 5:
        p.spec.tolerations = [Toleration(key="dedicated", operator="Exists")]
    if i < 6:  # a release with a soft one-per-node anti-affinity: the greedy fallback
        p.metadata.labels = {"app.kubernetes.io/name": "cache"}
        p.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(preferred=[WeightedPodAffinityTerm(
            1, PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME,
                               label_selector=LabelSelector(match_labels={"app.kubernetes.io/name": "cache"})))]))
    elif i < 9:  # a zone no offering has, preferred: relaxed and retried
        p.spec.affinity = Affinity(node_affinity=NodeAffinity(preferred=[PreferredSchedulingTerm(
            weight=100, preference=NodeSelectorTerm(match_expressions=[
                NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, "In", ["no-such-zone"])]))]))
    pods.append(p)
# a live cluster: one existing node with a bound pod, a daemonset, a limit
from karpenter_core_tpu_torch.kube.objects import Node, OwnerReference
from karpenter_core_tpu_torch.state import StateNode

pool.spec.limits = {"cpu": parse_quantity("400")}
node = Node()
node.metadata.name = "node-0"
node.metadata.labels = {wk.NODEPOOL_LABEL_KEY: "default", wk.LABEL_HOSTNAME: "node-0"}
node.status.capacity = {"cpu": parse_quantity("4"), "memory": parse_quantity("16Gi"), "pods": parse_quantity("50")}
node.status.allocatable = dict(node.status.capacity)
sn = StateNode(node=node)
bound = Pod()
bound.metadata.name = "bound"
bound.spec = PodSpec(node_name="node-0", containers=[Container(name="main", resources=ResourceRequirements(
    requests={"cpu": parse_quantity("1")}))])
sn.update_for_pod(bound)
ds = Pod()
ds.metadata.name = "ds"
ds.metadata.owner_references = [OwnerReference(kind="DaemonSet", name="ds")]
ds.spec = PodSpec(containers=[Container(name="main", resources=ResourceRequirements(
    requests={"cpu": parse_quantity("100m")}))])
solver = TorchScheduler([pool], provider, device="cpu")
res = solver.solve(pods, state_nodes=[sn], daemonset_pods=[ds])
assert res.existing_plans, "nothing landed on the existing node"
assert res.oracle_results is not None and solver.last_route_stats["oracle"] == 6
assert solver.last_relax_stats["rounds"] >= 1 and solver.last_relax_stats["pods_placed"] == 3
# the warm state: an unchanged tick replays; a snapshot restores into a
# fresh process's scheduler, whose first solve is warm
import copy, tempfile
from karpenter_core_tpu_torch.solver import warmstore

warm = TorchScheduler([pool], provider, device="cpu")
first = warm.solve(pods[9:])
again = warm.solve(pods[9:])
assert warm.last_cache_stats["hits"] == {"warmstart": 1}, warm.last_cache_stats
with tempfile.TemporaryDirectory() as d:
    path = warm.snapshot(directory=d)
    warmstore.simulate_process_death()
    restored = TorchScheduler([pool], provider, device="cpu")
    outcome = restored.restore(path)
assert outcome["restored"].get("job", 0) >= 1 and not outcome["dropped"], outcome
fresh = [copy.deepcopy(p) for p in pods[9:]]
for p in fresh:
    p.__dict__.pop("_karp_memo", None)
res3 = restored.solve(fresh)
assert restored.last_cache_stats["hits"].get("job", 0) >= 1 and len(res3.node_plans) == len(first.node_plans)
# the pack seam: auto (every job routed to the LP lane) on the device scans
import os
from karpenter_core_tpu_torch.solver import calibrate

os.environ.update(KARPENTER_TORCH_PACK_BACKEND="auto", KARPENTER_TORCH_NATIVE="0", KARPENTER_TORCH_LP_MIN_WORK="1")
res2 = solver.solve(pods, state_nodes=[sn], daemonset_pods=[ds])
assert solver.last_pack_stats["backend"] == "auto" and solver.last_pack_stats["ascent_iters"] > 0
assert res2.pods_scheduled + len(res2.pod_errors) == 90
assert calibrate.lp_calibration("cpu")["lp_min_job_work"] >= 1024
# the provisioner entry: the whole stack over a store, both paths
from karpenter_core_tpu_torch.events import Recorder
from karpenter_core_tpu_torch.kube.client import KubeClient
from karpenter_core_tpu_torch.metrics import Metrics
from karpenter_core_tpu_torch.provisioning import Provisioner
from karpenter_core_tpu_torch.state.cluster import Cluster
from karpenter_core_tpu_torch.state.informers import Informers
from karpenter_core_tpu_torch.tracing import tracer

os.environ.update(KARPENTER_TORCH_PACK_BACKEND="ffd", KARPENTER_TORCH_NATIVE="1")
for batched in (True, False):
    kube = KubeClient()
    cluster = Cluster(kube, provider)
    informers = Informers(kube, cluster)
    informers.start()
    recorder, metrics = Recorder(kube), Metrics()
    live_pool = NodePool()
    live_pool.metadata.name = "default"
    kube.create(live_pool)
    for i, p in enumerate(pods[:30]):
        q = Pod()
        q.metadata.name = f"q{i}"
        q.spec = p.spec
        q.status.phase = "Pending"
        q.status.conditions = [PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]
        kube.create(q)
    prov = Provisioner(kube, provider, cluster, recorder=recorder, use_tpu_solver=batched, metrics=metrics, device="cpu")
    names, reason = prov.reconcile()
    assert reason is None and names and len(kube.list("NodeClaim")) == len(names), (names, reason)
    assert "Nominated" in recorder.reasons()
    assert metrics.nodeclaims_created.get(reason="provisioning", nodepool="default") == len(names)
    assert tracer.RING.last().name == "provisioner.reconcile" and tracer.RING.last().contains_solve
    informers.stop()
# the disruption path: markers, the controller under both engines, the
# orchestration queue, simulations on the batched solver
from karpenter_core_tpu_torch.apis.nodeclaim import COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED, NodeClaim
from karpenter_core_tpu_torch.apis.nodepool import Budget
from karpenter_core_tpu_torch.disruption import DisruptionController, NodeClaimDisruptionController

provider.drifted = ""
for engine in ("batched", "sequential"):
    os.environ["KARPENTER_TORCH_DISRUPT_ENGINE"] = engine
    now = [10_000.0]
    clock = lambda: now[0]
    kube = KubeClient(clock=clock)
    cluster = Cluster(kube, provider, clock=clock)
    informers = Informers(kube, cluster)
    informers.start()
    recorder, metrics = Recorder(kube, clock=clock), Metrics()
    live_pool = NodePool()
    live_pool.metadata.name = "default"
    live_pool.spec.disruption.budgets = [Budget(nodes="100%")]
    live_pool.spec.disruption.consolidate_after = 0.0
    kube.create(live_pool)
    it = provider.get_instance_types(live_pool)[5]
    for i in range(6):
        nc = NodeClaim()
        nc.metadata.name = f"claim-{i}"
        nc.metadata.labels = {wk.NODEPOOL_LABEL_KEY: "default", wk.LABEL_INSTANCE_TYPE: it.name,
                              wk.LABEL_TOPOLOGY_ZONE: "test-zone-1", wk.CAPACITY_TYPE_LABEL_KEY: "on-demand"}
        nc.status.provider_id = f"fake:///node-{i}"
        nc.status.capacity, nc.status.allocatable = dict(it.capacity), it.allocatable()
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            nc.set_condition(cond, "True")
        kube.create(nc)
        n = Node()
        n.metadata.name = f"node-{i}"
        n.metadata.labels = {**nc.metadata.labels, wk.LABEL_HOSTNAME: n.metadata.name,
                             wk.NODE_REGISTERED_LABEL_KEY: "true", wk.NODE_INITIALIZED_LABEL_KEY: "true"}
        n.spec.provider_id = nc.status.provider_id
        n.status.capacity, n.status.allocatable = dict(it.capacity), it.allocatable()
        kube.create(n)
        q = Pod()
        q.metadata.name = f"r{i}"
        q.spec = PodSpec(node_name=n.metadata.name, containers=[Container(name="main", resources=ResourceRequirements(
            requests={"cpu": parse_quantity("100m")}))])
        q.status.phase = "Running"
        kube.create(q)
    now[0] += 3600.0
    prov = Provisioner(kube, provider, cluster, recorder=recorder, use_tpu_solver=True, metrics=metrics, device="cpu")
    ctrl = DisruptionController(kube, cluster, prov, provider, recorder=recorder, clock=clock,
                                validation_sleep=lambda t: None, metrics=metrics)
    NodeClaimDisruptionController(kube, provider, cluster, clock=clock).reconcile_all()
    assert ctrl.reconcile() == "consolidation", recorder.reasons()
    assert "Disruptconsolidation" in recorder.reasons() and ctrl.last_decision_stats["engine"] == engine
    assert sum(metrics.disruption_actions.values.values()) == 1
    ctrl.queue.reconcile()
    if metrics.disruption_actions.get(method="consolidation", action="delete"):
        assert len(kube.list("NodeClaim")) < 6  # the drained claims went
    else:
        assert len(kube.list("NodeClaim")) == 7 and ctrl.queue.commands  # waiting on the replacement
    informers.stop()
# the operator: every controller's pass over a store, admission on, the
# served surface on ephemeral ports
from karpenter_core_tpu_torch.metrics import check_exposition
from karpenter_core_tpu_torch.operator import Operator, Options

opts = Options(metrics_port=0, health_probe_port=0, enable_leader_election=False)
op = Operator(provider, options=opts, device="cpu")
op_pool = NodePool()
op_pool.metadata.name = "default"
op.kube_client.create(op_pool)
for p in pods[:12]:
    q = Pod()
    q.metadata.name = f"op-{p.name}"
    q.spec = p.spec
    q.status.phase = "Pending"
    q.status.conditions = [PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]
    op.kube_client.create(q)
op.start()
op.stop()
op.reconcile_all_once()
assert op.kube_client.list("NodeClaim") and check_exposition(op.metrics_text()) == []
op.stop()
# the fleet: one batched round of two tenants (one a content twin of the
# other) through the scheduler, the mega-dispatch coalescing their packs
from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry, FleetScheduler

os.environ["KARPENTER_TORCH_FLEET_ENGINE"] = "batched"
registry = FleetRegistry(device="cpu")
fleet = FleetEngine(registry)
sched = FleetScheduler(fleet)
for t in range(2):
    tenant_provider = FakeCloudProvider()
    tenant_provider.instance_types = instance_types(24)
    tenant_provider.bump_catalog_generation()
    tenant_pool = NodePool()
    tenant_pool.metadata.name = "default"
    registry.add_tenant(f"tenant-{t}", [tenant_pool], tenant_provider)
    sched.submit(f"tenant-{t}", [copy.deepcopy(p) for p in pods[20 + 20 * t:40 + 20 * t]])
outcomes = sched.run_round()
assert sorted(outcomes) == ["tenant-0", "tenant-1"] and all(o.error is None for o in outcomes.values())
assert fleet.last_round["dispatch"]["pack_calls"] >= 2 and fleet.last_round["engine"] == "batched"
assert registry.plane.debug_state()["canonical_catalogs"] == 1
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "karpenter_core_tpu"))
print(json.dumps({"scheduled": res.pods_scheduled, "errors": len(res.pod_errors), "nodes": res.node_count, "leaked": leaked}))
"""


def test_port_solve_under_import_hook():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert out["scheduled"] + out["errors"] == 90
    assert out["nodes"] >= 1


_CLI = r"""
import importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "karpenter_core_tpu"):
            raise ImportError(f"boundary: {name} imported")
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = ["trafficgen"] + sys.argv[1:]
try:
    runpy.run_module("karpenter_core_tpu_torch.serving.trafficgen", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "karpenter_core_tpu"))
print(leaked)
"""


def test_serving_cli_under_import_hook():
    """The serving CLI (harness, pipeline, flight recorder, stats, boot
    prewarm after a restore) in a fresh interpreter under the hook: a
    free pipeline run, then a kill and a warm resume, then a chaos run
    (fault schedule, leader gate, held tick)."""
    import tempfile

    base = [sys.executable, "-c", _CLI, "--device", "cpu", "--scale", "40", "--seed", "3"]
    with tempfile.TemporaryDirectory() as d:
        outs = []
        for extra in (
            ["--scenario", "churn10x", "--mode", "pipeline", "--drive", "free", "--pace", "0.01"],
            ["--scenario", "restart_wave", "--n-types", "24", "--restart-kill-at", "3", "--workdir", d],
            ["--scenario", "restart_wave", "--restart-resume", os.path.join(d, "handoff.pkl")],
            ["--scenario", "rollout", "--chaos", "failover", "--scale", "60"],
        ):
            proc = subprocess.run(base + extra, cwd=REPO, capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            lines = proc.stdout.strip().splitlines()
            assert lines[-1] == "[]", lines[-1]
            outs.append(json.loads(lines[-2]))
    free, kill, warm, chaos = outs
    assert free["pods_decided"] > 0 and free["orphan_spans"] == 0 and free["serving_log_faults"] == []
    assert kill["snapshot_path"] and warm["restored"] and warm["prewarm"]["status"] == "ok"
    assert chaos["fault"] == "failover" and chaos["device"] == "cpu" and chaos["serving_log_faults"] == []
    assert chaos["held_ticks"]["leader"] >= 1 and chaos["single_writer_ok"] and chaos["stale_plans_emitted"] == 0


def test_unported_features_raise():
    """No ``NotImplementedError`` of the port or of ``chip_smoke.py`` names
    the fleet (the CLI's ``--fleet`` runs); the operator is ported."""
    from karpenter_core_tpu_torch import operator

    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and node.exc is not None and "NotImplementedError" in ast.dump(node.exc):
                words = [n.value for n in ast.walk(node.exc) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
                assert not any("fleet" in w.lower() for w in words), f"{path}:{node.lineno} {words}"
    for name in ("Operator", "Options", "SingletonController"):
        assert isinstance(getattr(operator, name), type), name


def test_operator_env_read_by_literal_in_options_only():
    """``Options.from_env`` reads each of the 16 ``OPERATOR_ENV`` flags by
    its literal name, with the reference's defaults and parsing."""
    tree = ast.parse(open(OPERATOR_ENV_FILE, encoding="utf-8").read())
    read = [
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "get"
        and _is_environ(node.func.value) and node.args and isinstance(node.args[0], ast.Constant)
    ]
    assert sorted(read) == sorted(OPERATOR_ENV) and len(read) == 16
    assert not any(isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "get" and _is_environ(n.func.value)
                   and not (n.args and isinstance(n.args[0], ast.Constant)) for n in ast.walk(tree))


def test_operator_env_parses_as_the_reference(monkeypatch):
    import dataclasses

    from karpenter_core_tpu.operator.options import Options as RefOptions
    from karpenter_core_tpu_torch.operator.options import Options

    values = {"SYSTEM_NAME": "karp", "SYSTEM_NAMESPACE": "kube-system", "METRICS_PORT": "9000",
              "HEALTH_PROBE_PORT": "9001", "KUBE_CLIENT_QPS": "50", "KUBE_CLIENT_BURST": "70",
              "ENABLE_PROFILING": "true", "LEADER_ELECT": "0", "LOG_LEVEL": "debug", "BATCH_MAX_DURATION": "2.5",
              "BATCH_IDLE_DURATION": "0.5", "FEATURE_GATES": "Drift=false", "DISABLE_WEBHOOK": "yes",
              "USE_TPU_SOLVER": "false", "TPU_CONSOLIDATION_SCREEN": "1", "USE_SERVING_PIPELINE": "True"}
    assert sorted(values) == sorted(OPERATOR_ENV)
    for name in OPERATOR_ENV:
        monkeypatch.delenv(name, raising=False)
    assert dataclasses.asdict(Options.from_env()) == dataclasses.asdict(RefOptions.from_env())
    for name, value in values.items():
        monkeypatch.setenv(name, value)
    port, ref = dataclasses.asdict(Options.from_env()), dataclasses.asdict(RefOptions.from_env())
    assert port == ref and port != dataclasses.asdict(Options())



def test_knobs_are_the_analyzers_inventory():
    """One inventory: ``KNOBS`` is the port analyzer's static knob names,
    the witness switches among them, each read in ``witness.py`` only."""
    from karpenter_core_tpu_torch.analysis.configprov import repo_registry, static_knob_names

    names, patterns = static_knob_names()
    assert names == set(KNOBS) and not patterns
    registry = repo_registry()
    for switch in WITNESS_SWITCHES:
        assert {s.module for s in registry[switch]} == {"karpenter_core_tpu_torch/witness.py"}


# the modes that run the package on a device import it (and torch) inside
# their functions: the shape-contract pass, and the CLI's --witness and
# --contracts
ANALYSIS_DEVICE_MODES = {"shape_contracts.py": {"numpy", "torch"}, "__main__.py": set()}


def test_analysis_imports_the_standard_library_only():
    """``karpenter_core_tpu_torch/analysis/`` imports the standard library
    and its own modules: nothing of torch, jax, numpy or either package,
    but inside the functions of its device modes (the shape-contract pass,
    ``--witness``), which import the port's own modules and torch."""
    root = os.path.join(PORT_DIR, "analysis")
    files = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert {"engine.py", "concurrency.py", "cachesound.py", "configprov.py", "lockwitness.py",
            "knobwitness.py", "hostsync.py", "jitregistry.py", "tracersafety.py", "shape_contracts.py"} <= set(files)
    for fn in files:
        tree = ast.parse(open(os.path.join(root, fn), encoding="utf-8").read())
        lazy = {id(n) for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                for n in ast.walk(f)} if fn in ANALYSIS_DEVICE_MODES else set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 1 or (id(node) in lazy and node.level == 2), (
                    f"{fn}:{node.lineno} imports from outside analysis/")
                continue
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top in sys.stdlib_module_names or (id(node) in lazy and top in ANALYSIS_DEVICE_MODES[fn]), (
                    f"{fn}:{node.lineno} imports {m}")
